"""Threefry-2x32 counter-based random numbers, as ``jax.random`` draws them.

The reference draws its query streams with ``jax.random`` (threefry2x32,
with jax's default ``jax_threefry_partitionable`` setting: a draw of shape
``shape`` hashes the counters ``(hi, lo)`` of a flattened uint64 iota).
This module computes the same keys and bits in PyTorch, so that one seed
gives the reference's stream:

* ``PRNGKey``, ``split``, ``fold_in`` and ``random_bits`` are integer
  arithmetic and equal ``jax.random``'s bit for bit;
* ``uniform`` is the mantissa trick on those bits (23 random bits under an
  exponent of 1, minus 1), scaled to its bounds, also bit for bit;
* ``exponential`` (``-log1p(-u)``) and ``normal`` (``sqrt(2)·erfinv(u)``
  on ``(-1, 1)``) transform bit-exact uniforms in float64 and round once to
  float32.  XLA evaluates these transforms in float32 with its own
  polynomials, so a value may differ from ``jax.random``'s by a few ulp
  (``tests/test_torch_prng.py`` states the measured gap).

Keys are int64 tensors of shape ``(2,)`` holding two uint32 words; every
uint32 operation is done in int64 and masked to 32 bits.  Everything here
runs on the CPU: it produces input data on the host, as the reference's
``realize`` hands host arrays to the simulator.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _MASK


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``: ``jax._src.prng._threefry2x32_lowering``."""
    k1, k2 = _u32(k1), _u32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(_u32(x1) + ks[0]) & _MASK, (_u32(x2) + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the high and low 32-bit words of the
    seed (jax builds keys from a 32-bit seed outside x64 mode, whose high
    word is 0)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def _counters(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of ``arange(n)`` as uint64 (``iota_2x32_shape``)."""
    iota = torch.arange(n, dtype=torch.int64)
    return iota >> 32, iota & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    hi, lo = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    ``(0, data mod 2^32)``."""
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros(1, dtype=torch.int64),
                          _u32([int(data) & _MASK]))
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2^32): the XOR of the two hash words of each counter."""
    shape = tuple(shape)
    hi, lo = _counters(math.prod(shape))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def _unit(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 in [0, 1): 23 random mantissa bits under exponent 0."""
    bits = ((random_bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``, bit for
    bit: ``max(minval, u · (maxval - minval) + minval)`` with the float32
    bounds, the product (exact) and the sum in float64, then rounded to
    float32, which gives XLA's fused multiply-add."""
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    fused = _unit(key, shape).double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def exponential(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.exponential(key, shape, float32)``: ``-log1p(-u)`` of a
    bit-exact uniform, in float64, rounded once to float32."""
    u = uniform(key, shape).double()
    return (-torch.log1p(-u)).float()


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2)·erfinv(u)`` of a
    bit-exact uniform on (-1, 1), in float64, rounded once to float32."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0).double()
    return (math.sqrt(2.0) * torch.erfinv(u)).float()
