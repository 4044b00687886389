"""The pick rule of the ``fcfs_scan`` kernel, modelled in numpy on the CPU.

``csrc/fcfs_scan.cu`` picks a query's slot with warp votes and one
reduction: thread l holds slots s = k * 32 + l; the idle slots' ballots
m_k (the routed pick's "any slot idle", the telemetry's idle count); each
slot's key as an order-preserving unsigned image (-0 mapped to +0; a busy
cold slot's image, when the arrival is >= 0, its next-free time's bits with
the top bit set); one min-reduction over the warp; per-k equality ballots,
and the lowest set bit of the first nonzero one.  The model below does the
same arithmetic on numpy arrays, and hypothesis holds it to the
lexicographic argmin of the keys that the plain version
(``ref.fcfs_scan_ref``) builds, and to that version's own pick, for the
cold and the routed keys, at every slot count the kernel's K takes, with
ties across k, keys of -0 and +0, and padding at +inf.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from repro_torch.kernels import fcfs_scan as tfcfs  # noqa: E402
from repro_torch.kernels.ref import fcfs_scan_ref, fma32  # noqa: E402

SLOT_COUNTS = (1, 8, 31, 32, 33, 40, 130, 1024)
N_TYPES = 3
F32 = np.float32
# Values drawn for next-free times, arrivals and the routed terms: few and
# repeated, so that keys tie, with both zeros, negatives and 1e30 (the
# simulator's absent slot; as a routed term it lifts an idle key above the
# 1e30 of the excluded busy slots, which the reference then picks).
TIMES = np.array([-0.0, 0.0, -1.5, 0.25, 0.5, 1.0, 2.0, 1e30, np.inf], F32)
ARRIVALS = np.array([-2.0, -0.0, 0.0, 0.5, 1.0, 3.0, -999990.0], F32)
TERMS = np.array([-0.0, 0.0, -1.0, 0.5, 2.0, 1e30], F32)
SERVICE = np.array([0.001, 0.002, 0.5], F32)


def order_bits(x) -> np.ndarray:
    """The kernel's ``order_bits``: x < y iff image(x) < image(y) as
    unsigned integers, -0 and +0 one image."""
    u = (np.asarray(x, F32) + F32(0.0)).view(np.uint32)
    sign = (u.view(np.int32) >> 31).view(np.uint32)
    return u ^ (sign | np.uint32(0x80000000))


def ballots(pred: np.ndarray) -> list[int]:
    """(K, 32) per-slot predicates → the K votes, bit l from thread l."""
    weights = 1 << np.arange(32, dtype=np.uint64)
    return [int((row.astype(np.uint64) * weights).sum()) for row in pred]


def first_set(votes: list[int]) -> int | None:
    """Slot of the lowest set bit of the first nonzero vote."""
    for k, m in enumerate(votes):
        if m:
            return k * 32 + (m & -m).bit_length() - 1
    return None


def kernel_pick(free, a, priority, svc, policy=None) -> int:
    """The kernel's pick of one query over S slots: ``free``, ``priority``
    and ``svc`` (each slot's service time for the query) (S,) float32,
    ``a`` the arrival, ``policy`` None or (pref (S,), affinity, hedge)."""
    n_s = len(free)
    k_slots = 1 << max(0, int(np.ceil(n_s / 32)) - 1).bit_length()
    pad = 32 * k_slots - n_s

    def padded(x, fill):
        return np.concatenate([np.asarray(x, F32), np.full(pad, fill, F32)])

    fr = padded(free, np.inf)
    live = np.arange(32 * k_slots) < n_s
    idle = fr <= a
    m = ballots(idle.reshape(k_slots, 32))
    any_idle = first_set(m) is not None
    kid = (np.asarray(priority, F32) - F32(tfcfs.BIG)).astype(F32)
    if policy is None:
        # a >= 0: a busy key (> a) is positive, its bits with the top bit
        # set its image
        busy = (fr.view(np.uint32) | np.uint32(0x80000000) if a >= 0
                else order_bits(fr))
        u = np.where(idle, order_bits(padded(kid, np.inf)), busy)
    else:
        pref, aff, hed = policy
        sv = torch.from_numpy(padded(svc, SERVICE[0]))
        if any_idle:
            ikey = (fma32(torch.tensor(aff), sv,
                          torch.from_numpy(padded(pref, 0.0))) * tfcfs.TIE
                    + torch.from_numpy(padded(priority, 0.0)))
            u = np.where(idle, order_bits(ikey.numpy()),
                         np.where(live, order_bits(F32(tfcfs.INF)),
                                  np.uint32(0xFFFFFFFF)))
        else:
            bkey = fma32(torch.tensor(hed), sv, torch.from_numpy(fr))
            u = order_bits(bkey.numpy())
    lo = u.min()                              # the one reduction
    return first_set(ballots((u == lo).reshape(k_slots, 32)))


def reference_pick(free, a, priority, types, service, policy=None):
    """The lexicographic argmin of the keys ``fcfs_scan_ref`` builds, and
    that version's own pick (its dispatch trace) of one query."""
    n_s = len(free)
    svc = service[types]
    idle = free <= a
    if policy is None:
        key = np.where(idle, (priority - F32(tfcfs.BIG)).astype(F32), free)
        want = int(np.argmin(key))
        pol = None
    else:
        pref, aff, hed = policy
        t = {n: torch.from_numpy(np.asarray(x, F32)) for n, x in
             (("pref", pref), ("svc", svc), ("prio", priority),
              ("free", free))}
        ikey = torch.where(torch.from_numpy(idle),
                           fma32(torch.tensor(aff), t["svc"], t["pref"])
                           * tfcfs.TIE + t["prio"], tfcfs.INF)
        bkey = torch.where(torch.from_numpy(idle), tfcfs.INF,
                           fma32(torch.tensor(hed), t["svc"], t["free"]))
        want = int(np.argmin((ikey if idle.any() else bkey).numpy()))
        pol = (t["pref"][None], torch.tensor([aff], dtype=torch.float32),
               torch.tensor([hed], dtype=torch.float32))
    r = fcfs_scan_ref(torch.tensor([[a]], dtype=torch.float32),
                      torch.from_numpy(service.reshape(1, -1, 1)),
                      torch.from_numpy(types.astype(np.int32)[None]),
                      torch.from_numpy(priority),
                      torch.from_numpy(free[None]), 0.02, tfcfs.BIG,
                      policy=pol, want_slot=True)
    assert int(r[4][0, 0, 0]) == want
    assert n_s == len(types)
    return want


def _case(seed: int):
    """One query's operands from ``seed``: slot count, next-free times
    (ties copied across k), arrival, priority (ascending, permuted, signed
    zeros, or collapsing after the shift by BIG), slot types and service,
    routed terms."""
    rng = np.random.default_rng(seed)
    n_s = int(rng.choice(SLOT_COUNTS))
    mode = rng.integers(4)
    if mode == 0:     # drawn from a few values: ties everywhere
        free = rng.choice(TIMES, n_s)
    elif mode == 1:   # spread values, then ties across k
        free = rng.uniform(-1.0, 3.0, n_s).astype(F32)
    elif mode == 2:   # every slot idle, or exactly one in the last k
        free = np.full(n_s, 5.0, F32)
        free[rng.integers(max(0, n_s - 32), n_s)] = 0.0
        if rng.integers(2):
            free[:] = 0.0
    else:             # every slot busy (the copies below tie across k)
        free = rng.uniform(4.0, 9.0, n_s).astype(F32)
    for s in range(n_s - 32):
        if rng.uniform() < 0.2:
            free[s + 32] = free[s]
    free = free.astype(F32)
    a = F32(rng.choice(ARRIVALS) if rng.integers(3) else rng.uniform(-1, 3))
    prio_mode = rng.integers(4)
    priority = np.arange(n_s, dtype=F32)
    if prio_mode == 1:
        priority = rng.permutation(priority)
    elif prio_mode == 2:
        priority = np.where(rng.integers(0, 2, n_s) > 0, F32(-0.0),
                            F32(0.0))
    elif prio_mode == 3:
        priority = (priority * F32(0.01)).astype(F32)
    types = rng.integers(0, N_TYPES, n_s)
    service = rng.choice(SERVICE, N_TYPES).astype(F32)
    policy = (rng.choice(TERMS, n_s).astype(F32), F32(rng.choice(TERMS)),
              F32(rng.choice(TERMS)))
    return free, a, priority.astype(F32), types, service, policy


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_cold_pick_is_the_first_minimum(seed):
    free, a, priority, types, service, _ = _case(seed)
    want = reference_pick(free, a, priority, types, service)
    assert kernel_pick(free, a, priority, service[types]) == want


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 32 - 1))
def test_routed_pick_is_the_first_minimum(seed):
    free, a, priority, types, service, policy = _case(seed)
    want = reference_pick(free, a, priority, types, service, policy)
    assert kernel_pick(free, a, priority, service[types], policy) == want


@pytest.mark.parametrize("n_s", SLOT_COUNTS)
def test_pick_at_every_slot_count(n_s):
    """The branches at each K: every slot idle (slot 0), one idle slot in
    the last k, every slot busy with the minimum on slots 7 and 37 (a pick
    by lowest thread would take 37), and an arrival below the last idle key
    with busy keys under an idle one (the reduction must pick slot 0)."""
    prio = np.arange(n_s, dtype=F32)
    svc = np.full(n_s, 0.001, F32)
    types = np.zeros(n_s, np.int64)
    service = np.full(N_TYPES, 0.001, F32)
    cases = [(np.zeros(n_s, F32), F32(1.0), 0)]
    last = n_s - 1
    one = np.full(n_s, 5.0, F32)
    one[last] = 0.0
    cases.append((one, F32(1.0), last))
    if n_s > 37:
        busy = np.full(n_s, 5.0, F32)
        busy[[7, 37]] = 2.0
        cases.append((busy, F32(1.0), 7))
    low = np.full(n_s, -999994.0, F32)   # busy, keyed below slot 10's idle key
    low[min(10, last)] = -999995.0
    cases.append((low, F32(-999995.0), 0))
    for free, a, slot in cases:
        assert reference_pick(free, a, prio, types, service) == slot
        assert kernel_pick(free, a, prio, svc) == slot


@pytest.mark.parametrize("n_s", SLOT_COUNTS)
def test_signed_zero_ties_take_the_first_slot(n_s):
    """Keys of +0 on slot 0 and -0 on the last slot tie under IEEE <, so
    the first index wins: busy cold keys (a negative arrival), and routed
    idle keys (affinity -0, preference and priority +0 or -0)."""
    last = n_s - 1
    free = np.full(n_s, 5.0, F32)
    free[0], free[last] = 0.0, -0.0
    service = np.full(N_TYPES, 0.001, F32)
    types = np.zeros(n_s, np.int64)
    prio = np.arange(n_s, dtype=F32)
    assert reference_pick(free, F32(-1.0), prio, types, service) == 0
    assert kernel_pick(free, F32(-1.0), prio, service[types]) == 0
    pref = np.full(n_s, 2.0, F32)
    pref[0], pref[last] = 0.0, -0.0
    prio = np.zeros(n_s, F32)
    prio[last] = -0.0
    policy = (pref, F32(-0.0), F32(0.5))
    idle = np.zeros(n_s, F32)
    assert reference_pick(idle, F32(1.0), prio, types, service, policy) == 0
    assert kernel_pick(idle, F32(1.0), prio, service[types], policy) == 0


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
def test_busy_image_of_a_positive_time_is_its_bits(bits):
    """The cold pick's one-instruction image of a busy slot (bits | 2^31)
    is the general order image for every positive float32 and +inf."""
    x = np.array([bits], np.uint32).view(F32)
    if np.isnan(x[0]) or x[0] == 0:
        return
    assert (x.view(np.uint32) | np.uint32(0x80000000)) == order_bits(x)
