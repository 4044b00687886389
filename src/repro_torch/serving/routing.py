"""Routing policies as data: the dispatch rule of the FCFS scan.

Counterpart of ``repro/serving/routing.py``.  A :class:`RoutingPolicy` is
three parameters read by the routed flavour of the ``fcfs_scan`` kernel.
Per query, with ``idle`` the slots free at the arrival instant and
``svc[s]`` the query's service time on slot ``s``'s instance type:

* **idle selection** — among idle slots, minimize
  ``fma(affinity, svc[s], type_pref[type(s)]) * _TIE + priority[s]``:
  ``type_pref`` (n_types,) is a preference rank per instance type (lower =
  preferred), ``affinity`` >= 0 weights the query's own service time on
  that type, and ``priority[s]`` (the slot index) breaks exact ties in
  pool type order;
* **busy fallback (hedged re-dispatch)** — when no slot is idle, minimize
  ``fma(hedge, svc[s], free[s])`` with ``hedge`` in [0, 1]: 0 picks the
  earliest-freeing slot, 1 the predicted earliest completion.

Both sums are rounded once, as a fused multiply-add, because that is how
XLA computes the reference's ``pref + affinity * svc`` and
``free + hedge * svc`` on the CPU (ROADMAP C-R18).  The identity policy
(all ranks 0, ``affinity = 0``, ``hedge = 0``) picks the same slot as
``policy=None`` at every step, bit for bit.

:meth:`RoutingPolicy.stack` builds a stacked policy whose fields carry a
leading policy axis; the simulator folds that axis into the lane axis, so
B pools x P policies score in one dispatch.  The reference registers the
class as a jax pytree; here it is a plain frozen dataclass.  Validation
and its messages are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RoutingPolicy:
    """Dispatch-rule parameters of the FCFS scan (see module docstring).

    ``type_pref`` is (n_types,) float — per-type idle preference rank
    (lower = preferred); ``affinity`` and ``hedge`` are scalars.  A
    *stacked* policy (from :meth:`stack`) carries a leading policy axis on
    every leaf: ``type_pref`` (P, n_types), ``affinity``/``hedge`` (P,).
    """

    type_pref: np.ndarray
    affinity: float | np.ndarray = 0.0
    hedge: float | np.ndarray = 0.0
    name: str = "policy"

    # -------------------------------------------------------- validation
    def __post_init__(self):
        pref = np.asarray(self.type_pref, dtype=np.float64)
        if pref.ndim not in (1, 2) or pref.shape[-1] == 0:
            raise ValueError("type_pref must be (n_types,) or stacked "
                             f"(P, n_types), got shape {pref.shape}")
        if not np.isfinite(pref).all():
            raise ValueError("type_pref ranks must be finite")
        aff = np.asarray(self.affinity, dtype=np.float64)
        if not np.isfinite(aff).all() or (aff < 0).any():
            raise ValueError(f"affinity must be finite and >= 0, got "
                             f"{self.affinity}")
        hed = np.asarray(self.hedge, dtype=np.float64)
        if not np.isfinite(hed).all() or (hed < 0).any() or (hed > 1).any():
            raise ValueError("hedge is the busy-slot re-dispatch fraction, "
                             f"must be in [0, 1], got {self.hedge}")
        expect = () if pref.ndim == 1 else (pref.shape[0],)
        for label, arr in (("affinity", aff), ("hedge", hed)):
            if arr.shape != expect:
                raise ValueError(
                    f"{label} shape {arr.shape} does not match the policy "
                    f"axis of type_pref {pref.shape} (want {expect})")
        object.__setattr__(self, "type_pref", pref)
        object.__setattr__(self, "affinity",
                           aff if pref.ndim == 2 else float(aff))
        object.__setattr__(self, "hedge",
                           hed if pref.ndim == 2 else float(hed))

    # --------------------------------------------------------- structure
    @property
    def stacked(self) -> bool:
        """True when the leaves carry a leading policy axis."""
        return np.asarray(self.type_pref).ndim == 2

    @property
    def n_policies(self) -> int:
        return len(np.asarray(self.type_pref)) if self.stacked else 1

    @property
    def n_types(self) -> int:
        return np.asarray(self.type_pref).shape[-1]

    def key(self) -> tuple:
        """Hashable identity for memo keys (PoolEvaluator caches)."""
        pref = np.asarray(self.type_pref, dtype=np.float64)
        return (tuple(np.ravel(pref).tolist()), pref.shape,
                tuple(np.ravel(np.asarray(self.affinity)).tolist()),
                tuple(np.ravel(np.asarray(self.hedge)).tolist()))

    def row(self, p: int) -> "RoutingPolicy":
        """Policy ``p`` of a stacked policy (identity when unstacked)."""
        if not self.stacked:
            return self
        return RoutingPolicy(type_pref=np.asarray(self.type_pref)[p],
                             affinity=float(np.asarray(self.affinity)[p]),
                             hedge=float(np.asarray(self.hedge)[p]),
                             name=f"{self.name}[{p}]")

    def check_pool(self, n_types: int) -> "RoutingPolicy":
        """Raise unless the policy's type table matches the pool."""
        if self.n_types != n_types:
            raise ValueError(
                f"policy {self.name!r} routes over {self.n_types} instance "
                f"types but the pool has {n_types}")
        return self

    # ------------------------------------------------------ constructors
    @classmethod
    def fcfs(cls, n_types: int) -> "RoutingPolicy":
        """The identity policy: bit-identical to ``policy=None`` FCFS."""
        if n_types < 1:
            raise ValueError(f"n_types must be >= 1, got {n_types}")
        return cls(type_pref=np.zeros(n_types), name="fcfs")

    @classmethod
    def from_order(cls, order, *, affinity: float = 0.0, hedge: float = 0.0,
                   name: str = "ordered") -> "RoutingPolicy":
        """Idle preference from an explicit type order (first = preferred).

        ``order`` must be a permutation of ``range(n_types)``; an
        out-of-range or repeated type index is a caller bug and raises
        (mirrors the ``fail_instances`` validation contract).
        """
        idx = np.asarray(order, dtype=np.int64)
        n = len(idx)
        if n == 0:
            raise ValueError("order must name at least one type")
        if ((idx < 0) | (idx >= n)).any():
            raise ValueError(
                f"order references type indices outside [0, {n}): "
                f"{sorted(set(int(i) for i in idx if not 0 <= i < n))}")
        if len(set(idx.tolist())) != n:
            raise ValueError(f"order must be a permutation without repeats, "
                             f"got {idx.tolist()}")
        pref = np.empty(n, dtype=np.float64)
        pref[idx] = np.arange(n, dtype=np.float64)
        return cls(type_pref=pref, affinity=affinity, hedge=hedge, name=name)

    @classmethod
    def cost_aware(cls, prices, *, hedge: float = 0.0) -> "RoutingPolicy":
        """Prefer idle capacity on the cheapest instance types (Tandemn-style
        latency+cost routing, the cost half)."""
        p = np.asarray(prices, dtype=np.float64)
        if p.ndim != 1 or p.size == 0 or not np.isfinite(p).all():
            raise ValueError("prices must be a non-empty finite 1-D vector")
        return cls.from_order(np.argsort(p, kind="stable"), hedge=hedge,
                              name="cost_aware")

    @classmethod
    def affine(cls, n_types: int, affinity: float = 1.0,
               hedge: float = 0.0) -> "RoutingPolicy":
        """Size/type-affinity routing: steer each query to the type that
        serves *it* fastest (per-query service-time weighting)."""
        if n_types < 1:
            raise ValueError(f"n_types must be >= 1, got {n_types}")
        return cls(type_pref=np.zeros(n_types), affinity=affinity,
                   hedge=hedge, name="affinity")

    @classmethod
    def hedged(cls, n_types: int, hedge: float = 1.0) -> "RoutingPolicy":
        """Earliest-predicted-completion re-dispatch for queued queries."""
        if n_types < 1:
            raise ValueError(f"n_types must be >= 1, got {n_types}")
        return cls(type_pref=np.zeros(n_types), hedge=hedge, name="hedged")

    @classmethod
    def stack(cls, policies) -> "RoutingPolicy":
        """One stacked policy from a sequence — the policy batch axis."""
        pols = list(policies)
        if not pols:
            raise ValueError("stack needs at least one policy")
        n = pols[0].n_types
        for p in pols:
            if p.stacked:
                raise ValueError("stack takes unstacked policies")
            p.check_pool(n)
        return cls(type_pref=np.stack([np.asarray(p.type_pref)
                                       for p in pols]),
                   affinity=np.asarray([float(p.affinity) for p in pols]),
                   hedge=np.asarray([float(p.hedge) for p in pols]),
                   name="+".join(p.name for p in pols))


# Named constructors, referenced by name as pure data: each maps the types'
# prices to a concrete policy.
NAMED_POLICIES = ("fcfs", "cost_aware", "affinity", "hedged")


def named_policy(name: str, prices) -> RoutingPolicy:
    """Resolve a named routing policy (one of ``NAMED_POLICIES``) over a
    pool whose types cost ``prices``."""
    prices = np.asarray(prices, dtype=np.float64)
    n = len(prices)
    if name == "fcfs":
        return RoutingPolicy.fcfs(n)
    if name == "cost_aware":
        return RoutingPolicy.cost_aware(prices)
    if name == "affinity":
        return RoutingPolicy.affine(n)
    if name == "hedged":
        return RoutingPolicy.hedged(n)
    raise ValueError(f"unknown routing policy {name!r}; known: "
                     f"{NAMED_POLICIES}")
