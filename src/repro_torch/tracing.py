"""Spans and counters inside the port's layers, off by default.

A span names a stretch of a layer's work on the host::

    with tracing.span("moe.dispatch"):
        ...

Off, ``span`` returns one shared no-op context (a flag read, nothing
allocated, no torch call).  On, it returns
``torch.profiler.record_function("rt." + name)``: under a profiler the
span is a user annotation on the host's timeline, which Kineto aligns with
CUPTI's device timestamps, so the port's spans, a caller's own spans and
the kernels they launch share one clock, and nesting gives each span its
parent.  With no profiler running a span costs a record_function's enter
and exit.

A counter adds a number where the work is::

    tracing.count("moe.pairs_kept", keep.sum)

Off, ``count`` returns at once, before the value is computed (pass a
callable for anything that costs work).  On, it computes the value under
its own span, ``rt.count``, so the kernels a count launches are never
charged to a layer, and adds it into an accumulator in memory: a host
int stays on the host, a tensor on its device, with no sync.
``read_counters()`` syncs once, returns plain numbers and clears them.

Nothing is written to disk and nothing is read from the environment: a
caller turns tracing on with ``enable()`` and off with ``disable()``.

Spans (each inside ``rt.prefill`` in a prefill): ``rt.prefill`` (each
family's ``prefill`` in ``models/transformer.py``), ``rt.moe`` (the global
``layers.moe_layer``), ``rt.moe.dispatch``, ``rt.moe.experts``,
``rt.moe.combine``, ``rt.mamba`` (``ssm.ssm_forward``), ``rt.mamba.conv``
(the causal conv and its silu) and ``rt.mamba.gate`` (the D skip, the
silu(z) gate and the gated rmsnorm).  Counters: ``moe.pairs_routed`` (T·k
a call) and ``moe.pairs_kept`` (the pairs under the capacity), both in
``layers._moe_dispatch``.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

PREFIX = "rt."

Number = Union[int, torch.Tensor]

_on = False
_counters: dict[str, Number] = {}


class _Off:
    """The context every span returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def on() -> bool:
    return _on


def span(name: str):
    """A context that marks ``name`` (as ``rt.<name>``) while tracing is
    on, and does nothing while it is off."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, value: Number | Callable[[], Number]) -> None:
    """Add ``value`` (a host int, a 0-d tensor, or a callable giving one)
    to the counter ``name``, while tracing is on."""
    if not _on:
        return
    with torch.profiler.record_function(PREFIX + "count"):
        v = value() if callable(value) else value
        if isinstance(v, torch.Tensor):
            v = v.detach().reshape(()).to(torch.int64)
        _counters[name] = _counters.get(name, 0) + v


def read_counters() -> dict[str, int]:
    """Every counter as a plain int (one sync for the tensors), then none."""
    names = [n for n, v in _counters.items() if isinstance(v, torch.Tensor)]
    out = {n: int(v) for n, v in _counters.items() if n not in names}
    if names:
        host = torch.stack([_counters[n] for n in names]).cpu().tolist()
        out.update(zip(names, host))
    _counters.clear()
    return out
