"""RIBBON in PyTorch for an NVIDIA H100: a port of the JAX package ``repro``.

Layout mirrors ``repro``: ``core`` (RIBBON's Bayesian optimisation),
``kernels`` (hand-written CUDA kernels, their wrappers and plain versions),
``models`` (the served models), ``serving`` (workloads and the live
engine).  The port imports ``torch`` and never JAX or ``repro``.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
