"""Optimizers of the port (counterpart of ``repro/optim``)."""

from . import adamw

__all__ = ["adamw"]
