"""Architecture configs: one module per assigned architecture + registry.

The port's own copy of ``repro/configs`` (plain dataclasses, no JAX), so
the port never imports the reference package.
"""

from .base import ArchConfig
from .registry import ARCHS, SHAPES, all_cells, cell_is_applicable, get_arch

__all__ = ["ArchConfig", "ARCHS", "SHAPES", "get_arch", "all_cells",
           "cell_is_applicable"]
