"""Plain PyTorch references, one module a kind of architecture, named by a
configuration's ``"reference"`` key.  They import torch and this folder
only: nothing of the port, nothing of JAX."""

from __future__ import annotations

import importlib


def load(kind: str):
    """The reference module ``reference/<kind>.py``."""
    return importlib.import_module(f"{__name__}.{kind}")
