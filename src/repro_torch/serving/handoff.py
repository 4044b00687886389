"""Build the port's control-plane objects from fields handed across.

Another implementation's ``PoolState``, ``RoutingPolicy`` or ``Telemetry``
(the reference's, in the parity tests) crosses as its dataclass fields:
numpy arrays, floats and a name.  ``from_fields`` copies them into the
port's own class of that name, through its constructor (so a policy is
validated again); nothing of the other implementation is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .routing import RoutingPolicy
from .simulator import PoolState
from .telemetry import Telemetry

KINDS = {"PoolState": PoolState, "RoutingPolicy": RoutingPolicy,
         "Telemetry": Telemetry}


def _copy(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, np.generic):
        return value.item()
    return value


def from_fields(kind: str, fields: dict):
    """The port's ``kind`` (a key of ``KINDS``) from a mapping of its
    dataclass fields, e.g. ``vars(obj)`` of another implementation's
    object of that name.  Extra keys are ignored; a missing one raises."""
    cls = KINDS[kind]
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"{kind} needs fields {missing}")
    return cls(**{n: _copy(fields[n]) for n in names})
