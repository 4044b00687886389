"""Roofline terms of the port's paths on one H100, counted on the meta
device: ``analysis`` (the card's constants, ``RooflineTerms``,
``count_params``, ``model_flops``), ``op_walk`` (flops, bytes and
collectives of one call) and ``report`` (the tables over every
(arch, shape) cell: ``python -m repro_torch.roofline.report``).
Counterpart of ``repro/roofline``."""
from .analysis import (HBM_BW, LINK_BW, PEAK_FLOPS, RooflineTerms,
                       collective_bytes, count_params, model_flops)
__all__ = ["RooflineTerms", "collective_bytes", "count_params", "model_flops",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]
