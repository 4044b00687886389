"""Architecture registry: --arch <id> resolution + shape-cell definitions."""

from __future__ import annotations

from .base import ArchConfig
from .internvl2_1b import CONFIG as internvl2_1b
from .mamba2_130m import CONFIG as mamba2_130m
from .minicpm3_4b import CONFIG as minicpm3_4b
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .olmoe_1b_7b import CONFIG as olmoe_1b_7b
from .qwen2_5_3b import CONFIG as qwen2_5_3b
from .qwen2_7b import CONFIG as qwen2_7b
from .stablelm_3b import CONFIG as stablelm_3b
from .whisper_tiny import CONFIG as whisper_tiny
from .zamba2_2_7b import CONFIG as zamba2_2_7b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in [
        olmoe_1b_7b, mixtral_8x22b, qwen2_5_3b, minicpm3_4b, stablelm_3b,
        qwen2_7b, internvl2_1b, whisper_tiny, mamba2_130m, zamba2_2_7b,
    ]
}

# (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k":    (4096,   256, "train"),
    "prefill_32k": (32768,  32,  "prefill"),
    "decode_32k":  (32768,  128, "decode"),
    "long_500k":   (524288, 1,   "decode"),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def cell_is_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """long_500k requires sub-quadratic attention (DESIGN.md §4)."""
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, "full quadratic attention: long_500k skipped (DESIGN.md)"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            cells.append((arch, shape))
    return cells
