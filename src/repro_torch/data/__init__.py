"""Token data pipeline of the port (counterpart of ``repro/data``):
synthetic and memmap token sources with background prefetch, numpy only."""

from .pipeline import MemmapTokens, Prefetcher, SyntheticTokens

__all__ = ["SyntheticTokens", "MemmapTokens", "Prefetcher"]
