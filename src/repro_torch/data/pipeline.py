"""Token data pipeline: a deterministic synthetic stream and a memmap file
source, with background prefetch.

The port's own copy of ``repro/data/pipeline.py`` (numpy only, no JAX), so
one seed gives the reference's batches bit for bit.  Synthetic mode
fabricates a stationary Markov-ish token stream from the seed (enough
structure for loss curves to move); file mode memory-maps a flat
uint16/uint32 token file and serves shuffled fixed-length windows.  A small
double-buffered prefetch thread hides host-side batch assembly behind
device compute.  Batches are numpy int32; the train loop copies them to
the device (``launch.train``).
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        # sparse bigram structure so the model has something to learn
        self._next = self.rng.integers(0, vocab_size, size=vocab_size)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        """(batch_size, seq_len + 1) int32: tokens and, shifted by one,
        their labels."""
        start = self.rng.integers(0, self.vocab, size=(batch_size, 1))
        out = np.empty((batch_size, seq_len + 1), dtype=np.int32)
        out[:, 0] = start[:, 0]
        noise = self.rng.random((batch_size, seq_len)) < 0.15
        rand = self.rng.integers(0, self.vocab, size=(batch_size, seq_len))
        for t in range(seq_len):
            nxt = self._next[out[:, t]]
            out[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return out


class MemmapTokens:
    """Flat binary token file → shuffled fixed windows."""

    def __init__(self, path, vocab_size: int, dtype=np.uint16, seed: int = 0):
        self.tokens = np.memmap(Path(path), dtype=dtype, mode="r")
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)

    def batch(self, batch_size: int, seq_len: int) -> np.ndarray:
        starts = self.rng.integers(0, len(self.tokens) - seq_len - 1,
                                   size=batch_size)
        return np.stack([
            np.asarray(self.tokens[s:s + seq_len + 1], dtype=np.int32)
            for s in starts])


class Prefetcher:
    """Double-buffered background batch producer: ``next()`` returns
    {"tokens": (B, S), "labels": (B, S)} int32, labels the tokens shifted
    by one.  ``close()`` stops the thread."""

    def __init__(self, source, batch_size: int, seq_len: int, depth: int = 2):
        self.source = source
        self.batch_size = batch_size
        self.seq_len = seq_len
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            chunk = self.source.batch(self.batch_size, self.seq_len)
            batch = {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
