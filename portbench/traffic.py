"""The one traffic generator: a mix's parameters in, a closed loop of requests out.

A traffic mix is a data file, ``traffic/<mix>.json``:

    {"batch": 4,                      # prompts in a request, all of one length
     "prompt": {"distribution": "log_uniform" | "uniform" | "fixed",
                "min": 1024, "max": 4096, "round": 256},
     "gen_len": 1,                    # tokens generated a prompt (1: prefill only)
     "cycle": 32,                     # requests in one cycle of lengths
     "prefill_first_in_setup": false} # the first request's prefill is set-up

A request is a batch of ``batch`` prompts of one length, prefilled in one
call and then decoded greedily for ``gen_len - 1`` steps.  The loop is
closed: the next request is issued when the last one's tokens are on the
host.  Lengths are the ``cycle`` quantiles of the distribution, each rounded
to the nearest multiple of ``round``: every seed gets the same set of
lengths, and the seed only orders them, a new order each cycle.  The
order is stratified: the k-th request of a cycle takes the sorted lengths'
place bit_reverse(k) XOR a mask under ``MASKS`` drawn from the seed for
that cycle, so any 2^j requests aligned in a cycle hold one length from
each 2^j-th of the sorted lengths, and the seed only swaps neighbours in
the sorted cycle: a window's last, partial cycle does nearly the same work
whatever the seed (the first n requests of two seeds differ by less than
the longest prompt less the shortest, at any n).  Every request's prompts are new tokens, drawn from
the seed and the request's index (``harness.request_prompts``).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MASKS = 4               # the seed's choices of a cycle's order


@dataclass(frozen=True)
class Request:
    index: int          # the request's place in the run: 0, 1, ...
    batch: int
    prompt_len: int
    gen_len: int


@dataclass(frozen=True)
class Traffic:
    name: str
    batch: int
    distribution: str
    len_min: int
    len_max: int
    len_round: int
    gen_len: int
    cycle: int
    prefill_first_in_setup: bool

    @classmethod
    def load(cls, name: str, root: Path = HERE) -> "Traffic":
        d = json.loads((root / "traffic" / f"{name}.json").read_text())
        p = d["prompt"]
        t = cls(name=name, batch=int(d["batch"]),
                distribution=p["distribution"], len_min=int(p["min"]),
                len_max=int(p["max"]), len_round=int(p.get("round", 1)),
                gen_len=int(d["gen_len"]), cycle=int(d["cycle"]),
                prefill_first_in_setup=bool(d.get("prefill_first_in_setup",
                                                  False)))
        t.validate()
        return t

    def validate(self) -> None:
        if self.distribution not in ("log_uniform", "uniform", "fixed"):
            raise ValueError(f"{self.name}: unknown distribution "
                             f"{self.distribution!r}")
        if not (0 < self.len_min <= self.len_max) or self.len_round < 1:
            raise ValueError(f"{self.name}: bad prompt lengths")
        if self.batch < 1 or self.gen_len < 1 or self.cycle < 1:
            raise ValueError(f"{self.name}: batch, gen_len and cycle >= 1")
        if self.cycle & (self.cycle - 1):
            raise ValueError(f"{self.name}: cycle must be a power of two")

    def lengths(self) -> list[int]:
        """The cycle's prompt lengths, ascending."""
        out = []
        for i in range(self.cycle):
            u = (i + 0.5) / self.cycle
            if self.distribution == "fixed":
                x = self.len_min
            elif self.distribution == "uniform":
                x = self.len_min + u * (self.len_max - self.len_min)
            else:
                x = self.len_min * (self.len_max / self.len_min) ** u
            r = self.len_round
            x = int(math.floor(x / r + 0.5)) * r
            out.append(min(max(x, self.len_min), self.len_max))
        return out

    def shapes(self) -> list[int]:
        """The distinct prompt lengths, each a shape to warm up."""
        return sorted(set(self.lengths()))

    def max_len(self, prompt_len: int) -> int:
        """Positions a request of this prompt length needs in its cache."""
        return prompt_len + self.gen_len

    def order(self, mask: int) -> list[int]:
        """One cycle's places in the sorted lengths: bit_reverse(k) ^ mask
        for its k-th request."""
        bits = self.cycle.bit_length() - 1
        return [(int(format(k, f"0{bits}b")[::-1], 2) if bits else 0) ^ mask
                for k in range(self.cycle)]

    def requests(self, seed: int):
        """The run's requests, endless, in the order the seed gives."""
        rng = np.random.default_rng(seed)
        lengths = self.lengths()
        index = 0
        while True:
            mask = int(rng.integers(min(MASKS, self.cycle)))
            for place in self.order(mask):
                yield Request(index, self.batch, lengths[place], self.gen_len)
                index += 1
