"""The reference's per-device parameter and AdamW-state bytes at the
production meshes, for ``tests/test_torch_production_mesh.py``: with 512
forced host devices, rank 0's ``shard_shape`` of every leaf under
``repro.launch.sharding.param_shardings``, summed, for every architecture
at (16, 16) and (2, 16, 16).  The two lines below must precede any jax
import (jax fixes the device count when it starts).

    PYTHONPATH=src python tests/ref_rank_bytes.py

prints one JSON object: {"single" | "multi": {arch: {"params": B,
"adamw": B}}}.
"""

import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402

from repro.configs import ARCHS  # noqa: E402
from repro.launch import sharding as shp  # noqa: E402
from repro.launch import specs  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.transformer import get_model  # noqa: E402


def _rank_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shards = jax.tree.leaves(shardings)
    return sum(math.prod(s.shard_shape(x.shape)) * x.dtype.itemsize
               for x, s in zip(leaves, shards, strict=True))


def main() -> None:
    out = {}
    for kind, multi in (("single", False), ("multi", True)):
        mesh = make_production_mesh(multi_pod=multi)
        out[kind] = {}
        for arch, cfg in ARCHS.items():
            p = specs.param_specs(get_model(cfg))
            opt = specs.opt_specs(p)
            out[kind][arch] = {
                "params": _rank_bytes(p, shp.param_shardings(p, cfg, mesh)),
                "adamw": _rank_bytes(opt, shp.param_shardings(opt, cfg,
                                                              mesh))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
