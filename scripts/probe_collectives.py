#!/usr/bin/env python
"""Which collectives a process group runs on a device, and which DTensor
redistributions work over it.

    python scripts/probe_collectives.py [--device cuda|cpu] [--ranks 4]

Spawns ``--ranks`` ranks (``launch.mesh.run_ranks``: on one card every
rank takes ``cuda:0`` over gloo; with a card a rank, NCCL) and on each
tries, on tensors on the rank's device: c10d's all_reduce, all_gather
(list), all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single,
broadcast; the functional collectives DTensor uses (all_gather_tensor,
reduce_scatter_tensor, all_reduce, all_to_all_single); and, on a (2, 2)
("data", "model") DeviceMesh, DTensor redistributions Shard → Replicate,
Partial → Replicate, Partial → Shard, Replicate → Shard and Shard(0) →
Shard(1), each checked against the values it must give.  Prints one line
a case, "ok" or the error's first line, and the card's name and power
limit.  A case that kills a rank (a segfault in the backend) is
reported as such, and the probe goes on with the cases after it in a new
spawn.  No gate: a probe.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.launch.mesh import (make_process_mesh, rank_device,  # noqa: E402
                                    run_ranks)


def _probe(rank: int, world: int, device: str, names: list, log: str,
           staged: bool) -> None:
    """Run the cases ``names`` on this rank, each one's start and result
    appended to the file ``log``-``rank`` as it goes."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    with open(f"{log}-{rank}", "a") as f:
        f.write("start mesh\n")
    if staged:
        mesh = make_process_mesh((2, world // 2), device=device)
        dev, dm = mesh.devices[rank], mesh.device_mesh
    else:
        # gloo itself: the same mesh without the host staging that
        # make_process_mesh installs on a card
        from torch.distributed.device_mesh import DeviceMesh
        dev = rank_device(world, rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dm = DeviceMesh(dev.type, torch.arange(world).reshape(2, world // 2),
                        mesh_dim_names=("data", "model"))
    with open(f"{log}-{rank}", "a") as f:
        f.write(f"done device, backend\t{dev}, {dist.get_backend()}\n")
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank

    def check(got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"got {got.tolist()}, want {want.tolist()}")

    full = sum(torch.arange(8, dtype=torch.float32) + r for r in range(world))

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        check(y, full)

    def all_gather():
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        check(torch.cat(ys), torch.cat([torch.arange(8.) + r
                                        for r in range(world)]))

    def all_gather_into_tensor():
        y = torch.empty(8 * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        check(y, torch.cat([torch.arange(8.) + r for r in range(world)]))

    def reduce_scatter_tensor():
        y = torch.empty(8 // world, device=dev)
        dist.reduce_scatter_tensor(y, x)
        check(y, full.chunk(world)[rank])

    def all_to_all_single():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        check(y, torch.cat([(torch.arange(8.) + r).chunk(world)[rank]
                            for r in range(world)]))

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        check(y, torch.arange(8.))

    group = dist.group.WORLD
    gathered = torch.cat([torch.arange(8.) + r for r in range(world)])
    cases = {
        "c10d all_reduce": all_reduce, "c10d all_gather": all_gather,
        "c10d all_gather_into_tensor": all_gather_into_tensor,
        "c10d reduce_scatter_tensor": reduce_scatter_tensor,
        "c10d all_to_all_single": all_to_all_single,
        "c10d broadcast": broadcast,
        "funcol all_reduce": lambda: check(funcol.wait_tensor(
            funcol.all_reduce(x, "sum", group)), full),
        "funcol all_gather_tensor": lambda: check(funcol.wait_tensor(
            funcol.all_gather_tensor(x, 0, group)), gathered),
        "funcol reduce_scatter_tensor": lambda: check(funcol.wait_tensor(
            funcol.reduce_scatter_tensor(x, "sum", 0, group)),
            full.chunk(world)[rank]),
        "funcol all_to_all_single": lambda: check(funcol.wait_tensor(
            funcol.all_to_all_single(x, None, None, group)),
            torch.cat([(torch.arange(8.) + r).chunk(world)[rank]
                       for r in range(world)])),
        "funcol all_gather_tensor bf16": lambda: check(funcol.wait_tensor(
            funcol.all_gather_tensor(x.to(torch.bfloat16), 0, group))
            .float(), gathered)}

    g = torch.Generator().manual_seed(0)
    a = torch.randn(8, 12, generator=g)

    def redistribute(src, dst):
        def run():
            if src[0] == Partial():
                # every rank holds a / 2 on the data axis: the sum is a
                t = DTensor.from_local((a / 2).to(dev), dm, src,
                                       run_check=False)
            else:
                t = distribute_tensor(a.to(dev), dm, src)
            check(t.redistribute(dm, dst).full_tensor(), a)
        return run

    for name, src, dst in (
            ("Shard(0) -> Replicate", [Shard(0), Shard(1)],
             [Replicate(), Replicate()]),
            ("Partial -> Replicate", [Partial(), Replicate()],
             [Replicate(), Replicate()]),
            ("Partial -> Shard", [Partial(), Replicate()],
             [Shard(0), Replicate()]),
            ("Replicate -> Shard", [Replicate(), Replicate()],
             [Shard(0), Shard(1)]),
            ("Shard(0) -> Shard(1)", [Shard(0), Replicate()],
             [Shard(1), Replicate()])):
        cases[f"DTensor {name}"] = redistribute(src, dst)
    b = torch.randn(12, 6, generator=g)

    def matmul():
        ta = distribute_tensor(a.to(dev), dm, [Shard(0), Shard(1)])
        tb = distribute_tensor(b.to(dev), dm, [Replicate(), Shard(0)])
        got = (ta @ tb).full_tensor()
        if not torch.allclose(got.cpu(), a @ b, rtol=1e-5, atol=1e-5):
            raise AssertionError("matmul differs")
    cases["DTensor matmul"] = matmul
    for name in names:
        with open(f"{log}-{rank}", "a") as f:
            f.write(f"start {name}\n")
        try:
            cases[name]()
            got = "ok"
        except Exception as e:  # noqa: BLE001  (a probe reports every failure)
            got = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        with open(f"{log}-{rank}", "a") as f:
            f.write(f"done {name}\t{got}\n")
    if staged:
        from repro_torch.launch import host_collectives
        with open(f"{log}-{rank}", "a") as f:
            f.write(f"done staged calls\t{dict(host_collectives.STAGED)}\n")


CASES = ["c10d all_reduce", "c10d all_gather", "c10d all_gather_into_tensor",
         "c10d reduce_scatter_tensor", "c10d all_to_all_single",
         "c10d broadcast", "funcol all_reduce", "funcol all_gather_tensor",
         "funcol reduce_scatter_tensor", "funcol all_to_all_single",
         "DTensor Shard(0) -> Replicate", "DTensor Partial -> Replicate",
         "DTensor Partial -> Shard", "DTensor Replicate -> Shard",
         "DTensor Shard(0) -> Shard(1)", "DTensor matmul",
         "funcol all_gather_tensor bf16"]


def _cases(staged: bool, ranks: int, device: str) -> None:
    """Run every case, in a new spawn after a case that kills a rank;
    print each case's result as rank 0 (and any rank that differs) saw
    it."""
    todo = list(CASES)
    with tempfile.TemporaryDirectory() as tmp:
        while todo:
            log = f"{tmp}/log{len(todo)}"
            died = None
            try:
                run_ranks(_probe, ranks, device, todo, log, staged,
                          device=device, timeout=120)
            except Exception as e:  # noqa: BLE001
                died = f"{type(e).__name__}: {str(e).splitlines()[0]}"
            lines = [open(f"{log}-{r}").read().splitlines()
                     for r in range(ranks)]
            results = {}
            for r, rank_lines in enumerate(lines):
                for line in rank_lines:
                    if line.startswith("done "):
                        case, got = line[5:].split("\t", 1)
                        results.setdefault(case, set()).add(got)
            for case, got in results.items():
                print(f"[collective] {'staged' if staged else 'gloo'} "
                      f"{case}: {' | '.join(sorted(got))}", flush=True)
            if died is None:
                return
            # the furthest case any rank started: no rank passes the
            # collective of the case that killed one
            last = [ls[-1][6:] for ls in lines if ls[-1].startswith("start")]
            crashed = max(last, key=lambda c: -1 if c == "mesh"
                          else CASES.index(c)) if last else "mesh"
            print(f"[collective] {'staged' if staged else 'gloo'} {crashed}: "
                  f"a rank died ({died})", flush=True)
            if crashed == "mesh":
                return
            todo = todo[todo.index(crashed) + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"[probe] {smi}; torch {torch.__version__}", flush=True)
    _cases(False, args.ranks, args.device)
    if args.device == "cuda":
        _cases(True, args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
