"""Serving driver: ``python -m repro_torch.launch.serve --model mtwnd``.

The paper's loop on the live execution plane: build heterogeneous serving
cells of one of the paper's five models (``--model`` candle, resnet50,
vgg19, mtwnd or dien) at full width on the card, let RIBBON's BO find the
cheapest QoS-meeting cell mix against real measured latencies, and
(``recover``) re-optimize after losing cells, as the end of
``examples/serve_cluster.py`` does.  Counterpart of
``repro/launch/serve.py``, with the same defaults: 60 queries at 40 qps,
QoS within 200 ms against a target of 0.9, bounds (4, 3, 2), budget 12.
"""

from __future__ import annotations

import argparse

from ..core import RibbonOptimizer, SearchSpace
from ..models.paper_models import PAPER_MODELS
from ..serving.engine import DEFAULT_CELLS, ClusterEngine
from ..serving.fault import recover_from_failure
from ..serving.workload import Workload, WorkloadSpec


def _workload(n_queries: int, rate_qps: float, seed: int) -> Workload:
    """The driver's request stream: Poisson arrivals, batches of median 8
    up to 32."""
    return WorkloadSpec(seed=seed, rate_qps=rate_qps, median_batch=8,
                        max_batch=32).realize(n_queries)


def _evaluator(engine: ClusterEngine, workload: Workload,
               qos_latency: float):
    def evaluate(config):
        engine.configure(config)
        return engine.serve(workload, qos_latency=qos_latency)
    return evaluate


def serve(model: str = "mtwnd", n_queries: int = 60, rate_qps: float = 40.0,
          qos_latency: float = 0.2, qos_target: float = 0.9,
          bounds=(4, 3, 2), budget: int = 12, seed: int = 0,
          verbose: bool = True, device=None):
    """RIBBON over a live pool of ``DEFAULT_CELLS`` (full width) on
    ``device`` (default ``cuda``; the BO's GP runs there too).  Returns
    (optimizer, engine)."""
    cells = DEFAULT_CELLS
    engine = ClusterEngine(model, cells, seed=seed, device=device)
    if verbose:
        print("[serve] warming up the cells ...")
    engine.warmup()
    evaluate = _evaluator(engine, _workload(n_queries, rate_qps, seed),
                          qos_latency)
    space = SearchSpace(bounds=bounds, prices=tuple(c.price for c in cells))
    opt = RibbonOptimizer(space, qos_target=qos_target, device=engine.device)
    for i in range(budget):
        cfg = opt.ask()
        if cfg is None or opt.done:
            if cfg is None and opt.trace.best_feasible() is None and verbose:
                print("[serve] search space infeasible under this QoS target")
            break
        rate = evaluate(cfg)
        opt.tell(cfg, rate)
        if verbose:
            print(f"[serve] sample {i + 1}: config {cfg} rate {rate:.3f} "
                  f"price ${engine.pool_price(cfg):.2f}/h")
    best = opt.trace.best_feasible()
    if best is not None and verbose:
        print(f"[serve] optimal pool {best.config} at "
              f"${best.cost:.2f}/h (QoS rate {best.qos_rate:.3f})")
    return opt, engine


def recover(opt: RibbonOptimizer, engine: ClusterEngine,
            n_queries: int = 60, rate_qps: float = 40.0,
            qos_latency: float = 0.2, seed: int = 0, budget: int = 10):
    """The failure path of ``examples/serve_cluster.py`` over the live
    engine: lose enough cells of the incumbent's most-deployed type that
    the incumbent no longer fits (its count plus one, below the type's
    bound), then ``recover_from_failure`` re-optimizes over the surviving
    capacity with up to ``budget`` new measured samples.  The stream is
    ``serve``'s for the same arguments.  Returns (new optimizer, event,
    lost type, cells lost)."""
    best = opt.trace.best_feasible()
    if best is None:
        raise ValueError("no incumbent to recover from: the search found "
                         "no feasible pool")
    lost_type = max(range(len(best.config)), key=lambda i: best.config[i])
    lost = opt.space.bounds[lost_type] - best.config[lost_type] + 1
    evaluate = _evaluator(engine, _workload(n_queries, rate_qps, seed),
                          qos_latency)
    new_opt, event = recover_from_failure(opt, evaluate,
                                          failed_type=lost_type, lost=lost,
                                          budget=budget)
    return new_opt, event, lost_type, lost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="mtwnd", choices=list(PAPER_MODELS))
    ap.add_argument("--queries", type=int, default=60)
    ap.add_argument("--rate", type=float, default=40.0)
    ap.add_argument("--qos-ms", type=float, default=200.0)
    ap.add_argument("--budget", type=int, default=12)
    args = ap.parse_args()
    serve(model=args.model, n_queries=args.queries, rate_qps=args.rate,
          qos_latency=args.qos_ms / 1e3, budget=args.budget)


if __name__ == "__main__":
    main()
