"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one card.

One run measures one cell of ``BENCHMARK.json`` (a model configuration under
a traffic mix) for ``--seconds`` and prints one JSON line:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``workloads/<cell>.json``
and ``metrics/<metric>.py``.  The yardstick lives here too: the traffic
generator (``traffic.py``), the weights made from the seed
(``weights.py``), the plain PyTorch reference and the comparison that
decides ``correct`` (``reference/``, ``check.py``), the counts of work and
the card's peaks (``work.py``) and the reading of the profiler's trace
(``trace.py``).  Nothing here imports JAX or the JAX package, and the
reference imports nothing of the port.
"""
