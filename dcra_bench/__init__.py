"""The card benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 dcra_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once: it makes the
cell's inputs from the seed, sets up and warms the port, measures for
``--seconds`` seconds, checks what the window produced against a plain
reference, and prints one JSON line (see :mod:`dcra_bench.harness`).

Everything a cell needs is found by name from ``BENCHMARK.json``:

* ``configs/<config>.json`` — a deployment's sizes and the driver that
  runs it (``drivers/<driver>.py``);
* ``traffic/<traffic>.json`` — the mix the general driver reads; a graph
  mix names its app (``apps/<app>.py``);
* ``metrics/<metric>.py`` — one reader a per-layer metric, which returns
  ``None`` where it finds nothing to read.

``gen/`` makes the inputs, ``reference/`` holds the plain references
(float32/float64 PyTorch, nothing of the port), ``trace.py`` reduces the
profiler's trace. Nothing here imports JAX or the JAX package.
"""
