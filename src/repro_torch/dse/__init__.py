"""Design-space exploration engine (paper §V–§VI); counterpart of
``repro/dse``, numpy like it, with the executables of the revalidation
and of ``config="auto"`` on the port's runtime.

The paper's central claim is a *framework*: sweep pre-silicon (die grid,
NoC width/frequency), package-time (dies + memory tech per package) and
compile-time (topology, deployment grid, queue sizing) configurations,
evaluate each point through the analytic stack (task engine → perf →
energy → silicon cost), and pick Pareto-optimal deployments per
application. This package composes the ingredients the rest of the repo
already has into that loop:

* :mod:`repro_torch.dse.space`     — declarative ``ConfigSpace`` / ``DesignPoint``
  over the three configuration axes;
* :mod:`repro_torch.dse.evaluate`  — ``Evaluator``: analytic evaluation of a point
  for the seven apps × bundled datasets (stats cached across points that
  share the simulation-relevant sub-key, the paper's decoupled re-pricing);
* :mod:`repro_torch.dse.pareto`    — n-dimensional Pareto frontier extraction;
* :mod:`repro_torch.dse.driver`    — generic resumable sweep driver;
* :mod:`repro_torch.dse.shardcheck`— re-validates analytic message/drop
  counts on the port's executables, on virtual shards of one device;
* :mod:`repro_torch.dse.sweep`     — ``python -m repro_torch.dse.sweep`` CLI emitting
  the tracked ``BENCH_dse.json`` perf trajectory;
* :mod:`repro_torch.dse.autoconfig`— Pareto-guided *launch-time* selection: the
  ``dcra_*`` apps' ``config="auto"`` picks a frontier point for the
  dataset at hand (signature matching + interpolation, mini-sweep
  fallback);
* :mod:`repro_torch.dse.compare`   — ``python -m repro_torch.dse.compare`` trajectory
  regression gate between successive ``BENCH_dse.json`` artifacts;
* :mod:`repro_torch.dse.route_compare` — ``python -m
  repro_torch.dse.route_compare``: the same gate for ``BENCH_route.json``
  (within-run speedups over the onehot route and of pipelined rounds);
* :mod:`repro_torch.dse.serve_compare` — ``python -m
  repro_torch.dse.serve_compare``: the same gate for ``BENCH_serve.json``
  (the overlapped drain's speedup over the synchronous one).
"""
from .autoconfig import (BASELINE, DatasetSignature,            # noqa: F401
                         DispatchLoadSignature, LaunchConfig,
                         autoconfigure, autoconfigure_moe, launch_for,
                         moe_dispatch_signature, signature_of)
from .evaluate import (APPS, ConfigResult, Evaluator, PointResult,  # noqa: F401
                       config_cost, evaluate, geomean, load_datasets,
                       run_app)
from .pareto import dominates, pareto_frontier, pareto_indices  # noqa: F401
from .space import MEM_TECHS, ConfigSpace, DesignPoint          # noqa: F401
