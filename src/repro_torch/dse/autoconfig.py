"""Pareto-guided launch auto-configuration; a copy of
``repro/dse/autoconfig.py`` whose :class:`LaunchConfig` resolves against
the port's :class:`~repro_torch.core.fabric.Fabric`.

The DSE sweep finds good deployments offline and commits them to
``BENCH_dse.json``; this module closes the loop at *launch time*: given a
dataset, an app and an objective, pick a :class:`~repro_torch.dse.space
.DesignPoint` from the tracked Pareto frontier — the paper's §V–§VI claim
that DCRA's pre-silicon / package-time / compile-time knobs are configured
*per deployment*, automated.

Selection pipeline:

1. **signature** the dataset — ``(n, nnz, degree skew)`` in log space;
2. **match** it against the frontier's benchmark datasets and
   **interpolate** each frontier point's per-cell metrics with
   inverse-distance weights (nearest-signature matching — a point that is
   great on the power-law Wikipedia graph and mediocre on uniform RMAT is
   scored mostly by the cell that resembles the user's graph);
3. **score** frontier points under the objective (``"teps"`` | ``"watts"``
   | ``"usd"`` | a weighted blend) and take the argmax;
4. **guard**: the winner must beat the all-defaults baseline on the user's
   actual dataset (one analytic evaluation each); if it does not — or if
   no frontier dataset is close — fall back to a quick on-the-fly
   **mini-sweep** over the frontier + a handful of baseline variants. The
   baseline is always a mini-sweep candidate, so the selected point is
   never worse than it under the chosen objective.

The resulting :class:`LaunchConfig` resolves everything the executables
need — deployment grid, pod/portal topology, and per-task IQ capacities as
:class:`~repro_torch.core.queues.QueueConfig` overrides (the single source of
queue truth). All seven ``dcra_*`` apps accept ``config="auto"`` (the
TaskProgram runtime resolves it), ranked on the app-specific Pareto
slice when the bench records one (schema v2 ``app_frontiers``); and
:func:`autoconfigure_moe` picks the MoE dispatch capacity factor from a
dispatch-load signature.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.queues import QueueConfig
from .space import DesignPoint

# All-defaults deployment: what the hand-written benchmarks launch with.
BASELINE = DesignPoint()

# Signature distance beyond which the frontier's datasets say nothing
# about this one (one unit ~ a 16x size mismatch on every axis).
MINISWEEP_THRESHOLD = 0.75

ObjectiveT = Union[str, Dict[str, float]]


def default_bench_path() -> str:
    """The committed trajectory at the repo root (env-overridable)."""
    env = os.environ.get("DCRA_BENCH_PATH")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "..", "..", "..", "BENCH_dse.json")


# ---------------------------------------------------------------------------
# dataset signatures
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DatasetSignature:
    """What the frontier is matched on: size, density, degree skew."""
    n: int
    nnz: int
    skew: float          # coefficient of variation of the degrees

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "DatasetSignature":
        return cls(n=int(d["n"]), nnz=int(d["nnz"]),
                   skew=float(d["skew"]))


def signature_of(g) -> DatasetSignature:
    if hasattr(g, "degrees"):
        deg = np.asarray(g.degrees(), np.float64)
        n, nnz = int(g.n), int(g.nnz)
    else:                                   # raw element stream (histogram)
        # bins are the owned items: signature in (bins, tasks) space, the
        # same shape the sweep's histogram cells have — n == nnz == len
        # would put every stream >= one full size-axis unit from every
        # recorded graph and make the frontier path unreachable
        els = np.atleast_1d(np.asarray(g))
        deg = (np.bincount(els - els.min()).astype(np.float64)
               if els.size else np.zeros(1))
        n = int(els.max() - els.min()) + 1 if els.size else 1
        nnz = int(els.size)
    mean = float(deg.mean()) if deg.size else 1.0
    skew = float(deg.std() / mean) if mean > 0 else 0.0
    return DatasetSignature(n=n, nnz=nnz, skew=skew)


_LOG16 = math.log(16.0)


def signature_distance(a: DatasetSignature, b: DatasetSignature) -> float:
    """0 = identical; 1 = a 16x mismatch on the worst size axis (or an
    e-fold skew mismatch) — the worst axis decides whether the frontier's
    measurements transfer."""
    dn = abs(math.log(max(a.n, 1) / max(b.n, 1))) / _LOG16
    de = abs(math.log(max(a.nnz, 1) / max(b.nnz, 1))) / _LOG16
    ds = abs(math.log((1.0 + a.skew) / (1.0 + b.skew)))
    return max(dn, de, ds)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def objective_weights(objective: ObjectiveT) -> Tuple[Tuple[str, float], ...]:
    """Normalise an objective to ((metric, weight), ...) over teps/watts/usd.

    Positive weights mean "improve this axis"; the score is a signed
    log-space sum, so ``"usd"`` is TEPS-per-dollar and a blend like
    ``{"teps": 0.5, "watts": 0.5}`` trades throughput against power.
    """
    if isinstance(objective, str):
        named = {"teps": {"teps": 1.0},
                 "watts": {"watts": 1.0},
                 "usd": {"teps": 1.0, "usd": 1.0}}
        if objective not in named:
            raise ValueError(f"unknown objective {objective!r} "
                             f"(expected teps|watts|usd or a weight dict)")
        objective = named[objective]
    bad = set(objective) - {"teps", "watts", "usd"}
    if bad or not objective:
        raise ValueError(f"objective keys must be teps|watts|usd, got {bad}")
    return tuple(sorted(objective.items()))


def objective_score(weights: Sequence[Tuple[str, float]], teps: float,
                    watts: float, usd: float) -> float:
    """Signed log-space score: higher is better under the objective."""
    sign = {"teps": 1.0, "watts": -1.0, "usd": -1.0}
    vals = {"teps": teps, "watts": watts, "usd": usd}
    return sum(w * sign[k] * math.log(max(vals[k], 1e-12))
               for k, w in weights)


# ---------------------------------------------------------------------------
# frontier loading + interpolation
# ---------------------------------------------------------------------------

def load_bench(path: Optional[str] = None) -> Optional[Dict]:
    path = path or default_bench_path()
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def bench_signatures(bench: Dict) -> Dict[str, DatasetSignature]:
    """Signatures of the sweep's datasets — from the bench file when the
    sweep recorded them, else recomputed from the (deterministic)
    generators at the recorded scale."""
    recorded = bench.get("dataset_signatures")
    if recorded:
        return {k: DatasetSignature.from_dict(v) for k, v in recorded.items()}
    from .evaluate import load_datasets
    data = load_datasets(int(bench.get("dataset_scale", 8)))
    return {k: signature_of(g) for k, g in data.items()
            if k in set(bench.get("datasets", data))}


def frontier_records(bench: Dict, app: Optional[str] = None) -> List[Dict]:
    """Frontier candidates for ``app``: the app-specific Pareto slice when
    the bench records one (schema v2 ``app_frontiers``), else the global
    (TEPS, watts, $/pkg) frontier — v1 files and un-swept apps fall back
    gracefully."""
    slice_ids = set(bench.get("app_frontiers", {}).get(app or "", ()))
    if slice_ids:
        return [r for r in bench.get("points", [])
                if r.get("point_id") in slice_ids and "metrics" in r]
    return [r for r in bench.get("points", [])
            if r.get("pareto") and "metrics" in r]


def _cell_metrics(rec: Dict, app: str, dname: str
                  ) -> Optional[Tuple[float, float]]:
    cell = rec.get("per_cell", {}).get(f"{app}:{dname}")
    if not cell:
        return None
    teps = float(cell["teps"])
    watts = float(cell["energy_j"]) / max(float(cell["seconds"]), 1e-12)
    return teps, watts


def interpolate_record(rec: Dict, app: str,
                       dist_by_dataset: Dict[str, float]
                       ) -> Tuple[float, float, float]:
    """(teps, watts, usd) of one frontier record for the user's dataset:
    inverse-distance-weighted geometric interpolation of the record's
    per-dataset cells for ``app`` (falls back to the record's geomeans
    when the app wasn't swept)."""
    lt, lw, ws = 0.0, 0.0, 0.0
    for dname, dist in dist_by_dataset.items():
        cell = _cell_metrics(rec, app, dname)
        if cell is None:
            continue
        w = 1.0 / (dist + 0.05)
        lt += w * math.log(max(cell[0], 1e-12))
        lw += w * math.log(max(cell[1], 1e-12))
        ws += w
    m = rec["metrics"]
    if ws == 0.0:
        teps, watts = m["teps_geomean"], m["watts_geomean"]
    else:
        teps, watts = math.exp(lt / ws), math.exp(lw / ws)
    return teps, watts, float(m["system_usd"])


# ---------------------------------------------------------------------------
# the resolved launch configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LaunchConfig:
    """A fully-resolved deployment for one (dataset, app, objective)."""
    point: DesignPoint
    source: str                                # frontier|mini-sweep|explicit
    objective: Tuple[Tuple[str, float], ...] = (("teps", 1.0),)
    signature: Optional[DatasetSignature] = None
    score: float = 0.0

    def engine_config(self):
        """Analytic deployment: grid shape, topology, bounded queues."""
        return self.point.engine_config()

    @property
    def queues(self) -> QueueConfig:
        """The point's tile-level queue sizing (single source of truth)."""
        return self.point.engine_config().queues

    def pod_axis_for(self, fabric) -> Optional[str]:
        """Hierarchical pod/portal routing when the point asks for it AND
        the fabric actually has a multi-pod axis to route over
        (:attr:`repro_torch.core.fabric.Fabric.pod_axis`)."""
        if self.point.topology != "hier_torus":
            return None
        return fabric.pod_axis

    def device_queues(self, n_dev: int, e_local: int, task: str = "T3",
                      pod: bool = False) -> QueueConfig:
        """Fold the tile-level IQ capacity onto ``n_dev`` executable shards.

        One shard emulates ``n_tiles / n_dev`` tiles, so a shard-level
        ingress channel aggregates that many tile channels on each side —
        capacity scales by the fold squared, clamped at ``e_local`` (a
        shard can never send more than its whole slice to one owner, so
        the clamp only trims allocation, never admission). The two-stage
        pod path sizes by factor instead (stage caps are relative); the
        analytic model still prices the point's tile-level drops.
        """
        if pod:
            return QueueConfig.from_factor(float(max(n_dev, 1)), task)
        fold = max(1, self.point.n_tiles // max(n_dev, 1))
        cap = min(self.point.iq_capacity * fold * fold, max(1, e_local))
        return QueueConfig.from_cap(max(1, cap), task)


def launch_for(point: DesignPoint, g=None,
               objective: ObjectiveT = "teps") -> LaunchConfig:
    """Wrap an explicitly-chosen point (no frontier selection)."""
    return LaunchConfig(point=point, source="explicit",
                        objective=objective_weights(objective),
                        signature=signature_of(g) if g is not None else None)


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------

def select_from_frontier(bench: Dict, sig: DatasetSignature, app: str,
                         weights: Sequence[Tuple[str, float]]
                         ) -> Optional[Tuple[DesignPoint, float, float]]:
    """Best frontier point under the interpolated objective, ranked on the
    app-specific Pareto slice when the bench carries one (v2
    ``app_frontiers``; the cross-app frontier otherwise).

    Returns (point, score, min_signature_distance) or None when the bench
    has no frontier. Deterministic: ties break on point_id.
    """
    records = frontier_records(bench, app)
    if not records:
        return None
    sigs = bench_signatures(bench)
    if not sigs:
        return None
    dists = {d: signature_distance(sig, s) for d, s in sigs.items()}
    scored = []
    for rec in records:
        teps, watts, usd = interpolate_record(rec, app, dists)
        score = objective_score(weights, teps, watts, usd)
        scored.append((-score, rec["point_id"], rec))
    scored.sort()
    _, _, best = scored[0]
    point = DesignPoint.from_dict(best["config"])
    return point, -scored[0][0], min(dists.values())


def _mini_candidates(frontier: Sequence[DesignPoint]) -> List[DesignPoint]:
    # baseline variants FIRST: the truncation below must never cut
    # BASELINE, or the never-below-baseline guarantee breaks on a large
    # frontier (the full-space sweep can carry 10+ Pareto points)
    cands = [
        BASELINE,
        BASELINE.with_(iq_capacity=48),
        BASELINE.with_(topology="torus"),
        BASELINE.with_(grid_side=16, die_side=16),
        BASELINE.with_(mem_tech="sram"),
    ] + list(frontier)
    seen, out = set(), []
    for p in cands:
        if p.point_id not in seen:
            seen.add(p.point_id)
            out.append(p)
    return out[:10]          # the mini-sweep stays mini


def _score_point(ev, point: DesignPoint,
                 weights: Sequence[Tuple[str, float]]) -> float:
    r = ev.evaluate_point(point)
    return objective_score(weights, r.teps, r.watts, r.system_usd)


def autoconfigure(g, app: str, objective: ObjectiveT = "teps",
                  bench: Optional[Dict] = None,
                  bench_path: Optional[str] = None,
                  threshold: float = MINISWEEP_THRESHOLD) -> LaunchConfig:
    """Resolve the launch configuration for (dataset, app, objective).

    Deterministic for a fixed ``BENCH_dse.json``; never selects a point
    that scores below :data:`BASELINE` under the objective on the user's
    dataset (so with ``objective="teps"`` the pick is TEPS-no-worse than
    the all-defaults deployment).
    """
    from .evaluate import Evaluator
    sig = signature_of(g)
    weights = objective_weights(objective)
    if bench is None:
        bench = load_bench(bench_path)
    ev = Evaluator({"user": g}, (app,))

    frontier_pts: List[DesignPoint] = []
    picked: Optional[Tuple[DesignPoint, float, float]] = None
    if bench is not None:
        frontier_pts = [DesignPoint.from_dict(r["config"])
                        for r in frontier_records(bench, app)]
        picked = select_from_frontier(bench, sig, app, weights)

    if picked is not None and picked[2] <= threshold:
        point, _, _ = picked
        score = _score_point(ev, point, weights)
        if score >= _score_point(ev, BASELINE, weights):
            return LaunchConfig(point=point, source="frontier",
                                objective=weights, signature=sig,
                                score=score)

    # no close frontier entry (or the pick lost to the baseline on the
    # real dataset): quick on-the-fly mini-sweep, baseline included
    best_point, best_score = BASELINE, -math.inf
    for cand in _mini_candidates(frontier_pts):
        s = _score_point(ev, cand, weights)
        if s > best_score + 1e-12 or (
                abs(s - best_score) <= 1e-12
                and cand.point_id < best_point.point_id):
            best_point, best_score = cand, s
    return LaunchConfig(point=best_point, source="mini-sweep",
                        objective=weights, signature=sig, score=best_score)


# ---------------------------------------------------------------------------
# MoE dispatch auto-configuration: pick moe_capacity_factor from a
# dispatch-load signature
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DispatchLoadSignature:
    """What the MoE capacity choice keys on: how skewed the router's
    expert assignment is for a representative token batch."""
    tokens: int
    num_experts: int
    peak_frac: float     # hottest expert's share of the assignments
    cv: float            # coefficient of variation of per-expert load

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def moe_dispatch_signature(expert_ids, num_experts: int
                           ) -> DispatchLoadSignature:
    """Signature a sample of router assignments (flattened top-k expert
    ids, e.g. ``eids.reshape(-1)`` from one batch)."""
    ids = np.atleast_1d(np.asarray(expert_ids)).reshape(-1)
    load = np.bincount(ids, minlength=num_experts).astype(np.float64)
    total = max(load.sum(), 1.0)
    mean = total / max(num_experts, 1)
    return DispatchLoadSignature(
        tokens=int(ids.size), num_experts=int(num_experts),
        peak_frac=float(load.max(initial=0.0) / total),
        cv=float(load.std() / mean) if mean > 0 else 0.0)


# the swept moe_capacity_factor ladder (ConfigSpace values + headroom)
MOE_FACTOR_LADDER = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0)


def autoconfigure_moe(expert_ids, num_experts: int, n_shards: int,
                      ladder: Sequence[float] = MOE_FACTOR_LADDER
                      ) -> Tuple[float, QueueConfig]:
    """Pick ``moe_capacity_factor`` from a dispatch-load signature.

    Simulates the stage-1 dispatch bucket on the sample — tokens sharded
    as contiguous blocks over ``n_shards`` sender shards and experts
    owned in contiguous blocks, both matching the ``moe_dcra`` layout
    (``P(batch, seq)`` keeps neighbouring tokens on one shard, so
    locally-correlated assignments concentrate on one sender's channel —
    a round-robin model would hide exactly that hotspot) — and returns
    the smallest ladder factor whose ``QueueConfig.for_moe_dispatch``
    channel capacity admits every (sender → owner) channel without
    overflow; if even the largest factor drops (pathological skew), the
    drop-minimising factor wins. Deterministic; the returned
    ``QueueConfig`` plugs straight into ``moe_dcra(..., queues=...)``.
    """
    ids = np.atleast_1d(np.asarray(expert_ids)).reshape(-1)
    if not ids.size:
        f = float(ladder[0])
        return f, QueueConfig.for_moe_dispatch(f)
    e_local = -(-num_experts // max(n_shards, 1))
    block = -(-ids.size // n_shards)
    sender = np.arange(ids.size) // block
    owner = np.minimum(ids // e_local, n_shards - 1)
    chan = np.bincount(sender * n_shards + owner,
                       minlength=n_shards * n_shards)
    t_local = -(-ids.size // n_shards)
    best_f, best_drops = float(ladder[-1]), None
    for f in ladder:
        cap = QueueConfig.for_moe_dispatch(float(f)).channel_cap(
            "dispatch", t_local, n_shards)
        drops = int(np.maximum(chan - cap, 0).sum())
        if best_drops is None or drops < best_drops:
            best_f, best_drops = float(f), drops
        if drops == 0:
            break
    return best_f, QueueConfig.for_moe_dispatch(best_f)
