"""n-dimensional Pareto frontier extraction (paper §V: the sweep's output
is not one winner but the (TEPS, watts, $/package) frontier per app).

Conventions: an *objective spec* is a sequence of (key, direction) pairs,
direction ``"max"`` or ``"min"``. Records may be dicts or objects —
``key`` is looked up with ``record[key]`` / ``getattr``. Ties: a point is
dominated only by a point strictly better in ≥ 1 objective and no worse in
all others; duplicate metric vectors therefore all survive.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np

ObjectiveSpec = Sequence[Tuple[str, str]]

DEFAULT_OBJECTIVES: ObjectiveSpec = (
    ("teps", "max"), ("watts", "min"), ("package_usd", "min"))


def _get(rec: Any, key: str):
    if isinstance(rec, dict):
        return rec[key]
    return getattr(rec, key)


def _signed_matrix(records: Sequence[Any],
                   objectives: ObjectiveSpec) -> np.ndarray:
    """[n, k] matrix with every objective flipped to maximise."""
    cols = []
    for key, direction in objectives:
        if direction not in ("max", "min"):
            raise ValueError(f"direction must be max|min, got {direction!r}")
        sign = 1.0 if direction == "max" else -1.0
        cols.append(sign * np.asarray([float(_get(r, key))
                                       for r in records]))
    return np.stack(cols, axis=1)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff maximise-vector ``a`` Pareto-dominates ``b``."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return bool(np.all(a >= b) and np.any(a > b))


def pareto_indices(values: np.ndarray) -> np.ndarray:
    """Indices of the non-dominated rows of a maximise-matrix [n, k]."""
    v = np.asarray(values, float)
    n = v.shape[0]
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        ge = np.all(v >= v[i], axis=1)
        gt = np.any(v > v[i], axis=1)
        if np.any(ge & gt):
            keep[i] = False
    return np.flatnonzero(keep)


def pareto_frontier(records: Sequence[Any],
                    objectives: ObjectiveSpec = DEFAULT_OBJECTIVES
                    ) -> List[int]:
    """Indices of the Pareto-optimal records under ``objectives``."""
    if not len(records):
        return []
    return pareto_indices(_signed_matrix(records, objectives)).tolist()
