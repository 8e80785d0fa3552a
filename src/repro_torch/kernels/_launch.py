"""The launch plan that the gmm, flash-attention and BSR wrappers share.

Each wrapper's ``launch_plan`` computes a :class:`LaunchPlan` in Python
from shapes and types alone; the wrapper hands it to its C entry point
(:func:`as_c`), whose launcher computes the geometry it launches by
itself and refuses (``cudaErrorInvalidValue``) a plan that differs in
any field, so the plan the CPU tests check is the launch the card runs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch


class LaunchPlan(NamedTuple):
    """How a wrapper launches its kernel: the design (``path``), a block's
    tile (rows first), the grid, the threads a block, the stages of its
    shared-memory ring and the shared memory a block takes (dynamic, or
    the kernel's static arrays)."""
    path: str
    tiles: tuple
    grid: tuple
    threads: int
    stages: int
    smem_bytes: int


def aligned(*ts: torch.Tensor) -> bool:
    """Every base address 16-byte aligned, as TMA and 16-byte loads need."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def as_c(plan: LaunchPlan, path_code: int) -> ctypes.Array:
    """The plan as the C entry points read it (``sm90::LaunchPlan``):
    eight int32, the design's code, a block's rows, the grid, the threads,
    the stages and the shared-memory bytes."""
    return (ctypes.c_int32 * 8)(path_code, plan.tiles[0], *plan.grid,
                                plan.threads, plan.stages, plan.smem_bytes)
