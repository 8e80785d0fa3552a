"""The grouped (expert) matmul kernel and its plain version (counterpart
of ``repro/kernels/moe_gmm.py``, ``gmm_pallas``).

``out[t] = x[t] @ w[group_ids[t // rt]]``, accumulated in float32 and
returned in x's type. The layout is the MoE dispatch's output:
expert-bucketed, capacity-padded rows, so each row tile of ``rt`` rows
belongs to one expert.

On a CUDA tensor :func:`gmm` launches a hand-written kernel of
``csrc/gmm.cu``, chosen by :func:`launch_plan` from the type and the
shape, and adds one to ``LAUNCHES["gmm"]`` and to its design's entry of
``PATHS``; on a CPU tensor it runs :func:`plain_gmm`. Any other device
raises.
"""
from __future__ import annotations

import torch

from ._launch import LaunchPlan, aligned as _aligned, as_c
from .route import _check, _on_cuda, _raise_on, _stream, gamma

ROW_TILE = 128
F_TILE = 128
DTYPES = (torch.float32, torch.bfloat16)
#: block row tiles of the simt kernel; the largest dividing rt is taken
KERNEL_ROWS = (64, 32, 16, 8)
WGMMA_STAGES = 4
#: the designs of ``csrc/gmm.cu``, as the C entry point numbers them
PATH_CODES = {"simt": 0, "blocked": 1, "wgmma": 2}

#: kernel launches since the last reset, in all and by design (chip_smoke
#: reads these)
LAUNCHES = {"gmm": 0}
PATHS = {path: 0 for path in PATH_CODES}


def reset_launches() -> None:
    LAUNCHES["gmm"] = 0
    for path in PATHS:
        PATHS[path] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tiles(x, w, group_ids, rt, ft):
    """The reference's tile contract: ``(rt, ft)`` cut to the array and
    checked (``moe_gmm.py:38-42``)."""
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x [T, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    t, f = x.shape[0], w.shape[2]
    rt, ft = min(rt, t), min(ft, f)
    if rt < 1 or ft < 1 or t % rt or f % ft:
        raise ValueError(f"T={t} must split into row tiles of {rt} and "
                         f"F={f} into column tiles of {ft}")
    if tuple(group_ids.shape) != (t // rt,):
        raise ValueError(f"group_ids must be [{t // rt}], got "
                         f"{tuple(group_ids.shape)}")
    return rt, ft


def launch_plan(t: int, d: int, f: int, rt: int, dtype: torch.dtype,
                aligned: bool = True) -> LaunchPlan:
    """The design and launch of ``gmm`` on ``x [t, d]``, ``w [E, d, f]``
    with row tiles of ``rt`` (already cut to ``t``), by type and shape:

    * ``wgmma`` for bf16 with ``rt % 64 == 0``, d and f multiples of 8 (a
      TMA row stride is a multiple of 16 bytes) and 16-byte aligned bases:
      blocks of 128 rows x 256 columns, depth 64 a stage, a 4-stage ring,
      3 warpgroups. A block's two 64-row halves share one pass over w
      only where they share a group id (always when ``rt % 128 == 0``);
      otherwise it makes one pass a half, so no pass mixes experts;
    * ``blocked`` for float32 with ``rt % 64 == 0``, d and f multiples of
      4 and aligned bases (16-byte loads): 64 x 256 tiles, depth 16, two
      stages, 256 threads;
    * ``simt`` otherwise: BM the largest of 64/32/16/8 dividing rt (rt
      must be a multiple of 8), 64 columns, depth 16.

    ``aligned`` says whether x and w start on 16-byte boundaries.
    ``tiles`` is (rows, columns, depth) of a block. The rows a pass reads
    with one expert's weights never exceed rt: the simt and blocked tiles
    divide rt, and the wgmma block's 128 rows are one pass only where
    they are one expert's. ``csrc/gmm.cu`` launches this plan as it is
    and refuses one that differs from its own geometry."""
    if dtype not in DTYPES:
        raise TypeError(f"x: expected one of {DTYPES}, got {dtype}")
    wide = rt % 64 == 0 and d > 0 and aligned
    if dtype == torch.bfloat16 and wide and d % 8 == 0 and f % 8 == 0:
        smem = (WGMMA_STAGES * (128 * 64 * 2 + 64 * 256 * 2)
                + 2 * WGMMA_STAGES * 8 + 1024)
        return LaunchPlan("wgmma", (128, 256, 64),
                          (_cdiv(t, 128) * _cdiv(f, 256), 1, 1), 384,
                          WGMMA_STAGES, smem)
    if dtype == torch.float32 and wide and d % 4 == 0 and f % 4 == 0:
        return LaunchPlan("blocked", (64, 256, 16),
                          (t // 64 * _cdiv(f, 256), 1, 1), 256, 2,
                          2 * 16 * (64 + 256) * 4)
    bm = next((b for b in KERNEL_ROWS if rt % b == 0), None)
    if bm is None:
        raise ValueError(f"the kernel takes row tiles that are multiples of "
                         f"8, got rt={rt}")
    return LaunchPlan("simt", (bm, 64, 16), (t // bm, _cdiv(f, 64), 1),
                      bm * 4, 1, 4 * (16 * (bm + 1) + 16 * 64))


def plain_gmm(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
              rt: int = ROW_TILE) -> torch.Tensor:
    """One float32 matmul per expert over the row tiles it owns, stored in
    x's type (``repro/kernels/ref.py::gmm_ref`` without materialising
    ``w[group_ids]``). Group ids must lie in ``[0, E)``."""
    t, d = x.shape
    e, _, f = w.shape
    rt = min(rt, t)
    if group_ids.numel() and (int(group_ids.min()) < 0
                              or int(group_ids.max()) >= e):
        raise ValueError(f"group ids must lie in [0, {e})")
    out = torch.empty(t, f, dtype=x.dtype, device=x.device)
    xt, ot = x.view(t // rt, rt, d), out.view(t // rt, rt, f)
    for g in torch.unique(group_ids).tolist():
        tiles = torch.nonzero(group_ids == g)[:, 0]
        ot[tiles] = (xt[tiles].float() @ w[g].float()).to(x.dtype)
    return out


def error_bound(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
                rt: int, want: torch.Tensor) -> torch.Tensor:
    """Per element ``[T, F]``: how far the kernel and :func:`plain_gmm`
    (``want``) may lie apart on these inputs. Two float32 sums of the same
    D products (a bf16 product is exact in float32) differ by at most
    2 gamma(D) sum |x * w|; in bf16 the two outputs may also round to
    neighbouring values, one ulp (at most 2^-7 of the value) apart."""
    tol = 2 * gamma(x.shape[1]) * plain_gmm(
        x.float().abs(), w.float().abs(), group_ids, rt)
    if x.dtype.itemsize == 2:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return tol


def gmm(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
        rt: int = ROW_TILE, ft: int = F_TILE) -> torch.Tensor:
    """``x [T, D]`` (expert-bucketed rows), ``w [E, D, F]``, ``group_ids
    [T // rt]`` int32 -> ``[T, F]`` in x's type, with ``rt = min(rt, T)``
    dividing T and ``ft = min(ft, F)`` dividing F, as the reference
    asserts. On the card x and w are both float32 or both bfloat16, and
    rt is a multiple of 8; the design follows :func:`launch_plan` (bf16 on
    wgmma, float32 on the register-blocked GEMM, other shapes and
    unaligned bases on the simt kernel). A tile whose group id lies
    outside ``[0, E)`` comes out as zeros there (the plain version
    raises)."""
    rt, ft = _tiles(x, w, group_ids, rt, ft)
    if not _on_cuda(x):
        return plain_gmm(x, w, group_ids, rt)
    dev = x.device
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected one of {DTYPES}, got {x.dtype}")
    _check(x, "x", x.dtype, x.shape, dev)
    _check(w, "w", x.dtype, w.shape, dev)
    _check(group_ids, "group_ids", torch.int32, group_ids.shape, dev)
    t, d = x.shape
    e, _, f = w.shape
    plan = launch_plan(t, d, f, rt, x.dtype, _aligned(x, w))
    out = torch.empty(t, f, dtype=x.dtype, device=dev)
    if t == 0:
        return out
    from ._build import library
    _raise_on(library("gmm").dcra_gmm(
        x.data_ptr(), w.data_ptr(), group_ids.data_ptr(), out.data_ptr(), t,
        d, f, rt, e, DTYPES.index(x.dtype), as_c(plan, PATH_CODES[plan.path]),
        _stream(dev)), "gmm")
    LAUNCHES["gmm"] += 1
    PATHS[plan.path] += 1
    return out
