"""The grouped (expert) matmul kernel and its plain version (counterpart
of ``repro/kernels/moe_gmm.py``, ``gmm_pallas``).

``out[t] = x[t] @ w[group_ids[t // rt]]``, accumulated in float32 and
returned in x's type. The layout is the MoE dispatch's output:
expert-bucketed, capacity-padded rows, so each row tile of ``rt`` rows
belongs to one expert.

On a CUDA tensor :func:`gmm` launches the hand-written kernel
(``csrc/gmm.cu``) and adds one to ``LAUNCHES["gmm"]``; on a CPU tensor it
runs :func:`plain_gmm`. Any other device raises.
"""
from __future__ import annotations

import torch

from .route import _check, _on_cuda, _raise_on, _stream, gamma

ROW_TILE = 128
F_TILE = 128
DTYPES = (torch.float32, torch.bfloat16)
#: block row tiles of the kernel; the largest dividing rt is taken
KERNEL_ROWS = (64, 32, 16, 8)

#: kernel launches since the last reset (chip_smoke reads this)
LAUNCHES = {"gmm": 0}


def reset_launches() -> None:
    LAUNCHES["gmm"] = 0


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
    rt is a multiple of 8; a tile whose group id lies outside ``[0, E)``
    comes out as zeros there (the plain version raises)."""
    rt, ft = _tiles(x, w, group_ids, rt, ft)
    if not _on_cuda(x):
        return plain_gmm(x, w, group_ids, rt)
    dev = x.device
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected one of {DTYPES}, got {x.dtype}")
    _check(x, "x", x.dtype, x.shape, dev)
    _check(w, "w", x.dtype, w.shape, dev)
    _check(group_ids, "group_ids", torch.int32, group_ids.shape, dev)
    bm = next((b for b in KERNEL_ROWS if rt % b == 0), None)
    if bm is None:
        raise ValueError(f"the kernel takes row tiles that are multiples of "
                         f"8, got rt={rt}")
    t, d = x.shape
    e, _, f = w.shape
    out = torch.empty(t, f, dtype=x.dtype, device=dev)
    if t == 0:
        return out
    from ._build import library
    _raise_on(library("gmm").dcra_gmm(
        x.data_ptr(), w.data_ptr(), group_ids.data_ptr(), out.data_ptr(), t,
        d, f, rt, e, DTYPES.index(x.dtype), bm, _stream(dev)), "gmm")
    LAUNCHES["gmm"] += 1
    return out
