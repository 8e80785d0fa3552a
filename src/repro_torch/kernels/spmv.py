"""Block-sparse-row SpMV: the kernel, its plain version, and the host-side
CSR -> BSR conversion (counterpart of ``repro/kernels/spmv.py``).

On a CUDA tensor :func:`bsr_spmv` launches the hand-written kernel
(``csrc/spmv.cu``) and adds one to ``LAUNCHES["bsr_spmv"]``; on a CPU
tensor it runs :func:`plain_bsr_spmv`. Any other device raises.

Padding contract, as in the reference: rows of ``block_cols`` are padded
with block column 0 and all-zero blocks, so padded steps add nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.fabric import resolve_device
from ..sparse.csr import CSR
from .route import _check, _on_cuda, _raise_on, _stream

#: kernel launches since the last reset (chip_smoke reads this)
LAUNCHES = {"bsr_spmv": 0}


def reset_launches() -> None:
    LAUNCHES["bsr_spmv"] = 0


def plain_bsr_spmv(block_cols, blocks, x):
    """The einsum of ``repro/kernels/ref.py::bsr_spmv_ref``: ``y[r*BS +
    i] = sum_k sum_j blocks[r, k, i, j] * x[block_cols[r, k]*BS + j]``."""
    bs = blocks.shape[-1]
    gathered = x.view(-1, bs)[block_cols.long()]            # [R, Kb, BS]
    return torch.einsum("rkij,rkj->ri", blocks, gathered).reshape(-1)


def bsr_spmv(block_cols, blocks, x):
    """``block_cols [R, Kb]`` int32, ``blocks [R, Kb, BS, BS]`` float32,
    ``x [Ncb * BS]`` float32 -> ``y [R * BS]`` float32, accumulated in
    float32. Block columns must lie in ``[0, Ncb)``."""
    if not _on_cuda(blocks):
        return plain_bsr_spmv(block_cols, blocks, x)
    if blocks.dim() != 4 or blocks.shape[2] != blocks.shape[3]:
        raise ValueError(f"blocks must be [R, Kb, BS, BS], got "
                         f"{tuple(blocks.shape)}")
    r, kb, bs, _ = blocks.shape
    dev = blocks.device
    _check(blocks, "blocks", torch.float32, blocks.shape, dev)
    _check(block_cols, "block_cols", torch.int32, (r, kb), dev)
    if x.dim() != 1 or x.numel() % bs or x.numel() == 0:
        raise ValueError(f"x must be [Ncb * {bs}], got {tuple(x.shape)}")
    _check(x, "x", torch.float32, x.shape, dev)
    y = torch.empty(r * bs, dtype=torch.float32, device=dev)
    if r == 0:
        return y
    from ._build import library
    _raise_on(library("spmv").dcra_bsr_spmv(
        block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), r, kb, bs,
        x.numel() // bs, y.data_ptr(), _stream(dev)), "bsr_spmv")
    LAUNCHES["bsr_spmv"] += 1
    return y


# ---------------------------------------------------------------------------
# CSR -> BSR (host side, numpy)
# ---------------------------------------------------------------------------

def csr_to_bsr(g: CSR, bs: int = 128):
    """Padded BSR arrays of ``g``: ``(block_cols [n_rb, Kb] int32, blocks
    [n_rb, Kb, bs, bs] float32)``, numpy, byte-identical to the
    reference's. A stored block's slot is its rank among the sorted
    distinct block keys of its row block; every row block is padded to
    the largest ``Kb``."""
    n_rb = n_cb = -(-g.n // bs)
    rows = g.row_of()
    rb = rows // bs
    key = rb * n_cb + g.col_idx // bs
    uniq = np.sort(key)
    if len(uniq):
        uniq = uniq[np.r_[True, uniq[1:] != uniq[:-1]]]
    rb_of_blk = (uniq // n_cb).astype(np.int64)
    counts = np.bincount(rb_of_blk, minlength=n_rb)
    kb = max(int(counts.max(initial=1)), 1)
    slot_of_blk = (np.arange(len(uniq))
                   - np.searchsorted(rb_of_blk, rb_of_blk, side="left"))
    block_cols = np.zeros((n_rb, kb), np.int32)
    block_cols[rb_of_blk, slot_of_blk] = uniq % n_cb
    blocks = np.zeros((n_rb, kb, bs, bs), np.float32)
    slots = slot_of_blk[np.searchsorted(uniq, key)]
    blocks[rb, slots, rows % bs, g.col_idx % bs] = g.values
    return block_cols, blocks


def spmv_csr(g: CSR, x: np.ndarray, bs: int = 128, device=None
             ) -> torch.Tensor:
    """End to end: ``A @ x`` for a CSR graph through the BSR kernel on
    ``device`` (default the card): ``[g.n]`` float32 tensor there."""
    dev = resolve_device(device)
    bc, blocks = csr_to_bsr(g, bs)
    xp = np.zeros(bc.shape[0] * bs, np.float32)
    xp[:g.n] = np.asarray(x, np.float32)
    y = bsr_spmv(torch.from_numpy(bc).to(dev),
                 torch.from_numpy(blocks).to(dev), torch.from_numpy(xp).to(dev))
    return y[:g.n]
