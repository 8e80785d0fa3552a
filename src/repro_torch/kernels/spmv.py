"""Block-sparse-row SpMV: the kernel, its plain version, and the host-side
CSR -> BSR conversion (counterpart of ``repro/kernels/spmv.py``).

On a CUDA tensor :func:`bsr_spmv` launches a hand-written kernel of
``csrc/spmv.cu``, chosen by :func:`launch_plan` (``split`` for BS a
multiple of 4 on 16-byte aligned arrays, ``rowblock`` otherwise), and
adds one to ``LAUNCHES["bsr_spmv"]`` and to its design's entry of
``PATHS``; on a CPU tensor it runs :func:`plain_bsr_spmv`. Any other
device raises.

Padding contract, as in the reference: rows of ``block_cols`` are padded
with block column 0 and all-zero blocks, so padded steps add nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.fabric import resolve_device
from ..sparse.csr import CSR
from ._launch import LaunchPlan, aligned as _aligned, as_c
from .route import _check, _on_cuda, _raise_on, _stream

THREADS = 256
SPLIT_ROWS = 128          # rows of a split block's pass: 8 warps x 16
#: the split design's least block count: 8 an SM on the H100's 132 SMs
TARGET_BLOCKS = 8 * 132
#: the designs of ``csrc/spmv.cu``, as the C entry point numbers them
PATH_CODES = {"rowblock": 0, "split": 1}

#: kernel launches since the last reset, in all and by design (chip_smoke
#: reads these)
LAUNCHES = {"bsr_spmv": 0}
PATHS = {path: 0 for path in PATH_CODES}


def reset_launches() -> None:
    LAUNCHES["bsr_spmv"] = 0
    for path in PATHS:
        PATHS[path] = 0


def n_splits(r: int, kb: int) -> int:
    """Slices of the Kb loop on the split design: 1 where ``r`` row blocks
    already make :data:`TARGET_BLOCKS` blocks, else the power of two that
    reaches them, at most ``kb`` (so no slice is empty)."""
    if kb < 1 or r >= TARGET_BLOCKS:
        return 1
    want = -(-TARGET_BLOCKS // r)
    return min(kb, 1 << (want - 1).bit_length())


def launch_plan(r: int, kb: int, bs: int, aligned: bool = True
                ) -> LaunchPlan:
    """The design and launch of ``bsr_spmv`` on ``blocks [r, kb, bs, bs]``:

    * ``split`` for ``bs % 4 == 0`` and 16-byte aligned blocks and x:
      :func:`n_splits` slices of the Kb loop, one block of 256 threads a
      (row block, slice), block ``(r, s)`` walking ``k`` in ``[s*kb/splits,
      (s+1)*kb/splits)`` over passes of :data:`SPLIT_ROWS` rows, no shared
      memory; with more than one slice the partial sums go to a
      ``[splits, r*bs]`` scratch summed in slice order by a second kernel;
    * ``rowblock`` otherwise: one block of 256 threads a row block, the x
      tile and the row sums in ``2*bs`` floats of shared memory.

    ``tiles`` is (rows a pass, block columns a slice at most, bs); the
    grid is 1D, ``r * splits`` blocks. ``csrc/spmv.cu`` launches this plan
    as it is and refuses one that differs from its own geometry."""
    if bs % 4 == 0 and aligned:
        splits = n_splits(r, kb)
        return LaunchPlan("split", (SPLIT_ROWS, -(-kb // splits), bs),
                          (r * splits, 1, 1), THREADS, 1, 0)
    return LaunchPlan("rowblock", (bs, kb, bs), (r, 1, 1), THREADS, 1,
                      2 * bs * 4)


def plain_bsr_spmv(block_cols, blocks, x):
    """The einsum of ``repro/kernels/ref.py::bsr_spmv_ref``: ``y[r*BS +
    i] = sum_k sum_j blocks[r, k, i, j] * x[block_cols[r, k]*BS + j]``."""
    bs = blocks.shape[-1]
    gathered = x.view(-1, bs)[block_cols.long()]            # [R, Kb, BS]
    return torch.einsum("rkij,rkj->ri", blocks, gathered).reshape(-1)


def bsr_spmv(block_cols, blocks, x):
    """``block_cols [R, Kb]`` int32, ``blocks [R, Kb, BS, BS]`` float32,
    ``x [Ncb * BS]`` float32 -> ``y [R * BS]`` float32, accumulated in
    float32. Block columns must lie in ``[0, Ncb)`` (on the card one
    outside reads as a zero x tile). The design follows
    :func:`launch_plan`; on the split design two runs give the same
    bits."""
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
    plan = launch_plan(r, kb, bs, _aligned(blocks, x))
    splits = plan.grid[0] // r
    scratch = (torch.empty(splits, r * bs, dtype=torch.float32, device=dev)
               if splits > 1 else None)
    from ._build import library
    _raise_on(library("spmv").dcra_bsr_spmv(
        block_cols.data_ptr(), blocks.data_ptr(), x.data_ptr(), r, kb, bs,
        x.numel() // bs, y.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        as_c(plan, PATH_CODES[plan.path]), _stream(dev)), "bsr_spmv")
    LAUNCHES["bsr_spmv"] += 1
    PATHS[plan.path] += 1
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
