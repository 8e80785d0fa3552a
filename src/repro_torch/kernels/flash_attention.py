"""The flash-attention kernel and its plain version (counterpart of
``repro/kernels/flash_attention.py``, ``flash_attention_pallas``).

``o = softmax(q k^T * hd^-0.5, causal mask -1e30) v`` over ``[BH, S,
hd]``, as an online softmax over key tiles: float32 logits and m / l /
acc, ``p`` rounded to v's type before ``p @ v``, ``l`` clamped at 1e-30,
the output in q's type.

On a CUDA tensor :func:`flash_attention` launches a hand-written kernel
of ``csrc/flash_attention.cu``, chosen by :func:`launch_plan` (bf16 on
wgmma with 192-row q tiles, float32 on the register-blocked FFMA kernel
with 128-row q tiles, other widths and unaligned views on the simt kernel
with 64-row q tiles; all on 64-key tiles), and adds one to
``LAUNCHES["flash_attention"]`` and to its design's entry of ``PATHS``;
on a CPU tensor it runs :func:`plain_flash_attention` with the same key
tile. Any other device raises.
"""
from __future__ import annotations

import math

import torch

from ._launch import LaunchPlan, aligned as _aligned, as_c
from .route import _check, _on_cuda, _raise_on, _stream, gamma

TILE = 64              # the kernels' key tile (and the simt kernel's q tile)
MAX_HEAD_DIM = 128
NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
WGMMA_GROUPS = 3       # consumer warpgroups of 64 q rows
WGMMA_STAGES = 3       # K/V ring
BLOCKED_ROWS = 128     # q rows of a blocked block
#: the blocked kernel's shared memory at every hd: q^T [128][128], K [64][132],
#: V [64][128], p^T [64][132], float32
BLOCKED_SMEM = 4 * (MAX_HEAD_DIM * BLOCKED_ROWS + TILE * (MAX_HEAD_DIM + 4)
                    + TILE * MAX_HEAD_DIM + TILE * (BLOCKED_ROWS + 4))
#: the designs of ``csrc/flash_attention.cu``, as the C entry point numbers
#: them
PATH_CODES = {"simt": 0, "wgmma": 1, "blocked": 2}

#: kernel launches since the last reset, in all and by design (chip_smoke
#: reads these)
LAUNCHES = {"flash_attention": 0}
PATHS = {path: 0 for path in PATH_CODES}


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0
    for path in PATHS:
        PATHS[path] = 0


def launch_plan(bh: int, s: int, hd: int, dtype: torch.dtype,
                aligned: bool = True) -> LaunchPlan:
    """The design and launch of ``flash_attention`` on ``[bh, s, hd]``, by
    type and shape:

    * ``wgmma`` for bf16 with ``hd % 8 == 0`` (a TMA row stride is a
      multiple of 16 bytes) and 16-byte aligned bases: 192 q rows (three
      consumer warpgroups) and :data:`TILE` keys a step, hd padded to 64
      or 128, a 3-stage K/V ring, a producer warpgroup, grid (bh, q
      tiles);
    * ``blocked`` for float32 with ``hd % 4 == 0`` (16-byte rows) and
      16-byte aligned bases: 128 q rows and :data:`TILE` keys a step in
      float32 FFMA, 256 threads, K and V alternating in a two-slot
      ``cp.async`` ring, :data:`BLOCKED_SMEM` bytes, grid (bh, q tiles);
    * ``simt`` otherwise (bf16 with hd off 8, float32 with hd off 4, or
      unaligned bases): 64 q rows and :data:`TILE` keys, 256 threads,
      grid (q tiles, bh).

    ``aligned`` says whether q, k and v start on 16-byte boundaries.
    ``tiles`` is (q rows, keys, head width) of a step.
    ``csrc/flash_attention.cu`` launches this plan as it is and refuses
    one that differs from its own geometry."""
    if dtype not in DTYPES:
        raise TypeError(f"q: expected one of {DTYPES}, got {dtype}")
    if dtype == torch.bfloat16 and hd % 8 == 0 and aligned:
        hdp = 64 if hd <= 64 else 128
        tile = 64 * hdp * 2                    # 64 rows of hdp bf16
        smem = (WGMMA_GROUPS * tile + WGMMA_STAGES * 2 * tile
                + (1 + 2 * WGMMA_STAGES) * 8 + 1024)
        q_rows = 64 * WGMMA_GROUPS
        return LaunchPlan("wgmma", (q_rows, TILE, hdp),
                          (bh, -(-s // q_rows), 1), 128 * (WGMMA_GROUPS + 1),
                          WGMMA_STAGES, smem)
    if dtype == torch.float32 and hd % 4 == 0 and aligned:
        return LaunchPlan("blocked", (BLOCKED_ROWS, TILE, hd),
                          (bh, -(-s // BLOCKED_ROWS), 1), 256, 2,
                          BLOCKED_SMEM)
    smem = 4 * (2 * TILE * (hd + 1) + TILE * hd + TILE * (TILE + 1))
    return LaunchPlan("simt", (TILE, TILE, hd), (-(-s // TILE), bh, 1), 256,
                      1, smem)


def plain_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, tk: int = TILE
                          ) -> torch.Tensor:
    """The TPU kernel's online softmax, every q row at once, one key tile
    of ``tk`` rows a step in order. A causal tile above a row's diagonal
    is fully masked there, which leaves m, l and acc exactly as skipping
    it would (the row's max is finite from the first tile on), so the
    q tile size does not enter."""
    bh, s, hd = q.shape
    scale = hd ** -0.5
    qf = q.float()
    m = torch.full((bh, s), NEG_INF, device=q.device)
    l = torch.zeros(bh, s, device=q.device)
    acc = torch.zeros(bh, s, hd, device=q.device)
    qi = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, tk):
        kt, vt = k[:, k0:k0 + tk].float(), v[:, k0:k0 + tk]
        sc = torch.matmul(qf, kt.transpose(1, 2)) * scale
        if causal:
            kj = torch.arange(k0, k0 + kt.shape[1], device=q.device)[None]
            sc = torch.where(kj <= qi, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    vt.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, want: torch.Tensor) -> torch.Tensor:
    """Per element ``[BH, S, hd]``: how far the kernel and
    :func:`plain_flash_attention` (``want``) may lie apart on these
    inputs, in units of ``W = sum_j w_j |v_j|``, the row's softmax
    weights over |v| (the plain version on float32 inputs and |v|):

    * logits: two runs differ by at most ``e = 2 gamma(hd) hd^-0.5 |q_i|
      max_j |k_j|`` (Cauchy-Schwarz on sum |q k|), so each weight
      ``p_j / l`` moves by a factor within exp(+-2e), the output by at
      most ``(e^2e - 1) W <= 4e W``;
    * each run's p v sums and l lie within gamma(S) of their magnitude
      sums, and the exps and per-tile rescales add a few roundings each:
      ``4 gamma(S + 2 n_tiles + 32) W`` for the two runs;
    * in bf16 a p rounded to bf16 may land one ulp (at most 2^-7 of p)
      off the other run's, ``2^-7 W``, and the output one ulp, ``2^-7
      |want|``.

    W is the size of the row's weighted |v|, not max|v|: at S = 4096 with
    random inputs W is about 0.8 and |o| about 0.04, so the float32 bound
    is a few percent of |o|."""
    s, hd = q.shape[-2], q.shape[-1]
    qn = q.float().norm(dim=-1, keepdim=True)
    kn = k.float().norm(dim=-1).amax(-1)[..., None, None]
    e = 2 * gamma(hd) * hd ** -0.5 * qn * kn
    w = plain_flash_attention(q.float(), k.float(), v.float().abs(), causal)
    tol = (4 * e + 4 * gamma(s + 2 * math.ceil(s / TILE) + 32)) * w
    if q.dtype.itemsize == 2:
        tol = tol + 2.0 ** -7 * (w + want.float().abs())
    return tol


def unrounded_share(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, got: torch.Tensor, want: torch.Tensor
                    ) -> float:
    """bf16: ``mean |got - want|`` over ``mean |u - want|``, u the plain
    version with p left in float32. The per-element bound admits every p
    one ulp off, so it cannot tell a kernel that skips the rounding of p;
    this can. A kernel that rounds p to bf16 at the plain version's
    running max (the same key tiles) lies far nearer ``want`` than u does
    (about 0.002 of u's distance on random inputs); one that leaves p
    unrounded gives 1."""
    loose = plain_flash_attention(q, k, v.float(), causal)
    gap = float((loose.float() - want.float()).abs().mean())
    return float((got.float() - want.float()).abs().mean()) / gap


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """``q, k, v [BH, S, hd]`` -> ``[BH, S, hd]`` in q's type. On the
    card: float32 or bfloat16 alike, contiguous, ``hd <= 128``, ``BH <=
    65535``; any S (a ragged last tile is masked). The design follows
    :func:`launch_plan`: bf16 with ``hd % 8 == 0`` runs on wgmma, float32
    with ``hd % 4 == 0`` on the blocked kernel, other widths and unaligned
    bases on the simt kernel."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"need q, k, v [BH, S, hd] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not _on_cuda(q):
        return plain_flash_attention(q, k, v, causal)
    bh, s, hd = q.shape
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected one of {DTYPES}, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t, name, q.dtype, q.shape, dev)
    if not 1 <= hd <= MAX_HEAD_DIM or bh > 65535:
        raise ValueError(f"the kernel takes 1 <= hd <= {MAX_HEAD_DIM} and "
                         f"BH <= 65535, got hd={hd}, BH={bh}")
    plan = launch_plan(bh, s, hd, q.dtype, _aligned(q, k, v))
    o = torch.empty_like(q)
    if bh == 0 or s == 0:
        return o
    from ._build import library
    _raise_on(library("flash_attention").dcra_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, hd,
        hd ** -0.5, int(causal), DTYPES.index(q.dtype),
        as_c(plan, PATH_CODES[plan.path]), _stream(dev)), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    PATHS[plan.path] += 1
    return o
