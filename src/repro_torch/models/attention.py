"""GQA attention: full/SWA masks, chunked online softmax, the ring KV
cache, and the flash kernel where the mask allows (counterpart of
``repro/models/attention.py``).

Where attention runs, by mask and shape, chosen before launch (a kernel
that fails to build or launch raises; nothing falls back):

| call | mask | on the card | on the CPU |
| --- | --- | --- | --- |
| forward / prefill, positions from ``_positions``, window 0 or S <= window | causal over indices | ``flash_attention`` kernel (``wgmma`` for bf16, ``blocked`` for f32) | ``plain_flash_attention`` through the same glue |
| forward with batch-given positions (VLM patches), or SWA with S > window | by positions | torch ``_direct_attend`` / ``_chunked_attend``, split at ``DIRECT_KV_LIMIT`` as in the reference | the same |
| decode, Sq = 1 over the ring cache | by ring positions | torch ``_direct_attend`` (the reference's own XLA path) | the same |
| cross-attention (``kv_source``, ``kv_precomputed``) | none, Sq != Skv | torch ``attend`` | the same |

The kernel glue (:func:`flash_attend`) repeats each KV head G = Hq / Hkv
times in the reference's grouping (query head h reads KV head h // G,
as ``_direct_attend``'s ``[B, S, Hkv, G, hd]`` reshape does), moves the
heads ahead of the sequence for ``kernels/ops.py::flash_attention`` and
back; its launches count in the kernel's ``LAUNCHES`` / ``PATHS``.

Numerics follow the reference: q, k and v in x's type (the weights cast
per op), float32 logits with fill -1e30, the softmax weights rounded to
v's type before ``w @ v``. Operands of two types meet in the promoted
one, as ``jnp.einsum`` promotes them (a bf16 model decoding over the
float32 cache that ``serve`` keeps). The KV cache is one
:class:`KVCache` a layer (the reference stacks them on a layer axis), a
ring of ``min(seq, window)`` slots written by a one-hot blend.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels import ops
from .common import apply_mrope, apply_rope, dense_init

DIRECT_KV_LIMIT = 4096
KV_CHUNK = 1024
NEG_INF = -1e30
INT32_MAX = 2 ** 31 - 1


class KVCache(NamedTuple):
    k: torch.Tensor     # [B, C, Hkv, hd]
    v: torch.Tensor     # [B, C, Hkv, hd]
    length: int         # tokens written so far (ring for SWA)


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   d_model: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, (cfg.num_heads, hd)),
        "wk": dense_init(gen, d, (cfg.num_kv_heads, hd)),
        "wv": dense_init(gen, d, (cfg.num_kv_heads, hd)),
        "wo": dense_init(gen, cfg.num_heads * hd, (d,)),
    }
    if cfg.qkv_bias:
        for name, h in (("bq", cfg.num_heads), ("bk", cfg.num_kv_heads),
                        ("bv", cfg.num_kv_heads)):
            p[name] = torch.zeros((h, hd), device=gen.device)
    return p


def _promoted(*ts):
    """``ts`` in their promoted type (``jnp.einsum``'s rule)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` in x's type."""
    w = w.to(x.dtype)
    return torch.matmul(x, w.reshape(w.shape[0], -1)).unflatten(
        -1, w.shape[1:])


def _qkv(params, x, cfg: ArchConfig, kv_source=None):
    src = x if kv_source is None else kv_source
    q = _proj(x, params["wq"])
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def project_cross_kv(params, enc_out, cfg: ArchConfig):
    """Precompute cross-attention K/V from encoder output (serving
    prefill)."""
    k = _proj(enc_out, params["wk"])
    v = _proj(enc_out, params["wv"])
    if cfg.qkv_bias:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return k, v


def _apply_pos(q, k, cfg: ArchConfig, positions):
    """positions: [B, S] (standard) or [B, 3, S] (M-RoPE)."""
    rope = apply_mrope if cfg.mrope else apply_rope
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta)


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """[..., Sq, Skv] boolean validity mask from position vectors."""
    kp, qp = kv_pos[..., None, :], q_pos[..., :, None]
    m = torch.ones(q_pos.shape[:-1] + (q_pos.shape[-1], kv_pos.shape[-1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > (qp - window))
    return m


def _direct_attend(q, k, v, q_pos, kv_pos, causal, window):
    """q [B,Sq,Hq,hd]; k,v [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd]."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg, k = _promoted(q.reshape(B, Sq, Hkv, Hq // Hkv, hd), k)
    # scaled out of place, in the operands' type: remat="dots" keeps the
    # einsum's output, which must not change after
    logits = torch.einsum("bshgk,bthk->bhgst", qg, k) * hd ** -0.5
    mask = _mask(q_pos, kv_pos, causal, window)          # [B?,Sq,Skv]
    if mask.dim() == 2:
        mask = mask[None]
    logits = logits.float().masked_fill_(~mask[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    del logits
    out = torch.einsum("bhgst,bthk->bshgk", w, v)
    return out.reshape(B, Sq, Hq, hd)


def _chunked_attend(q, k, v, q_pos, kv_pos, causal, window, chunk=KV_CHUNK):
    """Online softmax over KV chunks; exact; O(Sq * chunk) live memory."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = hd ** -0.5
    qg, k = _promoted(q.reshape(B, Sq, Hkv, G, hd), k)
    m = torch.full((B, Hkv, G, Sq), -torch.inf, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, hd), device=q.device)
    for c0 in range(0, Skv, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pb = kv_pos[c0:c0 + chunk]
        if kb.shape[1] < chunk:
            # the reference pads the last chunk; padded keys are masked
            pad = chunk - kb.shape[1]
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, pad))
            pb = torch.nn.functional.pad(pb, (0, pad), value=INT32_MAX)
        logits = torch.einsum("bshgk,bthk->bhgst", qg, kb).float() * scale
        msk = _mask(q_pos, pb, causal, window) & (pb != INT32_MAX)[..., None, :]
        if msk.dim() == 2:
            msk = msk[None]
        logits = logits.masked_fill_(~msk[:, None, None], NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bthk->bhgsk", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd)
    return out.to(q.dtype)


def attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0):
    if k.shape[1] <= DIRECT_KV_LIMIT or q.shape[1] == 1:
        return _direct_attend(q, k, v, q_pos, kv_pos, causal, window)
    return _chunked_attend(q, k, v, q_pos, kv_pos, causal, window)


def kernel_masks(seq_len: int, window: int, index_positions: bool) -> bool:
    """Whether the flash kernel's mask (causal or full over indices) is
    the layer's: positions are the indices ``0..S-1`` and the window, if
    any, covers the whole sequence."""
    return index_positions and (window == 0 or seq_len <= window)


def flash_attend(q, k, v, causal: bool) -> torch.Tensor:
    """q [B,S,Hq,hd], k,v [B,S,Hkv,hd] -> [B,S,Hq,hd] through
    ``kernels/ops.py::flash_attention``: the kernel on a CUDA tensor, its
    plain version on a CPU tensor. Each KV head is repeated G = Hq / Hkv
    times, so query head h reads KV head h // G."""
    g = q.shape[2] // k.shape[2]

    def heads(t, reps):
        if reps > 1:
            t = t.repeat_interleave(reps, dim=2)
        return t.transpose(1, 2).contiguous()            # [B, H, S, hd]
    if q.is_cuda and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash kernel is forward-only: a training forward takes the "
            "torch attention path (forward(batch, kernel=False), as "
            "launch/steps.py::make_train_step does)")
    out = ops.flash_attention(heads(q, 1), heads(k, g), heads(v, g),
                              causal=causal)
    return out.transpose(1, 2)


def attention_block(params, x, cfg: ArchConfig, positions, *,
                    causal: bool = True,
                    cache: Optional[KVCache] = None,
                    cache_pos=None,
                    kv_source: Optional[torch.Tensor] = None,
                    kv_precomputed: Optional[Tuple[torch.Tensor,
                                                   torch.Tensor]] = None,
                    index_positions: bool = False,
                    kernel: bool = True,
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One attention layer.

    * training/prefill: ``cache is None`` -> self-attention over ``x``;
      through the flash kernel when ``kernel`` and :func:`kernel_masks`
      (``index_positions``: the caller built ``positions`` as the indices
      ``0..S-1``); ``kernel=False`` forces the torch path (training, and
      the tests' comparisons).
    * decode: ``cache`` given, ``x`` is [B, 1, D]; writes K/V at
      ``cache_pos`` (ring position for SWA) and attends over the cache.
    * cross-attention: ``kv_source`` (encoder output, train) or
      ``kv_precomputed`` (projected K/V, decode): no rope, no causal mask.
    """
    window = cfg.sliding_window
    if kv_precomputed is not None:
        q = _proj(x, params["wq"])
        if cfg.qkv_bias:
            q = q + params["bq"].to(x.dtype)
        k, v = kv_precomputed
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        qp = positions if positions.dim() == 2 else positions[:, 0]
        return _finish(params, attend(q, k, v, qp, kv_pos, causal=False,
                                      window=0), x), None
    q, k, v = _qkv(params, x, cfg, kv_source=kv_source)
    new_cache = None
    if kv_source is not None:
        kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=x.device)
        qp = positions if positions.dim() == 2 else positions[:, 0]
        out = attend(q, k, v, qp, kv_pos, causal=False, window=0)
    elif cache is None:
        q, k = _apply_pos(q, k, cfg, positions)
        if kernel and kernel_masks(x.shape[1], window, index_positions):
            out = flash_attend(q, k, v, causal)
        else:
            qp = positions if not cfg.mrope else positions[:, 0]
            out = attend(q, k, v, qp, qp[0] if qp.dim() == 2 else qp,
                         causal=causal, window=window)
    else:
        # decode: x [B,1,D]; positions [B,1] (or [B,3,1] mrope) absolute
        q, k = _apply_pos(q, k, cfg, positions)
        C = cache.k.shape[1]
        slot = cache_pos % C
        k_cache = _scatter_slot(cache.k, k, slot)
        v_cache = _scatter_slot(cache.v, v, slot)
        qp = positions if not cfg.mrope else positions[:, 0]
        abs_pos = _cache_positions(cache_pos, C, x.device)
        out = attend(q, k_cache, v_cache, qp, abs_pos, causal=True,
                     window=window)
        new_cache = KVCache(k_cache, v_cache, cache.length + 1)
    return _finish(params, out, x), new_cache


def _finish(params, out, x):
    B, S = out.shape[:2]
    return torch.matmul(*_promoted(out.reshape(B, S, -1),
                                   params["wo"].to(x.dtype)))


def _scatter_slot(cache_arr, kv, slot):
    """Write kv [B,1,H,hd] into cache [B,C,H,hd] at ring index ``slot``,
    as the reference's one-hot blend (a non-finite entry elsewhere in the
    cache turns NaN, as there)."""
    C = cache_arr.shape[1]
    onehot = (torch.arange(C, device=cache_arr.device) == slot).to(kv.dtype)
    upd = onehot[None, :, None, None] * kv.to(cache_arr.dtype)
    keep = (1 - onehot)[None, :, None, None].to(cache_arr.dtype)
    return cache_arr * keep + upd.to(cache_arr.dtype)


def _cache_positions(cache_pos, C, device=None):
    """Absolute position of each ring slot given next-write pos
    ``cache_pos`` (an int or a 0-d tensor).

    Slots hold the last C tokens: slot i holds absolute position p where
    p = i (mod C) and p in [cache_pos - C, cache_pos - 1], plus the
    just-written token at slot cache_pos % C (position cache_pos). Slots
    not written yet (first lap) hold ``INT32_MAX``, which the causal
    check masks.
    """
    idx = torch.arange(C, dtype=torch.int64, device=device)
    wrap, base = cache_pos % C, cache_pos // C
    pos = torch.where(idx <= wrap, base * C + idx, (base - 1) * C + idx)
    return torch.where(pos < 0, INT32_MAX, pos).to(torch.int32)


def init_kv_cache(cfg: ArchConfig, batch: int, seq_len: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    """Cache for one layer. SWA bounds capacity by the window (ring)."""
    C = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (batch, C, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)
