"""RWKV6 "Finch": attention-free time-mix with a data-dependent decay
(counterpart of ``repro/models/rwkv6.py``).

The pieces are the reference's: a per-channel decay ``w_t =
exp(-exp(d_t))`` with a low-rank (LoRA, rank 64) ``d_t``, the bonus
``u``, token shift by static mixing vectors, the WKV state recurrence,
the per-head group norm, the gated output and the squared-ReLU channel
mix. Two evaluations of the recurrence:

* :func:`wkv_scan`, the exact recurrence a token at a time (the oracle,
  and the decode step);
* :func:`wkv_chunked`, chunks of :data:`CHUNK` tokens with pairwise
  per-channel log-space decays, the state carried from chunk to chunk.

Plain torch ops, as the reference's are plain ``jnp`` (no TPU kernel).
Types follow the reference's promotion: the recurrence runs in float32
whatever the activations' type, the decay ``w`` is float32 (bf16
activations meet the float32 LoRA weights), and the block's output is
in x's type.

One deliberate difference: :func:`wkv_chunked` masks the pairwise
log-decays above the diagonal before ``exp``, where the reference takes
``exp`` of every pair and masks after. The forward values are the same;
under a strong decay the reference's ``exp`` of a masked pair overflows
to inf and its gradient turns NaN (0 * inf), the port's stays finite.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from .attention import _promoted
from .common import dense_init

CHUNK = 32  # pairwise-decay chunk (kept small: decays are per-channel)
LORA_RANK = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # [B, H, hd, hd] per-layer recurrent state
    x_tmix: torch.Tensor    # [B, D] previous token (time-mix shift)
    x_cmix: torch.Tensor    # [B, D] previous token (channel-mix shift)


def _heads(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.ssm.head_dim
    return cfg.d_model // hd, hd


def init_rwkv_block(gen: torch.Generator, cfg: ArchConfig
                    ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    H, hd = _heads(cfg)
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, device=dev)
    p = {name: full((d,), 0.5) for name in (
        "mix_r", "mix_k", "mix_v", "mix_w", "mix_g", "mix_ck", "mix_cr")}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, (d,))
    # data-dependent decay LoRA: d_t = base + W2 tanh(W1 x)
    p["w_base"] = full((d,), -4.0)
    p["w_lora1"] = dense_init(gen, d, (LORA_RANK,), scale=0.1)
    p["w_lora2"] = dense_init(gen, LORA_RANK, (d,), scale=0.1)
    p["u"] = torch.zeros((H, hd), device=dev)          # bonus
    p["ln_x"] = torch.ones((d,), device=dev)           # per-head group norm
    # channel mix
    p["ck"] = dense_init(gen, d, (cfg.d_ff,))
    p["cv"] = dense_init(gen, cfg.d_ff, (d,))
    p["cr"] = dense_init(gen, d, (d,))
    return p


def _token_shift(x, x_prev, mix):
    """lerp(x_{t-1}, x_t, mix); x [B,T,D], x_prev [B,D] (state)."""
    prev = torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    m = mix.to(x.dtype)
    return x * m + prev * (1.0 - m)


def _decay(params, xw):
    """w in (0, 1), [B, T, D], float32 (bf16 activations meet the float32
    LoRA weights)."""
    low = torch.tanh(torch.matmul(*_promoted(xw, params["w_lora1"])))
    d_t = params["w_base"] + torch.matmul(*_promoted(low, params["w_lora2"]))
    return torch.exp(-torch.exp(d_t.float()))


def wkv_scan(r, k, v, w, u, s0):
    """Exact recurrence. r,k,v,w: [B,T,H,hd]; u: [H,hd]; s0: [B,H,hd,hd].

    y_t = r_t · (S_{t-1} + diag(u) k_t^T v_t);  S_t = diag(w_t) S_{t-1} + k_t^T v_t
    Returns y [B,T,H,hd], s_end.
    """
    s = s0
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # [B,H,hd]
        kv = kt[..., :, None] * vt[..., None, :]              # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + bonus * kv))
        s = wt[..., None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked(r, k, v, w, u, s0, chunk: int = CHUNK):
    """Chunked parallel WKV with pairwise log-space decays.

    Per chunk with local decays w_t, log-cumsum a_t = sum_{i<=t} log w_i:
    intra: y_t += sum_{s<t} (r_t * exp(a_{t-1}-a_s)) · k_s v_s + r_t·(u k_t) v_t
    inter: y_t += (r_t * exp(a_{t-1})) · S_0
    carry: S' = diag(exp(a_L)) S_0 + sum_s exp(a_L - a_s) k_s^T v_s
    The pairs s >= t are masked before ``exp`` (see the module's note).
    """
    B, T, H, hd = r.shape
    n = T // chunk
    if n * chunk != T:
        raise ValueError(f"sequence {T} is not a multiple of the chunk "
                         f"{chunk}")
    logw = torch.log(torch.clamp(w, 1e-38, 1.0))
    tmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), -1)[None, :, :, None, None]
    bonus = u[None, None]
    s = s0
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]
        a = torch.cumsum(lw, dim=1)                      # [B,L,H,hd]
        a_prev = a - lw                                  # a_{t-1}
        # pairwise per-channel decays: exp(a_prev[t] - a[s]) for s < t
        diff = a_prev[:, :, None] - a[:, None, :]        # [B,L,L,H,hd]
        gamma = torch.exp(torch.where(tmask, diff, -torch.inf))
        att = torch.einsum("bthc,bshc,btshc->btsh", rc, kc,
                           gamma.to(rc.dtype))
        y = torch.einsum("btsh,bshv->bthv", att, vc)
        # diagonal bonus term: (sum_c r_tc u_c k_tc) * v_t
        y = y + torch.einsum("bthc,bthc->bth", rc, bonus * kc)[..., None] * vc
        # inter-chunk
        y = y + torch.einsum("bthc,bhcv->bthv",
                             rc * torch.exp(a_prev).to(rc.dtype), s)
        # carry
        aL = a[:, -1]                                    # [B,H,hd]
        kdec = kc * torch.exp(aL[:, None] - a).to(kc.dtype)
        s = torch.exp(aL)[..., None].to(s.dtype) * s + torch.einsum(
            "bthc,bthv->bhcv", kdec, vc)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def rwkv_block(params, x, cfg: ArchConfig, state: RWKVState,
               impl: str = "chunked") -> Tuple[torch.Tensor, RWKVState]:
    """Full RWKV6 block (time-mix + channel-mix). x [B,T,D]; the scan
    where ``impl`` is ``"scan"``, T is 1 or T is off the chunk."""
    d = cfg.d_model
    H, hd = _heads(cfg)
    B, T, _ = x.shape
    dt = x.dtype
    f32 = torch.float32
    x_in_last = x[:, -1]

    # ---- time mix -----------------------------------------------------
    def proj(name, mix):
        return torch.matmul(_token_shift(x, state.x_tmix, params[mix]),
                            params[name].to(dt))
    r = proj("wr", "mix_r").reshape(B, T, H, hd)
    k = proj("wk", "mix_k").reshape(B, T, H, hd)
    v = proj("wv", "mix_v").reshape(B, T, H, hd)
    g = torch.nn.functional.silu(proj("wg", "mix_g"))
    w = _decay(params, _token_shift(x, state.x_tmix,
                                    params["mix_w"])).reshape(B, T, H, hd)

    wkv = (wkv_scan if impl == "scan" or T == 1 or T % CHUNK != 0
           else wkv_chunked)
    y, s_end = wkv(r.to(f32), k.to(f32), v.to(f32), w,
                   params["u"].to(f32), state.wkv.to(f32))
    # per-head group norm
    y32 = y.to(f32)
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, unbiased=False)
    y = ((y32 - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, d).to(dt)
    y = y * params["ln_x"].to(dt) * g
    x = x + torch.matmul(y, params["wo"].to(dt))
    x_mid_last = x[:, -1]

    # ---- channel mix ---------------------------------------------------
    xck = _token_shift(x, state.x_cmix, params["mix_ck"])
    xcr = _token_shift(x, state.x_cmix, params["mix_cr"])
    kk = torch.square(torch.relu(torch.matmul(xck, params["ck"].to(dt))))
    cv = torch.matmul(kk, params["cv"].to(dt))
    cr = torch.sigmoid(torch.matmul(xcr, params["cr"].to(dt)))
    x = x + cr * cv

    new_state = RWKVState(s_end.to(state.wkv.dtype),
                          x_in_last.to(state.x_tmix.dtype),
                          x_mid_last.to(state.x_cmix.dtype))
    return x, new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                    device=None) -> RWKVState:
    d = cfg.d_model
    H, hd = _heads(cfg)
    return RWKVState(torch.zeros((batch, H, hd, hd), dtype=dtype,
                                 device=device),
                     torch.zeros((batch, d), dtype=dtype, device=device),
                     torch.zeros((batch, d), dtype=dtype, device=device))
