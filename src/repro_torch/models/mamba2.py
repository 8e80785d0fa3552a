"""Mamba2 (SSD) block: the chunked scan, and the exact recurrence that is
its oracle and the decode step (counterpart of
``repro/models/mamba2.py``).

State-space recurrence per head (P = head dim, N = state dim):
  h_t = a_t * h_{t-1} + dt_t * (B_t ⊗ x_t)      h: [N, P], a_t = exp(dt_t * A)
  y_t = C_t · h_t + D * x_t

The chunked (SSD) form computes the intra-chunk terms with a pairwise
decay matrix (a scalar a head, in log space) and carries the state
across chunks. Plain torch ops, as the reference's are plain ``jnp``.

Types follow the reference's promotion: the causal conv multiplies x's
type by the float32 conv weights, so its output (and ``xs``, ``B``,
``C``) is float32 while its new tail keeps x's type (a float32 conv
cache comes back bf16 after a bf16 step, as there); the recurrence and
the ``D`` term run in float32; the block's output is in x's type.

One deliberate difference, as in :mod:`.rwkv6`: :func:`ssd_chunked`
masks the pairwise log-decays above the diagonal before ``exp``. The
forward values are the reference's; under a strong decay the
reference's gradient turns NaN, the port's stays finite.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import ArchConfig
from .common import dense_init, randn


class MambaState(NamedTuple):
    h: torch.Tensor       # [B, H, N, P] ssm state
    conv: torch.Tensor    # [B, W-1, conv_dim] depthwise-conv tail


def _dims(cfg: ArchConfig):
    ss = cfg.ssm
    d_in = ss.expand * cfg.d_model
    H = d_in // ss.head_dim
    return d_in, H, ss.head_dim, ss.state_dim, ss.conv_width


def init_mamba_block(gen: torch.Generator, cfg: ArchConfig
                     ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    d_in, H, P, N, W = _dims(cfg)
    conv_dim = d_in + 2 * N
    dev = gen.device
    return {
        # in_proj -> [z (gate), xBC, dt]
        "w_in": dense_init(gen, d, (d_in + conv_dim + H,)),
        "conv_w": randn(gen, (W, conv_dim)) * (W ** -0.5),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "dt_bias": torch.full((H,), -2.0, device=dev),
        "A_log": torch.zeros((H,), device=dev),        # A = -exp(A_log)
        "D": torch.ones((H,), device=dev),
        "norm_g": torch.ones((d_in,), device=dev),     # gated RMSNorm pre-out
        "w_out": dense_init(gen, d_in, (d,)),
    }


def _conv1d(xBC, conv_w, conv_b, conv_state):
    """Causal depthwise conv. xBC [B,T,C]; conv_state [B,W-1,C]. The
    output in the promoted type of x and the weights, the new tail in
    x's."""
    W = conv_w.shape[0]
    T = xBC.shape[1]
    full = torch.cat([conv_state.to(xBC.dtype), xBC], dim=1)
    out = sum(full[:, i:i + T] * conv_w[i] for i in range(W))
    new_state = full[:, -(W - 1):] if W > 1 else conv_state
    return torch.nn.functional.silu(out + conv_b.to(xBC.dtype)), new_state


def ssd_scan(x, dt, A, Bm, Cm, h0):
    """Exact recurrence. x [B,T,H,P]; dt [B,T,H]; A [H]; Bm,Cm [B,T,N].

    Returns y [B,T,H,P], h_end [B,H,N,P].
    """
    h = h0
    ys = []
    for t in range(x.shape[1]):
        xt, dtt, bt, ct = x[:, t], dt[:, t], Bm[:, t], Cm[:, t]
        a = torch.exp(dtt * A)                               # [B,H]
        upd = torch.einsum("bn,bhp,bh->bhnp", bt, xt, dtt)
        h = a[..., None, None] * h + upd
        ys.append(torch.einsum("bn,bhnp->bhp", ct, h))
    return torch.stack(ys, dim=1), h


def ssd_chunked(x, dt, A, Bm, Cm, h0, chunk: int):
    """SSD chunked form. Shapes as in :func:`ssd_scan`; the pairs s > t
    are masked before ``exp`` (see the module's note)."""
    B, T, H, P = x.shape
    n = T // chunk
    if n * chunk != T:
        raise ValueError(f"sequence {T} is not a multiple of the chunk "
                         f"{chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    h = h0
    ys = []
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        xc, dtc, bc, cc = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        la = dtc * A                                       # log a_t [B,L,H]
        cum = torch.cumsum(la, dim=1)                      # alpha_t
        # pairwise decay exp(alpha_t - alpha_s) for s <= t (scalar per head)
        diff = cum[:, :, None] - cum[:, None, :]           # [B,L,L,H]
        gamma = torch.exp(torch.where(mask, diff, -torch.inf))
        cb = torch.einsum("btn,bsn->bts", cc, bc)          # [B,L,L]
        att = cb[..., None] * gamma                        # [B,L,L,H]
        y = torch.einsum("btsh,bsh,bshp->bthp", att, dtc, xc)
        # inter: y_t += C_t exp(alpha_t) h_in
        y = y + torch.einsum("btn,bth,bhnp->bthp", cc, torch.exp(cum), h)
        # carry: h' = exp(alpha_L) h_in + sum_s exp(alpha_L - alpha_s) dt_s B_s x_s
        aL = cum[:, -1]                                    # [B,H]
        dec = torch.exp(aL[:, None] - cum)                 # [B,L,H]
        upd = torch.einsum("bsn,bsh,bshp->bhnp", bc, dec * dtc, xc)
        h = torch.exp(aL)[..., None, None] * h + upd
        ys.append(y)
    return torch.cat(ys, dim=1), h


def mamba_block(params, x, cfg: ArchConfig, state: MambaState,
                impl: str = "chunked") -> Tuple[torch.Tensor, MambaState]:
    """x [B,T,D] -> (out [B,T,D], new state); the scan where ``impl`` is
    ``"scan"``, T is 1 or T is off ``cfg.ssm.chunk_size``."""
    d_in, H, P, N, W = _dims(cfg)
    B, T, _ = x.shape
    dt_ = x.dtype
    f32 = torch.float32

    proj = torch.matmul(x, params["w_in"].to(dt_))
    z, xBC, dt_raw = torch.split(proj, [d_in, d_in + 2 * N, H], dim=-1)
    xBC, conv_state = _conv1d(xBC, params["conv_w"], params["conv_b"],
                              state.conv)
    xs, Bm, Cm = torch.split(xBC, [d_in, N, N], dim=-1)
    xs = xs.reshape(B, T, H, P)
    dtv = torch.nn.functional.softplus(dt_raw.to(f32) + params["dt_bias"])
    A = -torch.exp(params["A_log"].to(f32))

    args = (xs.to(f32), dtv, A, Bm.to(f32), Cm.to(f32), state.h.to(f32))
    if impl == "scan" or T == 1 or T % cfg.ssm.chunk_size != 0:
        y, h_end = ssd_scan(*args)
    else:
        y, h_end = ssd_chunked(*args, chunk=cfg.ssm.chunk_size)
    y = y + params["D"][None, None, :, None] * xs.to(f32)
    y = y.reshape(B, T, d_in).to(dt_)
    # gated RMSNorm
    y = y * torch.nn.functional.silu(z)
    var = torch.mean(torch.square(y.to(f32)), -1, keepdim=True)
    y = (y.to(f32) * torch.rsqrt(var + 1e-5)).to(dt_)
    y = y * params["norm_g"].to(dt_)
    out = torch.matmul(y, params["w_out"].to(dt_))
    return out, MambaState(h_end.to(state.h.dtype), conv_state)


def init_mamba_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> MambaState:
    d_in, H, P, N, W = _dims(cfg)
    return MambaState(torch.zeros((batch, H, N, P), dtype=dtype,
                                  device=device),
                      torch.zeros((batch, W - 1, d_in + 2 * N), dtype=dtype,
                                  device=device))
