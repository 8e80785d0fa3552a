"""Analytic FLOP / HBM-byte accounting per (arch x shape) (counterpart of
``repro/launch/analytic.py:27-149``, formula for formula).

The roofline's compute and memory terms come from these closed forms:
the port has no compiled cost to read (torch keeps no XLA HLO), and the
reference takes its terms from the same formulas because XLA's cost
analysis counts a ``while`` body once, not once a trip.

Conventions: matmul [M,K]x[K,N] = 2MKN flops. Train = fwd + 2x bwd (+1
fwd recompute when remat is not 'none'). MoE einsum dispatch processes
padded capacity (x capacity_factor dead compute); DCRA dispatch
processes ~the routed tokens only, so the paper technique's win shows
up in the MODEL_FLOPS ratio.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ArchConfig, ShapeConfig
from ..models.transformer import padded_vocab


@dataclass
class CostEstimate:
    flops: float            # global, per step
    hbm_bytes: float        # global, per step


def _attn_layer_flops(cfg: ArchConfig, B: int, S: int, kv_len: float) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    proj = 2 * B * S * d * hd * (H + 2 * Hkv) + 2 * B * S * H * hd * d
    scores = 2 * B * S * kv_len * H * hd * 2          # QK^T + PV
    return proj + scores


def _kv_len(cfg: ArchConfig, S: int, decode: bool) -> float:
    full = S if decode else S / 2.0                    # causal average
    if cfg.sliding_window:
        return min(full, cfg.sliding_window)
    return full


def _ffn_layer_flops(cfg: ArchConfig, B: int, S: int) -> float:
    d = cfg.d_model
    if cfg.moe is not None:
        mc = cfg.moe
        router = 2 * B * S * d * mc.num_experts
        pad = (mc.capacity_factor if mc.dispatch_impl == "einsum" else 1.0)
        return router + 6 * B * S * d * mc.d_expert * mc.top_k * pad
    return 6 * B * S * d * cfg.d_ff


def _rwkv_layer_flops(cfg: ArchConfig, B: int, S: int) -> float:
    d, hd = cfg.d_model, cfg.ssm.head_dim
    proj = 2 * B * S * d * d * 5                       # r,k,v,g,o
    lora = 2 * B * S * d * 64 * 2
    wkv = 4 * B * S * d * hd                           # state update + read
    cmix = 2 * B * S * d * cfg.d_ff * 2 + 2 * B * S * d * d
    return proj + lora + wkv + cmix


def _mamba_layer_flops(cfg: ArchConfig, B: int, S: int) -> float:
    d = cfg.d_model
    ss = cfg.ssm
    d_in = ss.expand * d
    H = d_in // ss.head_dim
    N, P = ss.state_dim, ss.head_dim
    conv_dim = d_in + 2 * N
    proj = 2 * B * S * d * (2 * d_in + 2 * N + H) + 2 * B * S * d_in * d
    conv = 2 * B * S * ss.conv_width * conv_dim
    L = min(ss.chunk_size, S)
    intra = 2 * B * S * L * H * P + 2 * B * S * L * N  # y_intra + CB^T
    state = 4 * B * S * N * H * P                      # carry + inter
    return proj + conv + intra + state


def forward_flops(cfg: ArchConfig, B: int, S: int, decode: bool = False
                  ) -> float:
    kv = _kv_len(cfg, S if not decode else S, decode)
    head = 2 * B * (1 if decode else S) * cfg.d_model * padded_vocab(
        cfg.vocab_size)
    Sq = 1 if decode else S
    total = head
    if cfg.family == "ssm":
        total += cfg.num_layers * _rwkv_layer_flops(cfg, B, Sq)
        return total
    if cfg.family == "hybrid":
        total += cfg.num_layers * _mamba_layer_flops(cfg, B, Sq)
        n_attn = cfg.num_layers // cfg.hybrid_attn_period
        total += n_attn * (_attn_layer_flops(cfg, B, Sq, kv)
                           + 6 * B * Sq * cfg.d_model * cfg.d_ff)
        return total
    if cfg.family == "encdec":
        s_src = min(S // 2, 4096) if not decode else 4096
        s_tgt = (S - s_src) if not decode else 1
        enc = cfg.encoder_layers * (_attn_layer_flops(cfg, B, s_src, s_src)
                                    + _ffn_layer_flops(cfg, B, s_src))
        dec = cfg.num_layers * (
            _attn_layer_flops(cfg, B, s_tgt, _kv_len(cfg, S, decode))
            + _attn_layer_flops(cfg, B, s_tgt, s_src)   # cross
            + _ffn_layer_flops(cfg, B, s_tgt))
        if decode:
            enc = 0.0                                   # encoder ran at prefill
        return enc + dec + 2 * B * s_tgt * cfg.d_model * \
            padded_vocab(cfg.vocab_size)
    # dense / moe / vlm decoder
    total += cfg.num_layers * (_attn_layer_flops(cfg, B, Sq, kv)
                               + _ffn_layer_flops(cfg, B, Sq))
    return total


def step_cost(cfg: ArchConfig, shape: ShapeConfig) -> CostEstimate:
    B, S = shape.global_batch, shape.seq_len
    decode = shape.is_decode
    f_fwd = forward_flops(cfg, B, S, decode=decode)
    n_params = cfg.param_count()

    if shape.kind == "train":
        remat_fwd = 1.0 if cfg.remat != "none" else 0.0
        flops = f_fwd * (3.0 + remat_fwd)
        # HBM: params bf16 fwd+bwd reads + fp32 grads/adam state rw +
        # per-layer saved residuals (write + 2 reads) + logits
        act = cfg.num_layers * B * S * cfg.d_model * 2 * 3
        hbm = n_params * (2 * 2 + 4 * 5) + act + \
            B * S * padded_vocab(cfg.vocab_size) * 4 * 2
        return CostEstimate(flops, hbm)
    if shape.kind == "prefill":
        act = cfg.num_layers * B * S * cfg.d_model * 2 * 2
        return CostEstimate(f_fwd, cfg.active_param_count() * 2 + act)
    # decode: read all active params + the KV cache / states per token
    hd = cfg.resolved_head_dim
    cache_len = min(S, cfg.sliding_window) if cfg.sliding_window else S
    kv_bytes = (cfg.num_layers * B * cache_len * cfg.num_kv_heads * hd
                * 2 * 2) if cfg.num_heads else 0
    if cfg.family == "ssm":
        d = cfg.d_model
        kv_bytes = cfg.num_layers * B * (d // hd) * hd * hd * 4 * 2
    if cfg.family == "hybrid":
        ss = cfg.ssm
        d_in = ss.expand * cfg.d_model
        H = d_in // ss.head_dim
        n_attn = cfg.num_layers // cfg.hybrid_attn_period
        kv_bytes = (cfg.num_layers * B * H * ss.state_dim * ss.head_dim * 4
                    * 2 + n_attn * B * S * cfg.num_kv_heads * hd * 2 * 2)
    return CostEstimate(f_fwd, cfg.active_param_count() * 2 + kv_bytes)
