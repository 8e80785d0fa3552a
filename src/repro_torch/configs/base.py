"""Architecture and shape configuration (counterpart of
``repro/configs/base.py``: ``ShapeConfig`` and the shape cells :23-44,
``MoEConfig`` :52, ``SSMConfig`` :64, ``ArchConfig`` :74).

A copy, not an import: the port imports nothing of ``repro``. Every
assigned architecture gets one module in this package exporting
``CONFIG: ArchConfig`` with the published dimensions; ``reduced()``
gives a tiny same-family config for the CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                      # per-expert FFN hidden dim
    capacity_factor: float = 1.25      # DCRA: the IQ size knob (Table II #8)
    # 'einsum': dense dispatch/combine masks; 'dcra': owner-routed dispatch
    dispatch_impl: str = "einsum"
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) / RWKV6 recurrence parameters."""
    state_dim: int = 64
    head_dim: int = 64
    chunk_size: int = 256
    conv_width: int = 4
    expand: int = 2


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int                     # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    sliding_window: int = 0            # 0 = full attention; >0 = SWA window
    rope_theta: float = 1e4
    mrope: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0
    encoder_layers: int = 0
    frontend: str = "none"
    source: str = ""
    remat: str = "block"
    scan_layers: bool = True
    accum_steps: int = 1

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k decode cell?"""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks)."""
        d, v = self.d_model, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        total = emb
        n_dec = self.num_layers
        for _ in range(n_dec):
            total += self._block_params(d, hd)
        if self.family == "hybrid":
            # the shared attention+MLP block is counted once
            q = d * hd * self.num_heads
            kv = 2 * d * hd * self.num_kv_heads
            o = hd * self.num_heads * d
            total += q + kv + o + 3 * d * self.d_ff
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += self._block_params(d, hd)
            total += n_dec * (d * hd * self.num_heads
                              + 2 * d * hd * self.num_kv_heads
                              + hd * self.num_heads * d)
        return total

    def _block_params(self, d: int, hd: int) -> int:
        p = 2 * d  # norms
        if self.family == "ssm":
            p += 4 * d * d + d * 64 * 2 + 3 * d * self.d_ff
            return p
        if self.family == "hybrid":
            ss = self.ssm or SSMConfig()
            d_in = ss.expand * d
            n_heads = d_in // ss.head_dim
            p += d * (2 * d_in + 2 * ss.state_dim + n_heads)
            p += ss.conv_width * (d_in + 2 * ss.state_dim)
            p += d_in * d
            return p
        q = d * hd * self.num_heads
        kv = 2 * d * hd * self.num_kv_heads
        o = hd * self.num_heads * d
        p += q + kv + o
        if self.moe is not None:
            p += (self.moe.num_experts * 3 * d * self.moe.d_expert
                  + d * self.moe.num_experts)
        else:
            p += 3 * d * self.d_ff
        return p

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        inactive = (self.num_layers * (self.moe.num_experts - self.moe.top_k)
                    * 3 * self.d_model * self.moe.d_expert)
        return self.param_count() - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: 2 layers, narrow dims, small vocab."""
        kw = {}
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kvh = (min(self.num_kv_heads, max(1, heads // 2))
               if self.num_kv_heads else 0)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=64)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, state_dim=16,
                                            head_dim=16, chunk_size=32)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=16 if heads else 0,
            d_ff=128,
            vocab_size=256,
            sliding_window=(min(self.sliding_window, 16)
                            if self.sliding_window else 0),
            encoder_layers=2 if self.encoder_layers else 0,
            hybrid_attn_period=2 if self.hybrid_attn_period else 0,
            scan_layers=False,
            **kw,
        )

    def shape_cells(self) -> Tuple[ShapeConfig, ...]:
        """The shape cells this arch runs: long_500k only where attention
        is sub-quadratic."""
        cells = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.sub_quadratic:
            cells.append(LONG_500K)
        return tuple(cells)
