"""Mixtral 8x22B — 56L d_model=6144 48H (GQA kv=8) expert d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=16384, dispatch_impl="dcra"),
    source="arXiv:2401.04088",
)
