"""OLMoE-1B-7B — 16L d_model=2048 16H (kv=16) expert d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024,
                  dispatch_impl="dcra"),
    source="arXiv:2409.02060",
)
