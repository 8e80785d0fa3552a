"""RWKV6-7B (Finch) — 32L d_model=4096 attn-free, d_ff=14336 vocab=65536,
data-dependent decay. [arXiv:2404.05892; hf]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=256),
    accum_steps=8,
    source="arXiv:2404.05892",
)
