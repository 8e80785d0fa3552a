"""Zamba2-7B — 81L d_model=3584, Mamba2 blocks + shared attention blocks
(32H GQA kv=32) applied periodically, d_ff=14336 vocab=32000 ssm_state=64.
[arXiv:2411.15242; unverified]"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, head_dim=64, chunk_size=256, expand=2),
    hybrid_attn_period=6,     # shared attn block every 6 mamba layers
    accum_steps=8,
    source="arXiv:2411.15242",
)
