"""Qwen2-VL-7B backbone — 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064, M-RoPE. Vision frontend is a STUB: input_specs provides
precomputed patch embeddings + 3D M-RoPE position ids.
[arXiv:2409.12191; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    mrope=True,
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    source="arXiv:2409.12191",
)
