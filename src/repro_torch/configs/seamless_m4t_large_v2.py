"""SeamlessM4T-large-v2 backbone — 24L enc + 24L dec, d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206. Modality frontend is a STUB: input_specs
provides precomputed audio-frame embeddings. [arXiv:2308.11596; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,           # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    rope_theta=10_000.0,
    frontend="audio_frames",
    source="arXiv:2308.11596",
)
