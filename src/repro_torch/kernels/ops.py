"""Public wrappers of the port's leaf kernels (counterpart of
``repro/kernels/ops.py``). Each runs its hand-written CUDA kernel on a
CUDA tensor and its plain PyTorch version on a CPU tensor.

``gmm`` and ``flash_attention`` are not here yet: they come with the LM
slice (``ROADMAP.md`` queue 1, item 11).
"""
from __future__ import annotations

from .histogram import histogram
from .spmv import bsr_spmv, csr_to_bsr, spmv_csr

__all__ = ["histogram", "bsr_spmv", "csr_to_bsr", "spmv_csr"]
