"""The histogram kernel: int32 counts of int32 ids per bin.

Counterpart of ``repro/kernels/histogram.py`` (``histogram_pallas``).
On a CUDA tensor :func:`histogram` launches the hand-written kernel
(``csrc/histogram.cu``) and adds one to ``LAUNCHES["histogram"]``; on a
CPU tensor it runs :func:`plain_histogram`. Any other device raises.
"""
from __future__ import annotations

import torch

from .route import _check, _on_cuda, _raise_on, _stream

#: kernel launches since the last reset (chip_smoke reads this)
LAUNCHES = {"histogram": 0}


def reset_launches() -> None:
    LAUNCHES["histogram"] = 0


def plain_histogram(elements: torch.Tensor, n_bins: int) -> torch.Tensor:
    """``bincount`` of the ids in ``[0, n_bins)``; ids outside match no
    bin, as in the TPU kernel (negative ids never equal a bin, ids past
    the last bin fall into the sliced-off pad): [n_bins] int32."""
    ids = elements.long()
    ids = ids[(ids >= 0) & (ids < n_bins)]
    return torch.bincount(ids, minlength=n_bins)[:n_bins].to(torch.int32)


def histogram(elements: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Counts per bin of ``elements [N]`` int32: ``[n_bins]`` int32. Ids
    below 0 or from ``n_bins`` on are skipped."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1, got {n_bins}")
    if not _on_cuda(elements):
        return plain_histogram(elements, n_bins)
    if elements.dim() != 1:
        raise ValueError(f"elements must be [N], got {tuple(elements.shape)}")
    _check(elements, "elements", torch.int32, elements.shape,
           elements.device)
    out = torch.zeros(n_bins, dtype=torch.int32, device=elements.device)
    if elements.numel() == 0:
        return out
    from ._build import library
    _raise_on(library("histogram").dcra_histogram(
        elements.data_ptr(), elements.numel(), n_bins, out.data_ptr(),
        _stream(elements.device)), "histogram")
    LAUNCHES["histogram"] += 1
    return out
