"""Dense SwiGLU FFN (counterpart of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from .common import dense_init, swiglu


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int
             ) -> Dict[str, torch.Tensor]:
    return {
        "wg": dense_init(gen, d_model, (d_ff,)),
        "wu": dense_init(gen, d_model, (d_ff,)),
        "wd": dense_init(gen, d_ff, (d_model,)),
    }


def mlp_block(params, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]; the weights cast to x's type per op."""
    dt = x.dtype
    g = torch.matmul(x, params["wg"].to(dt))
    u = torch.matmul(x, params["wu"].to(dt))
    return torch.matmul(swiglu(g, u), params["wd"].to(dt))
