"""A plain MoE layer: a softmax router over all experts, the top-k experts
of each token (descending, ties to the lower id) with their gates
renormalised over the k, and each expert's SwiGLU FFN run on the tokens
gathered for it, its output added back weighted by the gate.

Routing is computed in float64, so the port's float32 router can only
disagree where two logits lie closer than float32 rounding: a token
whose k-th and (k+1)-th logits lie within ``tie_margin`` is marked and
left out of the comparison. The experts run in float32 with TF32 off,
or, for the control, on inputs rounded to float8 e4m3 (per-tensor
scale), the precision below the bfloat16 the layer is served in.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor, back
    in float32."""
    scale = t.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _swiglu_ffn(xe, wg, wu, wd, fp8: bool):
    q = _fp8 if fp8 else (lambda t: t)
    xe, wg, wu, wd = q(xe), q(wg), q(wu), q(wd)
    h = torch.nn.functional.silu(xe @ wg) * (xe @ wu)
    return q(h) @ wd


def moe_layer(x, router, wg, wu, wd, top_k: int, tie_margin: float,
              fp8: bool = False):
    """``x [..., D]`` -> ``(out [T, D] float32, near_tie [T] bool)`` with
    ``T`` the tokens of ``x`` in order."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        d = x.shape[-1]
        xt = x.reshape(-1, d)
        logits = xt.double() @ router.double()
        order = torch.sort(logits, dim=-1, descending=True, stable=True)
        top = order.indices[:, :top_k]
        near = (order.values[:, top_k - 1] - order.values[:, top_k]
                ) < tie_margin
        probs = torch.softmax(logits, dim=-1)
        gates = torch.gather(probs, 1, top)
        gates = (gates / gates.sum(-1, keepdim=True)).to(torch.float32)
        out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
        for e in range(router.shape[1]):
            tok, k = torch.nonzero(top == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = _swiglu_ffn(xt[tok].float(), wg[e].float(), wu[e].float(),
                            wd[e].float(), fp8)
            out.index_add_(0, tok, y * gates[tok, k][:, None])
        return out, near
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rel_rms(got, want, keep) -> float:
    """``||got - want|| / ||want||`` over the rows ``keep`` (float64)."""
    g = got.reshape(want.shape)[keep].double()
    w = want[keep].double()
    return float(torch.linalg.vector_norm(g - w)
                 / torch.linalg.vector_norm(w).clamp(min=1e-300))


def token_rel_max(got, want, keep) -> float:
    """The widest ``||got_t - want_t|| / ||want_t||`` over the tokens
    ``keep`` (float64): one token altered anywhere shows here."""
    g = got.reshape(want.shape)[keep].double()
    w = want[keep].double()
    num = torch.linalg.vector_norm(g - w, dim=-1)
    den = torch.linalg.vector_norm(w, dim=-1).clamp(min=1e-300)
    return float((num / den).max()) if num.numel() else 0.0
