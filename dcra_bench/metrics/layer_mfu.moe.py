"""The MoE layers' share of the card's bf16 peak, in percent: the model
FLOPs of the window's steps over the window times 989e12 FLOP/s (H100
SXM, dense bf16, NVIDIA's data sheet, 700 W). A layer's model FLOPs are
the router's ``2 T D E`` and the experts' ``6 T K D F`` over the ``T K``
routed assignments (three matmuls of ``2 D F`` an assignment); the
padding of the experts' capacity is waste, not work."""

BF16_FLOP_PER_S = 989e12


def step_flops(tokens: int, d: int, e: int, k: int, f: int) -> int:
    return 2 * tokens * d * e + 6 * tokens * k * d * f


def read(run):
    w, c = run.work, run.config
    if not w.get("steps") or not w.get("window_s"):
        return None
    flops = w["steps"] * w["layers"] * step_flops(
        w["tokens"], c["hidden_size"], c["num_experts"],
        c["num_experts_per_tok"], c["intermediate_size"])
    return 100.0 * flops / (w["window_s"] * BF16_FLOP_PER_S)
