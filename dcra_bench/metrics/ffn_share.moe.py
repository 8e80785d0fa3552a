"""The expert FFN's share of the device time, in percent: the device
seconds of the bf16 matrix-multiply kernels (the experts' gate, up and
down projections; the router's float32 matmul is not counted) over the
device seconds of every operation in the traced window."""

GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass")
FLOAT32_MARKS = ("f32f32_f32", "sgemm", "nvjet_sss", "tf32")


def is_expert_gemm(name: str) -> bool:
    low = name.lower()
    return (any(m in low for m in GEMM_MARKS)
            and not any(m in low for m in FLOAT32_MARKS))


def read(run):
    t = run.trace
    if t is None:
        return None
    total = t.device_seconds(lambda name: True)
    ffn = t.device_seconds(is_expert_gemm)
    if total <= 0 or ffn <= 0:
        return None
    return 100.0 * ffn / total
