"""Device milliseconds a ``moe_dcra`` call in its ``moe.ffn`` span (the
experts' gate, up and down matmuls over the capacity-padded buckets and
the SwiGLU; CUDA events)."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    calls = port_spans.roots(recs, "moe")
    spans = port_spans.in_roots(port_spans.named(recs, "moe.ffn"), calls)
    return port_spans.per_root(port_spans.device_ms(recs, spans), calls)
