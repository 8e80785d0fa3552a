"""Device milliseconds a ``moe_dcra`` call in its outermost ``wire`` spans
(the rows and their int columns packed, exchanged and unpacked, both
ways; CUDA events)."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    calls = port_spans.roots(recs, "moe")
    spans = port_spans.in_roots(port_spans.outermost(recs, "wire"), calls)
    return port_spans.per_root(port_spans.device_ms(recs, spans), calls)
