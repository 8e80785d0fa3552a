"""Device milliseconds a ``moe_dcra`` call in its ``moe.route`` span (the
router, softmax, top-k and gates, the buckets and the row gathers before
the expert FFN; CUDA events), less the ``wire`` spans inside it."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    calls = port_spans.roots(recs, "moe")
    spans = port_spans.in_roots(port_spans.named(recs, "moe.route"), calls)
    return port_spans.per_root(port_spans.device_ms(recs, spans, own=True),
                               calls)
