"""Device milliseconds a ``moe_dcra`` call in its ``moe.combine`` span
(the expert rows scattered back to their slots, the gate-weighted
combine in k order, the aux loss and the output's layout; CUDA events),
less the ``wire`` spans inside it."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    calls = port_spans.roots(recs, "moe")
    spans = port_spans.in_roots(port_spans.named(recs, "moe.combine"),
                                calls)
    return port_spans.per_root(port_spans.device_ms(recs, spans, own=True),
                               calls)
