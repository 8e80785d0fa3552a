"""Device milliseconds a round in the port's ``wire`` spans (packing, the
exchange and the receiver's columns; CUDA events, outermost spans only),
over the ``round`` spans of the window's launches."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    return port_spans.per_root(
        port_spans.device_ms(recs, port_spans.outermost(recs, "wire")),
        port_spans.named(recs, "round"))
