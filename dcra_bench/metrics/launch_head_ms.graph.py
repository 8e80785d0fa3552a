"""Host milliseconds a launch spends in the port's ``launch.init`` (the
states made in numpy and laid out by owner) and ``launch.stage`` (edges
and states copied onto the card through pinned staging) spans: the head
of a launch, before its first round."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    head = sum(r.host_ms for r in port_spans.named(
        recs, "launch.init", "launch.stage"))
    return port_spans.per_root(head, port_spans.roots(recs, "launch"))
