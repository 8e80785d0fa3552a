"""Seconds of the port's host packing and resident copy of the graph
(``_graph_setup`` + ``resident_setup``), a span around the calls: part
of ``setup_s``."""


def read(run):
    spans = run.spans.samples.get("pack")
    return float(sum(spans)) if spans else None
