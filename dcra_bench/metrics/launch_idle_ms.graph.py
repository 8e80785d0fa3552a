"""Device idle milliseconds a launch inside the port's ``launch.init``,
``launch.stage`` and ``result`` spans: each span's interval less the
union of the traced device operations' intervals, both on the
profiler's clock (``time.time_ns()``), over the window's launches."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None or run.trace.busy_s <= 0:
        return None
    spans = port_spans.named(recs, "launch.init", "launch.stage", "result")
    idle = port_spans.idle_ns([(r.start_ns, r.end_ns) for r in spans],
                              run.trace.events)
    return port_spans.per_root(idle * 1e-6,
                               port_spans.roots(recs, "launch"))
