"""Host milliseconds a launch spends in the port's ``result`` span
(``ProgramLaunch.result``'s first call: the states copied to the host,
unpacked from owner layout and cast): the inside twin of
``result_ms.graph``."""
from dcra_bench import port_spans


def read(run):
    recs = port_spans.window_records(run)
    if recs is None:
        return None
    results = port_spans.named(recs, "result")
    return port_spans.per_root(sum(r.host_ms for r in results), results)
