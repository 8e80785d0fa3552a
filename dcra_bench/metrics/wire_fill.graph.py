"""The wire's filled share, in percent: the tasks the window's launches
kept (messages less drops, the port's ``AppStats``) over the slots their
exchanges moved (the port's ``wire_slots`` counter: shards times rows
of every exchange)."""
from dcra_bench import port_spans


def read(run):
    counters = port_spans.window_counters(run)
    slots = (counters or {}).get("wire_slots")
    if not slots or "messages" not in run.work:
        return None
    kept = sum(int(m) - int(d)
               for ms, ds in zip(run.work["messages"], run.work["drops"])
               for m, d in zip(ms, ds))
    return 100.0 * kept / slots
