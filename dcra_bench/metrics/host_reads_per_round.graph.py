"""Blocking host reads a round: the port's ``program.HOST_READS`` counter
over the window, over the rounds of the window's launches (the port's
``AppStats.rounds``)."""


def read(run):
    rounds = run.counters.get("rounds")
    if not rounds or "host_reads" not in run.counters:
        return None
    return run.counters["host_reads"] / rounds
