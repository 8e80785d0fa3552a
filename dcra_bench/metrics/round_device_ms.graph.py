"""Device milliseconds a round: the union of the device operations'
intervals over the traced window, over the rounds of the window's
launches."""


def read(run):
    rounds = run.counters.get("rounds")
    if run.trace is None or not rounds or run.trace.busy_s <= 0:
        return None
    return 1e3 * run.trace.busy_s / rounds
