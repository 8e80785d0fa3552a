"""Host milliseconds a launch spends inside ``ProgramLaunch.result()``
once ``block()`` has returned: the copy of the states to the host and
their unpacking, mean over the window's launches."""


def read(run):
    spans = run.spans.samples.get("result")
    return 1e3 * sum(spans) / len(spans) if spans else None
