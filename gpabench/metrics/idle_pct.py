"""The device's idle share of the traced span, %: one less the union of
the device records' intervals over the span from the trace's first
device record to its last."""
from gpabench.harness import trace


def read(run):
    if run.trace is None:
        return None
    busy, span = trace.busy_and_span(run.trace[0])
    if span <= 0:
        return None
    return 100.0 * (1.0 - busy / span)
