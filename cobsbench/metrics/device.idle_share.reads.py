"""The share of the traced window in which nothing ran on the card: one
minus the union of all kernel, copy and set intervals of the profiler's
trace, over the window."""

from cobsbench.harness import devtrace

UNIT = "%"
LAYER = "device"
MOVES = "queries_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.on_card or run.trace is None:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(run.trace) / run.trace.window_s)
