"""The scoring kernels' share of their roofline: the summed bound of the
scoring work of every batch scored in the traced window
(``harness/roofline.py``: distinct arena rows read, terms read, counts
written, over the card's published peaks) over the device time of the
program's scoring kernels in the trace (``kernels/bitslice_score.py``).
Nothing without a card or a peak for it."""

from cobsbench.harness import devtrace

UNIT = "%"
LAYER = "kernels (kernels/bitslice_score.py)"
MOVES = "queries_per_s"
SOURCE = "device_trace"


def read(run):
    if not run.on_card or run.trace is None or run.roofline is None:
        return None
    t = devtrace.score_kernel_s(run.trace)
    return 100.0 * run.roofline["bound_s"] / t if t > 0 else None
