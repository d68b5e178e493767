"""The share of the card's idle time in the traced window that no
program range accounts for: idle time (the window less the union of all
kernel, copy and set intervals, as ``device.idle_share.reads`` takes it)
during which no ``repro.*`` range is open on any host thread the profile
records, over all idle time. Nothing without a card, nor from a program
that opens no ``repro.*`` range."""

from cobsbench.harness import spans

UNIT = "%"
LAYER = "device"
MOVES = "queries_per_s"
SOURCE = "program_span"


def read(run):
    if not run.on_card or run.trace is None:
        return None
    return spans.unnamed_idle_share(run.trace)
