"""Host time the closed loop's submitter spends compiling a query to its
packed terms (k-mer encoding, packing and dedup): the summed
``repro.compile`` ranges (``core/query.py: compile_pattern``) in the
traced window over the requests answered in it. Like the other readers
of the trace, nothing off the card, nor from a program that opens no
``repro.*`` range."""

from cobsbench.harness import spans

UNIT = "us/query"
LAYER = "entry (core/query.py, serve/loop.py)"
MOVES = "queries_per_s"
SOURCE = "program_span"


def read(run):
    if (not run.on_card or run.trace is None or not run.counters["served"]
            or not spans.present(run.trace)):
        return None
    return 1e6 * spans.summed_s(run.trace, "repro.compile") / \
        run.counters["served"]
