"""Arena rows the query engine's dispatches gathered per answered request:
the kernel profiler's ``bytes_moved`` (rows times the row stride, padding
of the term and query axes included) over the row stride and the
requests answered in the window (``core/query.py``)."""

UNIT = "rows/query"
LAYER = "query engine (core/query.py)"
MOVES = "queries_per_s"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    if not c["served"] or not c["bytes_moved"]:
        return None
    return c["bytes_moved"] / c["row_bytes"] / c["served"]
