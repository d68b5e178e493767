"""Host time the row-gather route spent reading a paged batch's rows out
of the mapped store, per answered request: the sum of
``serve_tile_gather_seconds`` over the window, over the requests answered
in it (``core/query.py``). Nothing where the program has no row-gather
route."""

UNIT = "us/query"
LAYER = "tile cache (core/arena.py, core/query.py)"
MOVES = "queries_per_s"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    if c.get("tile_gather_s") is None or not c.get("served"):
        return None
    return 1e6 * c["tile_gather_s"] / c["served"]
