"""Store bytes a paged batch moved to the card per answered request: the
tile cache's staged bytes (``DeviceTileCache.raw_bytes_staged``) plus the
rows the row-gather route read on the host (``serve_tile_gathered_bytes_
total``), over the window, over the requests answered in it
(``core/arena.py``, ``core/query.py``). Nothing where the program has no
row-gather route."""

UNIT = "B/query"
LAYER = "tile cache (core/arena.py, core/query.py)"
MOVES = "queries_per_s"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    staged, gathered = (c.get("tile_raw_bytes_staged"),
                        c.get("tile_gathered_bytes"))
    if staged is None or gathered is None or not c.get("served"):
        return None
    return (staged + gathered) / c["served"]
