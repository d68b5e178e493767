"""Mean requests per scored batch in the in-process server: what the
micro-batcher (``serve/server.py``, ``serve/batcher.py``) coalesces out of
the requests in flight. The server's own counters (``ServingMetrics``)."""

UNIT = "requests/batch"
LAYER = "server (serve/server.py, serve/batcher.py)"
MOVES = "queries_per_s"
SOURCE = "program_counter"


def read(run):
    c = run.counters
    return c["batched_requests"] / c["batches"] if c["batches"] else None
