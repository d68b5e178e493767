"""Time threads waited for the serving loop's one lock: the summed
``repro.loop.lock_wait`` ranges (``serve/loop.py``: an acquisition that
found the lock held) in the traced window over the requests answered in
it. It sums the waits of the threads the profile records; a profile
opened on the submitting thread alone records that thread's waits, not
the dispatcher's or the scoring worker's. Like the other readers of the
trace, nothing off the card, nor from a program that opens no
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
    return 1e6 * spans.summed_s(run.trace, "repro.loop.lock_wait") / \
        run.counters["served"]
