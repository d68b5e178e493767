"""Entry: a closed loop through ``ServingLoop.submit`` over ``QueryServer``,
in process — the pipeline that embeds the index (read classification,
contamination screening), taking its reads a chunk at a time.

The pipeline takes the next ``chunk`` queries of the pool (DNA strings,
round the pool again once it is used up), compiles them to terms with
the library's ``compile_pattern`` (as ``NetClient`` does on its side of
the wire), submits the chunk at
once, waits for all its answers, then takes the next chunk, until
``--seconds`` have passed. The window then closes when the last chunk is
answered, so it holds whole chunks only. Every chunk starts from an idle
server, so a run is an average over many alike chunks.

End-to-end metric: ``queries_per_s``, the requests answered over the
window's length (from the first request sent to the last answer).
"""
from __future__ import annotations

import threading
import time

from cobsbench.harness import session, traffic

ANSWER_WAIT_S = 60.0


def _chunks(loop, q: traffic.Queries, threshold: float, chunk: int,
            seconds: float, params) -> tuple[list, float, int]:
    """Send the pool a chunk at a time, each chunk once the last one is
    answered, until ``seconds`` have passed, going round the pool as often
    as the time allows; returns ([(request, answered_at, response)],
    window start, requests sent). Request ``i`` sends the pool's query
    ``traffic.pool_index(i, len(q))``."""
    from repro_torch.core.query import compile_pattern
    got: list = []
    t0 = time.monotonic()
    t_end = t0 + seconds
    sent = 0
    while time.monotonic() < t_end:
        left = [chunk]
        lock = threading.Lock()
        done = threading.Event()

        def on_done(resp, i) -> None:
            got.append((i, time.monotonic(), resp))
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    done.set()

        terms = [compile_pattern(q.seqs[traffic.pool_index(i, len(q))],
                                 params)
                 for i in range(sent, sent + chunk)]
        for i, t in zip(range(sent, sent + chunk), terms):
            loop.submit(terms=t, threshold=threshold,
                        on_done=lambda resp, i=i: on_done(resp, i))
        sent += chunk
        if not done.wait(ANSWER_WAIT_S):
            break
    return list(got), t0, sent


def run(ctx: session.Context) -> session.Run:
    from repro_torch.serve import ServingLoop
    from repro_torch.serve.request import Status
    corp = ctx.corpus()
    index = ctx.build_index()
    server = ctx.server(index)
    rec = session.Recorder(server, ctx.trace)
    loop = ServingLoop(server).start()
    try:
        chunk = int(ctx.mix["chunk"])
        warm = traffic.make_queries(ctx.mix, corp, ctx.seed, traffic.WARMUP,
                                    traffic.pool(ctx.mix, traffic.WARMUP))
        _chunks(loop, warm, ctx.threshold, chunk, float(ctx.mix["warmup_s"]),
                index.params)
        q = traffic.make_queries(ctx.mix, corp, ctx.seed, traffic.WINDOW,
                                 traffic.pool(ctx.mix, traffic.WINDOW))
        server.reset_metrics(clear_caches=True)
        win = session.Window(ctx, rec)
        ctx.setup_done()
        with win.open():
            got, t0, sent = _chunks(loop, q, ctx.threshold, chunk,
                                    ctx.seconds, index.params)
        counters = session.program_counters(server)
        answers = {i: session.answer_of(r.result) for i, _, r in got
                   if r.status == Status.OK}
        window_s = max((t for _, t, _ in got), default=t0) - t0
        run = session.Run(
            window_s=window_s, queries=q, n_requests=sent, answers=answers,
            e2e={"queries_per_s": len(answers) / window_s},
            counters=counters, on_card=ctx.on_card,
            device_name=session.device_name(ctx.device),
            trace=win.trace, info={"window_s": window_s})
        if ctx.trace and ctx.on_card:
            run.roofline = session.roofline_of(rec.batches, index,
                                               ctx.device, run.device_name)
        return run
    finally:
        loop.stop()

