"""Training launcher, as the JAX package's ``repro.launch.train``, plus
``--device`` (the CUDA card by default, ``cpu`` to run on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/run1

One process drives the whole stack: config -> state -> train step (the
state updated in place) -> async checkpoints -> crash-safe resume. The
activation rules of ``launch/sharding.py`` are installed over the port's
mesh (``--mesh 1,2`` names data and model axes), where a MoE config with
``dispatch="local"`` takes its per-data-shard dispatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from ..checkpoint import AsyncCheckpointer, CheckpointManager
from ..device import resolve_device
from ..models import build_model
from ..models.partition import partitioning
from ..train import AdamWConfig, make_init_state, make_train_step
from . import sharding as shd
from .mesh import make_mesh


def synthetic_batch(step: int, vocab: int, batch: int, seq: int):
    """Deterministic step-indexed data (replays identically after restart);
    JAX's draws, as int32 CPU tensors."""
    rng = np.random.default_rng(step)
    toks = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient accumulation steps")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '4,2' => data=4, model=2 (positions of one "
                         "device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to "
                         "run on the CPU)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = configs.get(args.arch, smoke=args.smoke)
    model = build_model(cfg, device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                      total_steps=args.steps)

    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        mesh = make_mesh(shape, ("data", "model")[:len(shape)], device)
    else:
        mesh = make_mesh((1,), ("data",), device)

    init = make_init_state(model, opt)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches)
    with partitioning(mesh, shd.act_rules_for(mesh)):
        state = init(torch.Generator(device=device).manual_seed(0))
        start = 0
        mgr = ckpt = None
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir)
            ckpt = AsyncCheckpointer(mgr)
            try:
                state, start = mgr.restore(state)
                start += 1
                print(f"resumed from step {start - 1}")
            except FileNotFoundError:
                pass

        t0 = time.time()
        tokens_done = 0
        for step in range(start, args.steps):
            batch = synthetic_batch(step, cfg.vocab, args.batch, args.seq)
            state, metrics = step_fn(state, batch)
            tokens_done += args.batch * args.seq
            if step % 10 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"acc {float(metrics['accuracy']):.3f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"tok/s {tokens_done / max(dt, 1e-9):,.0f}")
            if ckpt and ((step + 1) % args.ckpt_every == 0
                         or step == args.steps - 1):
                ckpt.save(step, state)
        if ckpt:
            ckpt.wait()
        print("done")


if __name__ == "__main__":
    main()
