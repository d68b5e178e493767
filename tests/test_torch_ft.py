"""The port's fault tolerance (``repro_torch.ft``) on the CPU: a killed and
restarted run reproduces the clean run's loss trajectory bit for bit,
resumes from its newest checkpoint rather than restarting, re-raises once
its restarts run out; ``ElasticBatchPlan`` equals the JAX package's
exactly for worlds 1 to 32; ``train``, ``checkpoint`` and ``ft`` export
JAX's names.
"""
import numpy as np
import pytest
import torch

from repro.ft import ElasticBatchPlan as JaxPlan

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.ft import ElasticBatchPlan, FailureInjector, run_with_restarts
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_init_state, make_train_step

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_training():
    """qwen3-4b smoke, as ``tests/test_ft.py``: a step-indexed batch."""
    cfg = configs.get("qwen3-4b", smoke=True)
    model = build_model(cfg, "cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40)
    init = make_init_state(model, opt)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, cfg.vocab, (64, 2, 12))
                            .astype(np.int32))

    def init_state():
        return init(torch.Generator().manual_seed(0))

    def step_fn(state, i):
        batch = {"tokens": data[i % 64], "labels": data[i % 64]}
        state, m = step(state, batch)
        return state, {"loss": float(m["loss"])}

    return init_state, step_fn


def test_restart_reproduces_loss_trajectory(tmp_path, tiny_training):
    init_state, step_fn = tiny_training
    _, log_a, restarts_a = run_with_restarts(
        init_state, step_fn, CheckpointManager(tmp_path / "a"),
        total_steps=12, checkpoint_every=4)
    assert restarts_a == 0
    inj = FailureInjector(fail_at={5, 9})
    state_b, log_b, restarts_b = run_with_restarts(
        init_state, step_fn, CheckpointManager(tmp_path / "b"),
        total_steps=12, checkpoint_every=4, injector=inj)
    assert restarts_b == 2
    clean = {m["step"]: m["loss"] for m in log_a}
    crashed = {}
    for m in log_b:            # later entries (post-restart) overwrite
        crashed[m["step"]] = m["loss"]
    assert set(crashed) == set(clean)
    for s in clean:
        assert clean[s] == crashed[s], f"divergence at step {s}"
    assert int(state_b.step) == 12


def test_restart_resumes_not_restarts(tmp_path, tiny_training):
    """After a crash at step 5 with checkpoint_every=4, the rerun begins at
    step 4, not step 0."""
    init_state, step_fn = tiny_training
    inj = FailureInjector(fail_at={5})
    _, log, _ = run_with_restarts(init_state, step_fn,
                                  CheckpointManager(tmp_path / "c"),
                                  total_steps=8, checkpoint_every=4,
                                  injector=inj)
    steps = [m["step"] for m in log]
    assert steps.count(0) == 1          # step 0 executed exactly once
    assert steps.count(4) == 2          # step 4 replayed after restore


def test_injector_exhausts_restarts(tmp_path, tiny_training):
    init_state, step_fn = tiny_training
    inj = FailureInjector(fail_at={1})
    with pytest.raises(RuntimeError, match="injected failure at step 1"):
        run_with_restarts(init_state, step_fn,
                          CheckpointManager(tmp_path / "d"), total_steps=4,
                          checkpoint_every=2, injector=inj, max_restarts=0)


@pytest.mark.parametrize("world", range(1, 33))
def test_elastic_plan_equal(world):
    for batch in (256, 64, 37, world):
        want, got = JaxPlan(batch, world), ElasticBatchPlan(batch, world)
        assert got.per_replica == want.per_replica
        for step in (0, 5, 17):
            for r in range(world):
                w, g = want.indices_for(r, step), got.indices_for(r, step)
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            assert got.coverage_ok(step) == want.coverage_ok(step) is True
    with pytest.raises(ValueError):
        ElasticBatchPlan(64, world).indices_for(world, 0)


def test_elastic_resize_preserves_global_batch():
    """Scaling 32 -> 24 replicas mid-run: same global examples per step."""
    a, b = ElasticBatchPlan(256, 32), ElasticBatchPlan(256, 24)
    ga = sorted(i for r in range(32) for i in a.indices_for(r, 5) if i >= 0)
    gb = sorted(i for r in range(24) for i in b.indices_for(r, 5) if i >= 0)
    assert ga == gb


@pytest.mark.parametrize("pkg,port_only", [
    ("train", {"state_from_numpy"}), ("checkpoint", set()), ("ft", set())])
def test_exports_equal_jax(pkg, port_only):
    """The training packages export JAX's names (the port's train/ also
    ``state_from_numpy``, which carries a JAX state across)."""
    import importlib
    port = importlib.import_module(f"repro_torch.{pkg}")
    ref = importlib.import_module(f"repro.{pkg}")
    assert set(port.__all__) - port_only == set(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name
