"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, as a user runs it: it trains, checkpoints and resumes; it resumes
from a checkpoint the JAX CLI wrote; its ``synthetic_batch`` equals JAX's
exactly; without ``--device`` it wants the card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import synthetic_batch as jax_synthetic_batch

from repro_torch.launch import train
from repro_torch.train.prng import fold_in, prng_key

ROOT = Path(__file__).resolve().parent.parent
ARGS = ("--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq", "16")


def _run(package, *args, device=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", f"{package}.launch.train", *ARGS, *args]
    if device:
        cmd += ["--device", "cpu"]
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def _rng_leaf(step_dir: Path) -> np.ndarray:
    man = json.loads((step_dir / "manifest.json").read_text())
    key = next(m["key"] for m in man["leaves"] if m["name"] == ".rng")
    with np.load(step_dir / "arrays.npz") as z:
        return z[key]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    ck = tmp_path / "ck"
    first = _run("repro_torch", "--ckpt-dir", str(ck), "--steps", "6",
                 "--ckpt-every", "3")
    assert first[-1] == "done"
    assert [ln.split()[1] for ln in first if ln.startswith("step")] == \
        ["0", "5"]
    assert not any(ln.startswith("resumed") for ln in first)
    assert sorted(p.name for p in ck.iterdir()) == ["step_2", "step_5"]
    second = _run("repro_torch", "--ckpt-dir", str(ck), "--steps", "9")
    assert second[0] == "resumed from step 5" and second[-1] == "done"
    step8 = [ln for ln in second if ln.startswith("step")]
    assert len(step8) == 1 and step8[0].split()[1] == "8"
    loss = float(step8[0].split()[3])
    assert np.isfinite(loss)
    # the state's rng went through JAX's fold_in once a step
    want = fold_in(prng_key(0), 17)
    for _ in range(9):
        want = fold_in(want, 1)
    np.testing.assert_array_equal(_rng_leaf(ck / "step_8"), want)


def test_cli_resumes_from_the_jax_cli(tmp_path):
    """The JAX CLI trains 6 steps; the port's resumes its checkpoint."""
    ck = tmp_path / "ck"
    first = _run("repro", "--ckpt-dir", str(ck), "--steps", "6",
                 "--ckpt-every", "3", device=False)
    assert first[-1] == "done"
    second = _run("repro_torch", "--ckpt-dir", str(ck), "--steps", "9")
    assert second[0] == "resumed from step 5" and second[-1] == "done"
    want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(0), 17))
    for _ in range(9):
        want = np.asarray(jax.random.fold_in(want, 1))
    np.testing.assert_array_equal(_rng_leaf(ck / "step_8"), want)


@pytest.mark.parametrize("step", [0, 1, 5, 1234])
def test_synthetic_batch_equal(step):
    want = jax_synthetic_batch(step, 151936, 4, 128)
    got = train.synthetic_batch(step, 151936, 4, 128)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_device_none_means_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train.main(list(ARGS) + ["--steps", "1"])
    assert e.value.code == 2
    assert "CUDA" in capsys.readouterr().err
