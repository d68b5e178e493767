"""Fault-tolerant checkpointing, in the JAX package's layout
(``repro-ckpt-v1``): each package reads what the other writes.

  * a checkpoint is a directory ``step_<N>/`` holding ``arrays.npz`` (one
    array a tree leaf) and ``manifest.json`` (each leaf's name, key, shape,
    dtype and a blake2b hash of its bytes); restore verifies every hash;
  * leaves are named as JAX's ``tree_flatten_with_path`` names them: dict
    keys sorted, a list index by its number, a NamedTuple field with a
    leading dot (a ``TrainState`` gives ``.step``, ``.params/...``,
    ``.opt_state/count``, ``.opt_state/mu/...`` and ``.rng``);
  * a bfloat16 leaf is stored as 2-byte void (``|V2``, what ``np.savez``
    writes for JAX's bfloat16) with ``"bfloat16"`` in the manifest, and
    read back through an int16 view;
  * writes are atomic: everything lands in ``step_<N>.tmp/`` and is renamed
    after an fsync, so a crash mid-write never corrupts the newest step;
  * ``AsyncCheckpointer`` copies the tree to the host on the caller's
    thread and writes it on a worker thread, one save in flight;
  * retention keeps the last N steps, deleting older ones only after a new
    save committed.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

FORMAT = "repro-ckpt-v1"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=(), is_leaf=None):
    """(name path, leaf) pairs in JAX's leaf order. None is an empty
    subtree, as in JAX; a node that ``is_leaf`` accepts is a leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(path, tree)]
    return [pair for name, v in items
            for pair in _flatten(v, path + (name,), is_leaf)]


def _unflatten(tree, leaves):
    """``tree``'s structure over ``leaves`` (in ``_flatten``'s order)."""
    it = iter(leaves)

    def go(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: go(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(go(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return next(it)
    return go(tree)


def _leaf_paths(tree):
    return [("/".join(p) or "root", leaf) for p, leaf in _flatten(tree)]


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array that is saved: a bfloat16 tensor as |V2."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2")
        return t.cpu().numpy()
    return np.asarray(leaf)


def _host_copy(leaf):
    """A copy of a leaf in host memory that no later write reaches."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    return np.array(leaf, copy=True)


def _dtype_name(leaf, a: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def _hash(a: np.ndarray) -> str:
    return hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest()


def save_pytree(tree, path: str | Path) -> None:
    """Atomic single-host save of a tree of tensors or arrays."""
    path = Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"leaves": [], "format": FORMAT}
    arrays = {}
    for i, (name, leaf) in enumerate(_leaf_paths(tree)):
        a = _to_numpy(leaf)
        key = f"a{i}"
        arrays[key] = a
        manifest["leaves"].append({
            "name": name, "key": key, "shape": list(a.shape),
            "dtype": _dtype_name(leaf, a), "hash": _hash(a)})
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    fd = os.open(tmp, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    if path.exists():
        shutil.rmtree(path)
    os.rename(tmp, path)


def _restore_leaf(a: np.ndarray, dtype: str, like):
    """The saved array as the template leaf's kind: a tensor on the
    template's device (bfloat16 through an int16 view), else numpy."""
    if not isinstance(like, torch.Tensor):
        return a
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device)


def load_pytree(template, path: str | Path):
    """Restore into the structure of ``template`` (shapes checked, hashes
    verified). A tensor leaf of the template comes back as a tensor on its
    device, a numpy leaf as numpy."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unknown checkpoint format at {path}")
    by_name = {m["name"]: m for m in manifest["leaves"]}
    out = []
    with np.load(path / "arrays.npz") as z:
        for name, leaf in _leaf_paths(template):
            m = by_name.get(name)
            if m is None:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            a = z[m["key"]]
            if _hash(a) != m["hash"]:
                raise IOError(f"checkpoint corruption in leaf {name!r}")
            want_shape = tuple(getattr(leaf, "shape", a.shape))
            if tuple(a.shape) != want_shape:
                raise ValueError(
                    f"leaf {name!r}: checkpoint shape {a.shape} != "
                    f"expected {want_shape}")
            out.append(_restore_leaf(a, m["dtype"], leaf))
    return _unflatten(template, out)


_STEP_RE = re.compile(r"^step_(\d+)$")


def latest_step(root: str | Path) -> int | None:
    root = Path(root)
    if not root.exists():
        return None
    steps = [int(m.group(1)) for p in root.iterdir()
             if (m := _STEP_RE.match(p.name)) and (p / "manifest.json").exists()]
    return max(steps) if steps else None


class CheckpointManager:
    """Step-indexed checkpoints with retention + resume."""

    def __init__(self, root: str | Path, keep_last: int = 3):
        self.root = Path(root)
        self.keep_last = keep_last
        self.root.mkdir(parents=True, exist_ok=True)

    def path(self, step: int) -> Path:
        return self.root / f"step_{step}"

    def save(self, step: int, tree) -> Path:
        p = self.path(step)
        save_pytree(tree, p)
        self._gc()
        return p

    def restore(self, template, step: int | None = None):
        step = step if step is not None else latest_step(self.root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return load_pytree(template, self.path(step)), step

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.path(s), ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for p in self.root.glob("*.tmp"):
            shutil.rmtree(p, ignore_errors=True)

    def all_steps(self) -> list[int]:
        return sorted(int(_STEP_RE.match(p.name).group(1))
                      for p in self.root.iterdir() if _STEP_RE.match(p.name))


class AsyncCheckpointer:
    """One-in-flight background writer: ``save`` returns once the tree is
    copied to the host; the file write happens on a worker thread.
    ``wait()`` joins the in-flight save and raises its error, if any."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        # an explicit copy: a CPU tensor or numpy leaf aliases the caller's
        # buffer, which the next train step writes in place
        host = _unflatten(tree, [_host_copy(leaf)
                                 for _, leaf in _flatten(tree)])

        def work():
            try:
                self.manager.save(step, host)
            except BaseException as e:               # surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
