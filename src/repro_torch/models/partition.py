"""Logical-axis partitioning context.

Model code annotates parameters and activations with LOGICAL axis names
("embed", "ff", "heads", "experts", "batch", "seq", ...). Parameters are
built as ``ParamMeta`` leaves carrying their logical axes; ``split_meta``
separates values from axes, so the same init code serves real runs,
meta-device shapes (``Model.abstract_params``) and the sharding rule engine.

``partitioning`` records a (mesh, rules) context (the launcher installs
``launch/sharding.py: act_rules_for(mesh)``) and ``resolve_spec`` turns
logical axes into a partition spec (a tuple, as JAX's ``PartitionSpec``
reads) under it. ``hint`` resolves an activation's spec under the context,
as JAX does before ``with_sharding_constraint``, and returns its input: one
process drives every position of the port's mesh, so there is no placement
to constrain (``moe_apply_local`` places its work position by position).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

_CTX: contextvars.ContextVar[tuple[Any, dict] | None] = \
    contextvars.ContextVar("partitioning", default=None)


@dataclasses.dataclass
class ParamMeta:
    value: Any                      # a tensor (or a meta-device tensor)
    axes: tuple[str | None, ...]    # logical name per dim


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def split_meta(tree):
    """Nested dict of ParamMeta -> (values tree, axes tree)."""
    return _map(lambda m: m.value, tree), _map(lambda m: m.axes, tree)


@contextlib.contextmanager
def partitioning(mesh, rules: dict[str, tuple[str, ...] | str | None]):
    """rules: logical axis name -> mesh axes (or None = replicate)."""
    token = _CTX.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> tuple[Any, dict] | None:
    return _CTX.get()


def resolve_spec(axes: tuple[str | None, ...], shape: tuple[int, ...] | None,
                 mesh, rules) -> tuple:
    """Logical axes -> partition spec under divisibility + no-reuse checks:
    one entry a dim (a mesh axis, a tuple of them, or None), trailing
    Nones dropped, as ``tuple(jax.sharding.PartitionSpec)`` reads.

    shape=None skips divisibility checks (activation hints where XLA pads).
    ``mesh.shape`` maps an axis name to its size.
    """
    used: set[str] = set()
    parts = []
    if shape is not None and len(axes) != len(shape):   # rank-mismatch hint:
        return ()                                       # no constraint
    for i, name in enumerate(axes):
        assigned = None
        if name is not None:
            cand = rules.get(name)
            if cand is not None:
                mesh_axes = (cand,) if isinstance(cand, str) else tuple(cand)
                if not any(a in used for a in mesh_axes):
                    size = 1
                    for a in mesh_axes:
                        size *= mesh.shape[a]
                    if shape is None or shape[i] % size == 0:
                        assigned = mesh_axes if len(mesh_axes) > 1 else mesh_axes[0]
                        used.update(mesh_axes)
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def hint(x, *axes: str | None):
    """Annotate an activation with logical axes: under a context the spec
    is resolved (a rule naming an axis the mesh lacks raises, as in JAX);
    ``x`` is returned unchanged either way."""
    ctx = _CTX.get()
    if ctx is not None:
        mesh, rules = ctx
        resolve_spec(tuple(axes), tuple(x.shape), mesh, rules)
    return x
