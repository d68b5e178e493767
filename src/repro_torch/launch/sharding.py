"""Divisibility-aware sharding rule engine, as the JAX package's
``launch/sharding.py``, over the port's ``launch/mesh.py: Mesh`` (or any
object with ``shape`` and ``axis_names``).

Every parameter/cache dimension carries a LOGICAL name (assigned at init in
``models/*``) and this engine resolves names -> mesh axes per tensor:

  * candidates are tried in order;
  * a candidate is accepted only if the dim size divides the mesh axes'
    product and no mesh axis is reused within the tensor;
  * "embed" -> "data" gives ZeRO-3/FSDP parameter sharding on top of TP.

A spec is a tuple with one entry a dim (a mesh axis, a tuple of them, or
None), trailing Nones dropped: what ``tuple(jax.sharding.PartitionSpec)``
reads, so the specs compare equal to JAX's. The same engine gives the
activation rules that ``models.partition.hint`` resolves.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# logical axis -> ordered candidate mesh-axis tuples. Training and prefill
# replicate attention over "model" when the heads do not divide it (head_dim
# is the score einsum's contracting dim); decode caches keep the head_dim
# fallback.
PARAM_RULES: dict[str, list[tuple[str, ...]]] = {
    "vocab": [("model",)],
    "ff": [("model",)],
    "experts": [("model",)],
    "heads": [("model",)],
    "kv": [("model",)],
    "rec": [("model",)],
    "embed": [("data",)],           # FSDP / ZeRO-3
    "batch": [("pod", "data")],
    "head_dim": [],
    "kv_seq": [],
    "seq": [],
    "layers": [],
    "enc_seq": [],
}

CACHE_RULES: dict[str, list[tuple[str, ...]]] = {
    **PARAM_RULES,
    "kv": [("model",)],
    "head_dim": [("model",)],       # fallback: shard cache over head_dim
}

# activation constraint rules (models.partition.hint): single candidate each
ACT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "experts": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "rec": ("model",),
    "embed": None,
    "seq": None,
}


@dataclass(frozen=True)
class NamedSharding:
    """A resolved spec on a mesh (JAX's ``NamedSharding``'s two fields)."""
    mesh: Any
    spec: tuple


def _filter_axes(cand: tuple[str, ...], mesh) -> tuple[str, ...]:
    return tuple(a for a in cand if a in mesh.axis_names)


def spec_for(axes: tuple[str | None, ...], shape: tuple[int, ...],
             mesh, rules: dict | None = None) -> tuple:
    """Resolve one tensor's logical axes to a spec tuple."""
    rules = rules if rules is not None else PARAM_RULES
    used: set[str] = set()
    parts: list = []
    for i, name in enumerate(axes):
        assigned = None
        for cand in rules.get(name, []) if name else []:
            cand = _filter_axes(cand, mesh)
            if not cand or any(a in used for a in cand):
                continue
            size = 1
            for a in cand:
                size *= mesh.shape[a]
            if size > 1 and shape[i] % size == 0:
                assigned = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_specs(axes_tree, shape_tree, mesh, rules: dict | None = None):
    """Parallel (axes, shapes) trees of nested dicts -> a tree of specs.
    A shape leaf is anything with ``.shape``."""
    if _is_axes(axes_tree):
        return spec_for(axes_tree, tuple(shape_tree.shape), mesh, rules)
    return {k: tree_specs(a, shape_tree[k], mesh, rules)
            for k, a in axes_tree.items()}


def tree_shardings(axes_tree, shape_tree, mesh, rules: dict | None = None):
    def wrap(specs):
        if isinstance(specs, dict):
            return {k: wrap(v) for k, v in specs.items()}
        return NamedSharding(mesh, specs)
    return wrap(tree_specs(axes_tree, shape_tree, mesh, rules))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def act_rules_for(mesh) -> dict:
    """hint() rules filtered to this mesh's axes."""
    out = {}
    for name, cand in ACT_RULES.items():
        if cand is None:
            out[name] = None
        else:
            f = _filter_axes(cand, mesh)
            out[name] = f if f else None
    return out


def batch_sharding(mesh, batch_size: int) -> NamedSharding:
    """Sharding for [B, ...] data tensors; falls back to replication when
    the batch doesn't divide (e.g. long_500k's B=1)."""
    cand = _filter_axes(("pod", "data"), mesh)
    size = 1
    for a in cand:
        size *= mesh.shape[a]
    if cand and batch_size % size == 0:
        return NamedSharding(mesh, (cand if len(cand) > 1 else cand[0],))
    return replicated(mesh)
