"""Roofline terms, per-device memory and a collective model for the port's
analytic dry-run (``launch/dryrun.py``), plus the JAX package's HLO parsers.

Three terms per (arch x shape x mesh), in seconds:

  compute    = flops_per_chip / PEAK_FLOPS
  memory     = bytes_per_chip / HBM_BW
  collective = collective_bytes_per_chip / LINK_BW

FLOPs and bytes come from ``launch/analytic.py`` (the global counts over
the chips). PyTorch has no SPMD lowering, so the collective bytes come
from a model: ``lm_collective_terms`` and ``cobs_collective_terms``,
functions of the resolved specs documented term by term there, with the
JAX package's kind names and ring factors (all-reduce 2x, the others 1x;
the (N-1)/N factor folded to 1).

Hardware model: NVIDIA H100 SXM5 80 GB at 700 W, from its data sheet (not
measured): 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and 50 GB/s a
direction for a collective, one 400 Gb/s NDR port a GPU as in a DGX H100.
NVLink gives 450 GB/s a direction inside a node of 8, but every axis of
the production meshes spans at least two nodes ("model" is 16 contiguous
positions, "data" is strided by 16), so the inter-node rate bounds each
collective.

The HLO parsers (``_shape_bytes``, ``_split_computations``,
``collective_bytes``) are the JAX package's, verbatim (plain ``re``), kept
to read an optimized HLO module or a collective trace of the same form.
"""
from __future__ import annotations

import dataclasses
import math
import re

from ..checkpoint.store import _flatten
from ..models.moe import _capacity
from . import analytic

PEAK_FLOPS = 989e12          # bf16 dense, per GPU (data sheet)
HBM_BW = 3.35e12             # bytes/s per GPU (data sheet)
LINK_BW = 50e9               # bytes/s a direction, one 400 Gb/s NDR port

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z]+[0-9]*)\[([0-9,]*)\]")
_ASSIGN_RE = re.compile(r"^\s*(?:ROOT\s+)?(%[\w\.\-]+)\s*=\s*(\([^)]*\)|"
                        r"[a-z]+[0-9]*\[[0-9,]*\]\S*)\s+([\w\-]+)")
_COMP_START = re.compile(r"^(?:ENTRY\s+)?(%[\w\.\-]+)[\s(].*\{")
_BODY_RE = re.compile(r"body=(%[\w\.\-]+)")
_CALL_RE = re.compile(r"to_apply=(%[\w\.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_TRIP_RE = re.compile(r'known_trip_count\\?":\{\\?"n\\?":\\?"(\d+)')
_OPERAND_RE = re.compile(r"\((%[\w\.\-]+)")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _split_computations(hlo_text: str) -> dict[str, list[str]]:
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        if cur is None:
            if not line.startswith(" "):
                m = _COMP_START.match(line)
                if m:
                    cur = m.group(1)
                    comps[cur] = []
        else:
            if line.startswith("}"):
                cur = None
            else:
                comps[cur].append(line)
    return comps


def collective_bytes(hlo_text: str) -> dict[str, int]:
    """Per-collective-kind transferred bytes (per-chip) from optimized HLO.

    Trip-count-aware: collectives inside while bodies (lax.scan'd layer
    stacks, FSDP gathers) are weighted by the loop's known_trip_count.
    Byte semantics per op (ring algorithms, (N-1)/N ~ 1):
      all-gather: result size | reduce-scatter: operand size |
      all-reduce: 2 x size    | all-to-all / permute: result size.
    """
    comps = _split_computations(hlo_text)

    # first pass: instruction result shapes per computation
    shapes: dict[str, dict[str, str]] = {}
    for cname, lines in comps.items():
        d = {}
        for line in lines:
            m = _ASSIGN_RE.match(line)
            if m:
                d[m.group(1)] = m.group(2)
        shapes[cname] = d

    memo: dict[str, dict[str, float]] = {}

    def walk(cname: str) -> dict[str, float]:
        if cname in memo:
            return memo[cname]
        memo[cname] = {}                       # break recursion cycles
        out: dict[str, float] = {}
        local_shapes = shapes.get(cname, {})
        for line in comps.get(cname, []):
            m = _ASSIGN_RE.match(line)
            if not m:
                continue
            _, result_shape, op = m.groups()
            base = op.replace("-start", "").replace("-done", "")
            if base in _COLLECTIVES and not op.endswith("-done"):
                if op.endswith("-start") and result_shape.startswith("("):
                    # async tuple (operand, result): use the LARGER element
                    parts = [_shape_bytes(p) for p in
                             result_shape.strip("()").split("), (")]
                    b = max(_shape_bytes(result_shape) // 2,
                            max(parts) if parts else 0)
                else:
                    b = _shape_bytes(result_shape)
                if base == "all-reduce":
                    b *= 2
                    # XLA-CPU promotes bf16 all-reduces to f32 (the operand
                    # is a convert fusion / 'promoted' reducer). TPU reduces
                    # bf16 natively -> count promoted ARs at source width.
                    om = _OPERAND_RE.search(line[line.index(op):])
                    promoted = "promoted" in line
                    if om and "convert" in om.group(1):
                        promoted = True
                    if promoted and result_shape.startswith("f32"):
                        b //= 2
                elif base == "reduce-scatter":
                    om = _OPERAND_RE.search(line[line.index(op):])
                    if om and om.group(1) in local_shapes:
                        b = _shape_bytes(local_shapes[om.group(1)])
                out[base] = out.get(base, 0) + b
            elif op == "while":
                bm = _BODY_RE.search(line)
                tm = _TRIP_RE.search(line)
                trip = int(tm.group(1)) if tm else 1
                if bm:
                    for k, v in walk(bm.group(1)).items():
                        out[k] = out.get(k, 0) + trip * v
            elif op in ("call", "custom-call", "reduce", "sort", "map",
                        "scatter", "select-and-scatter", "fusion"):
                cm = _CALL_RE.search(line)
                if cm and op == "call":
                    for k, v in walk(cm.group(1)).items():
                        out[k] = out.get(k, 0) + v
            elif op == "conditional":
                bm = _BRANCH_RE.search(line)
                if bm:
                    branches = [b.strip() for b in bm.group(1).split(",")]
                    best: dict[str, float] = {}
                    for b in branches:
                        w = walk(b)
                        if sum(w.values()) > sum(best.values() or [0]):
                            best = w
                    for k, v in best.items():
                        out[k] = out.get(k, 0) + v
        memo[cname] = out
        return out

    entry = None
    for line in hlo_text.splitlines():
        if line.startswith("ENTRY"):
            m = _COMP_START.match(line)
            if m:
                entry = m.group(1)
                break
    if entry is None:
        return {}
    return {k: int(v) for k, v in walk(entry).items()}


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float             # analytic computed FLOPs / chips
    bytes_per_chip: float             # analytic HBM traffic / chips
    coll_bytes_per_chip: float        # the collective model's bytes a chip
    coll_breakdown: dict
    model_flops: float = 0.0          # 6*N*D (or 2*N_active*D) global
    chips: int = 1
    coll_lower_bound: bool = False    # the model is short for this cell

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global computed flops): remat/redundancy waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        """JAX's keys; where ``coll_lower_bound`` is set, the collective
        time is only a lower bound, and ``t_collective_min_s`` and
        ``bottleneck_at_min`` (the bottleneck were the collectives no
        slower) stand in place of ``t_collective_s`` and ``bottleneck``."""
        low = "_min" if self.coll_lower_bound else ""
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            f"t_collective{low}_s": self.t_collective,
            "bottleneck" + ("_at_min" if low else ""): self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "chips": self.chips,
        }


def analyze(cfg, shape, chips: int, coll: dict[str, int],
            coll_lower_bound: bool = False) -> Roofline:
    """The roofline of one cell: ``analytic.flops_model``'s global FLOPs and
    HBM bytes over ``chips``, and ``coll`` (bytes a chip by kind, from
    ``lm_collective_terms`` or ``cobs_collective_terms`` via ``by_kind``),
    a lower bound where ``coll_lower_bound`` says so."""
    fb = analytic.flops_model(cfg, shape.mode, shape.seq_len,
                              shape.global_batch)
    return Roofline(
        flops_per_chip=fb.computed_flops / chips,
        bytes_per_chip=fb.hbm_bytes / chips,
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown=dict(coll),
        model_flops=fb.useful_flops,
        chips=chips,
        coll_lower_bound=coll_lower_bound,
    )


# --------------------------------------------------------------------------
# Trees of meta tensors and their specs
# --------------------------------------------------------------------------

def flatten(tree, is_leaf=None) -> list[tuple[str, object]]:
    """("/"-joined path, leaf) pairs of a tree of dicts (sorted keys, as
    ``jax.tree`` orders them), named tuples, tuples and lists, the
    checkpoint store's walk. ``None`` is an empty subtree, as in JAX."""
    return [("".join("/" + n.lstrip(".") for n in p), v)
            for p, v in _flatten(tree, is_leaf=is_leaf)]


def spec_axes(spec: tuple) -> tuple[str, ...]:
    """The mesh axes a spec names, in order."""
    out: list[str] = []
    for part in spec:
        if part is None:
            continue
        out += [part] if isinstance(part, str) else list(part)
    return tuple(out)


def shard_factor(spec: tuple, mesh, axes: tuple[str, ...] | None = None
                 ) -> int:
    """The product of the mesh sizes of the axes ``spec`` names (of those
    in ``axes`` when given)."""
    return math.prod(mesh.shape[a] for a in spec_axes(spec)
                     if axes is None or a in axes)


def nbytes(t) -> int:
    """Bytes of a tensor (a meta tensor allocates none of them)."""
    return t.numel() * t.element_size()


def leaf_bytes(tree, shardings, mesh) -> list[tuple[str, int]]:
    """(path, bytes a device) of each leaf: the leaf's bytes over the
    product of the mesh axes its spec names. The rule engine only accepts a
    dimension its axes divide, so the division is exact (checked)."""
    leaves = flatten(tree)
    specs = flatten(shardings)
    if [p for p, _ in leaves] != [p for p, _ in specs]:
        raise ValueError("the shardings' tree differs from the arguments'")
    out = []
    for (path, t), (_, sh) in zip(leaves, specs):
        for i, part in enumerate(sh.spec):
            if t.shape[i] % shard_factor((part,), mesh):
                raise ValueError(f"{path}: dim {i} of {tuple(t.shape)} "
                                 f"does not divide over {part}")
        out.append((path, nbytes(t) // shard_factor(sh.spec, mesh)))
    return out


def memory_from_specs(args, in_shardings, outs, out_shardings, mesh,
                      donate_argnums: tuple = ()) -> dict:
    """Per-device bytes of a cell, the keys of JAX's ``memory_analysis``
    that a spec determines: ``argument_size_in_bytes`` (every argument
    leaf), ``output_size_in_bytes`` (every output leaf) and
    ``alias_size_in_bytes`` (the donated arguments, whose buffers the
    outputs reuse). ``temp_size_in_bytes`` and
    ``generated_code_size_in_bytes`` come from a compiler, and there is
    none: they are not given."""
    per_arg = [sum(b for _, b in leaf_bytes(a, s, mesh))
               for a, s in zip(args, in_shardings)]
    out = sum(b for _, b in leaf_bytes(outs, out_shardings, mesh))
    return {"argument_size_in_bytes": sum(per_arg),
            "output_size_in_bytes": out,
            "alias_size_in_bytes": sum(per_arg[i] for i in donate_argnums),
            "argument_bytes": per_arg}


# --------------------------------------------------------------------------
# The collective model
# --------------------------------------------------------------------------

_COMPUTE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _is_tuple(x) -> bool:
    return isinstance(x, tuple)

# (arch, shape) cells for which XLA moves more than ``lm_collective_terms``
# says: compiled on a (data 2, model 2) mesh at smoke size, JAX's
# collectives exceed the model's even with every activation at fp32, by
# more than the 25% that ``tests/torch_dryrun_collectives_check.py``
# allows (xLSTM's training step reshards its gates and heads; at batch 1
# the compiler still gathers weights the model expects it to leave in
# place). Their collective time is a lower bound.
COLL_LOWER_BOUND = frozenset({("recurrentgemma-2b", "long_500k"),
                              ("xlstm-125m", "train_4k"),
                              ("xlstm-125m", "long_500k")})


def _add(terms: dict, term: str, kind: str, b: int) -> None:
    if b:
        d = terms.setdefault(term, {})
        d[kind] = d.get(kind, 0) + int(b)


def lm_collective_terms(cfg, mode: str, seq_len: int, global_batch: int,
                        mesh, params, axes, specs, batch_spec: tuple
                        ) -> dict[str, dict[str, int]]:
    """Bytes a chip of the collectives a step's resolved specs imply,
    {term: {kind: bytes}}. ``params``, ``axes`` and ``specs`` are parallel
    trees (meta tensors, logical axes, spec tuples); ``batch_spec`` is the
    tokens' spec. Let dp be the product of the axes ``batch_spec`` names,
    S the sequence of a site (1 for decode, ``cfg.enc_seq`` in the
    encoder), T = global_batch x S the step's tokens, d the model width
    and c the bytes of the compute dtype. A step runs F forward passes (1,
    and in train 2 under ``remat="full"``: the forward and the recompute)
    and, in train, one backward pass:

    A weight leaf is a matmul's when it has two dimensions or more after
    "layers" and its first is named: it contracts its inputs (every
    dimension but the last when the last is "embed", else the first) into
    its outputs; an expert's [E, in, out] runs on the [E_l, cap, in]
    buffer, a row for each capacity slot, any other on [T/dp, in].

    * ``fsdp_gather`` (all-gather): each leaf whose spec names "data" is
      gathered over it, the result its bytes over its "model" factor; once
      in the forward and, in train, once in the backward (the recompute
      runs inside the backward's layer loop on the same gather). Embedding
      tables only looked up (a position table; the token table when not
      tied to the head) move their rows, not the table.
    * ``fsdp_reduce``: where a matmul's input is replicated over "data"
      (the batch spans no "data"; an expert's buffer under the einsum
      dispatch), its partial products [rows, out] in c are all-reduced
      over "data" (data on an input) or its outputs all-gathered (data on
      an output) instead, once a forward and a backward pass, when that
      moves fewer bytes than the gather.
    * ``grad_reduce`` (train only, when dp > 1): an FSDP leaf's fp32 grad
      is reduce-scattered over "data" (the operand: its elements over its
      "model" factor, 4 B each), and its shard all-reduced over "pod" when
      the batch spans it; any other leaf's fp32 grad shard is all-reduced
      over the batch axes.
    * ``tp_allreduce`` (all-reduce), each matmul's partial sums reduced on
      their own, a layer: a matmul with "model" on an input, its
      [T/dp, out] outputs in c, once a forward pass (attention, MLP,
      recurrence and xLSTM output projections, xLSTM's gates); one with
      "model" on an output only, its input's [T/dp, in] gradient in the
      backward (q, k, v, an MLP's gate and up, the LM head; the MoE
      router's in fp32). The token embedding, vocab-sharded over "model",
      adds one [T/dp, d] for its lookup in the forward, and one for the
      head's input gradient in train when tied.
    * MoE layers (a leaf with "experts" whose last axis is "embed", E
      experts, E_l of them on a "model" shard, k picks a token), under the
      einsum dispatch with the global capacity cap = ``_capacity(T)``:
      ``moe_dispatch`` (all-reduce over the batch axes, when dp > 1): the
      [E_l, cap + 1, d] buffer in c that every batch shard scatters its
      picks into, once a forward pass, and the combine's [E_l, cap, d]
      gradient in the backward; ``moe_combine`` (all-reduce over "model",
      when E_l < E): the [T/dp x k, d] picks in c gathered from the
      expert-sharded output, once a forward pass, and the dispatch's
      gradient of that shape in the backward; ``moe_route`` (all-gather):
      the [T/dp, E] fp32 router logits over "model" (top-k reads every
      expert) and the [T x k, E] int32 one-hot over the batch axes (its
      cumsum runs in the global token order), once a forward pass each.
      Under ``dispatch="local"`` on a mesh whose "model" divides E,
      ``moe_psum`` (all-reduce) instead: the psum over "model" of
      ``moe_apply_local``'s [T/dp, d] output in c, once a forward pass and
      once in the backward.

    Left out: the cross-entropy's [T/dp] partial sums over a vocab-sharded
    "model" (under 1/d of a block's all-reduce), the decode caches'
    head_dim shards (the specs leave the choice between gathering a cache
    and reducing the scores), and the resharding (all-to-all,
    collective-permute) a compiler inserts between two specs.
    ``COLL_LOWER_BOUND`` names the cells where what is left out matters.
    """
    terms: dict[str, dict[str, int]] = {}
    c = _COMPUTE_BYTES[cfg.compute_dtype]
    dp = shard_factor(batch_spec, mesh)
    pod_in_batch = "pod" in spec_axes(batch_spec)
    train = mode == "train"
    fwd = 1 + (train and cfg.remat == "full")
    S = 1 if mode == "decode" else seq_len
    T = global_batch * S
    d = cfg.d_model
    moe = getattr(cfg, "moe", None)
    local = (moe is not None and moe.dispatch == "local"
             and "model" in mesh.axis_names
             and moe.n_experts % mesh.shape["model"] == 0)
    flat_a = dict(flatten(axes, is_leaf=_is_tuple))
    flat_s = dict(flatten(specs, is_leaf=_is_tuple))
    for path, t in flatten(params):
        ax, spec = flat_a[path], flat_s[path]
        encoder = path.startswith("/encoder/")
        if encoder and mode == "decode":
            continue                 # the decode step never runs the encoder
        named = spec_axes(spec)
        m_f = shard_factor(spec, mesh, ("model",))
        lead = 1 if ax[0] == "layers" else 0
        layers = t.shape[0] if lead else 1
        dims = t.shape[lead:]
        spec = (tuple(spec) + (None,) * t.dim())[lead:t.dim()]
        model_on = [i for i, p in enumerate(spec)
                    if "model" in spec_axes((p,))]
        tokens = global_batch * (cfg.enc_seq if encoder else S) // dp
        ring = 2 * tokens * layers * c         # an all-reduce a row element
        expert = ax[lead] == "experts"
        if expert:                             # [E, in, out...]
            e_l = moe.n_experts // shard_factor(spec[:1], mesh)
            cap = _capacity(T, moe)
            rows, n_in = e_l * cap, 2
        else:
            rows = tokens
            n_in = len(dims) - 1 if ax[-1] == "embed" else 1
        matmul = len(dims) >= 2 and ax[lead] is not None
        lookup = path.startswith("/embed/") and not (
            path == "/embed/tok" and cfg.tie_embeddings)
        if "data" in named and not lookup:
            gather = nbytes(t) // m_f
            alt = None
            if matmul and ("data" not in spec_axes(batch_spec)
                           or expert and not local):
                out = math.prod(dims[n_in:]) // shard_factor(
                    spec[n_in:], mesh, ("model",))
                data_in = "data" in spec_axes(spec[:n_in])
                alt = (1 + data_in) * rows * out * c * layers
            if alt is not None and alt < gather:
                _add(terms, "fsdp_reduce",
                     "all-reduce" if data_in else "all-gather",
                     (fwd + train) * alt)
            else:
                _add(terms, "fsdp_gather", "all-gather",
                     (1 + train) * gather)
        if train and dp > 1:
            grad = t.numel() * 4 // m_f
            if "data" in named:
                _add(terms, "grad_reduce", "reduce-scatter", grad)
                if pod_in_batch:
                    _add(terms, "grad_reduce", "all-reduce",
                         2 * grad // mesh.shape["data"])
            else:
                _add(terms, "grad_reduce", "all-reduce", 2 * grad)
        if path == "/embed/tok":
            if model_on:
                _add(terms, "tp_allreduce", "all-reduce",
                     ring * d * (1 + (train and cfg.tie_embeddings)))
            continue
        if "experts" in ax and not expert:            # the router
            if model_on:
                _add(terms, "moe_route", "all-gather",
                     fwd * tokens * moe.n_experts * 4 * layers)
                _add(terms, "tp_allreduce", "all-reduce",
                     train * ring * d * 4 // c)
            continue
        if expert:
            if ax[-1] != "embed":
                continue                # wi, wg: the output's term counts
            passes = fwd + train
            if local:
                _add(terms, "moe_psum", "all-reduce", ring * d * passes)
                continue
            if dp > 1:
                _add(terms, "moe_dispatch", "all-reduce",
                     2 * e_l * d * c * layers
                     * (fwd * (cap + 1) + train * cap))
                _add(terms, "moe_route", "all-gather",
                     fwd * T * moe.top_k * moe.n_experts * 4 * layers)
            if e_l < moe.n_experts:
                _add(terms, "moe_combine", "all-reduce",
                     ring * d * moe.top_k * passes)
            continue
        if not matmul or not model_on:
            continue                    # not a matmul, or no model shard
        if min(model_on) < n_in:        # contracts a model-sharded input
            out = math.prod(dims[n_in:]) // shard_factor(
                spec[n_in:], mesh, ("model",))
            _add(terms, "tp_allreduce", "all-reduce", ring * out * fwd)
        elif train:                     # its input's grad contracts one
            _add(terms, "tp_allreduce", "all-reduce",
                 ring * math.prod(dims[:n_in]))
    return terms


def cobs_collective_terms(n_queries: int, n_blocks: int, words_local: int,
                          n_doc_shards: int, n_row_shards: int, topk: int,
                          score_bytes: int) -> dict[str, dict[str, int]]:
    """Bytes a chip of the sharded COBS query step (the JAX package's
    ``index/distributed.py`` shard body), {term: {kind: bytes}}:

    * ``score_psum`` (all-reduce, when rows shard over "model"): the
      [Q, nb * Wl * 32] partial scores in the score dtype, summed over the
      row stripes;
    * ``topk_gather`` (all-gather, when documents shard): each shard's
      top-k (value, slot) candidates, int32 each, gathered over the doc
      axes into [Q, P * k] twice.
    """
    terms: dict[str, dict[str, int]] = {}
    n_local = n_blocks * words_local * 32
    if n_row_shards > 1:
        _add(terms, "score_psum", "all-reduce",
             2 * n_queries * n_local * score_bytes)
    if n_doc_shards > 1:
        k = min(topk, n_local)
        _add(terms, "topk_gather", "all-gather",
             2 * n_queries * n_doc_shards * k * 4)
    return terms


def by_kind(terms: dict[str, dict[str, int]]) -> dict[str, int]:
    """{term: {kind: bytes}} -> {kind: bytes}, JAX's ``collective_bytes``
    form."""
    out: dict[str, int] = {}
    for kinds in terms.values():
        for kind, b in kinds.items():
            out[kind] = out.get(kind, 0) + b
    return out
