"""The port's ``launch/analysis.py`` against the JAX package's, on the CPU,
exactly (every number here is an integer or an exact ratio):

* the HLO parsers (``_shape_bytes``, ``_split_computations``,
  ``collective_bytes``, copied verbatim) on ``tests/test_analysis.py``'s
  HLO and on more forms (async start/done pairs, a promoted all-reduce, a
  conditional, a call, all-to-all): equal dicts from both packages, and
  the values ``tests/test_analysis.py`` asserts;
* ``Roofline``'s terms at the H100 SXM5 data-sheet constants, and
  ``analyze`` against ``analytic.flops_model``;
* ``memory_from_specs`` and the collective model on hand-worked cells: one
  FSDP leaf, one tensor-parallel layer, a MoE layer, the embedding, and
  the COBS psum and all-gather.
"""
import types

import pytest
import torch
from test_analysis import HLO

from repro.launch import analysis as janalysis

from repro_torch import configs
from repro_torch.launch import analysis, analytic
from repro_torch.launch.sharding import NamedSharding
from repro_torch.launch.specs import SHAPES

ASYNC_HLO = """\
HloModule async

%add (a: f32[], b: f32[]) -> f32[] {
  ROOT %s = f32[] add(%a, %b)
}

%branch_a (p: f32[64]) -> f32[64] {
  %ag1 = f32[512]{0} all-gather(%p), replica_groups={}
  ROOT %r = f32[64] slice(%ag1)
}

%branch_b (p: f32[64]) -> f32[64] {
  %ag2 = f32[128]{0} all-gather(%p), replica_groups={}
  ROOT %r2 = f32[64] slice(%ag2)
}

%callee (p: bf16[32]) -> bf16[32] {
  ROOT %a2a = bf16[32]{0} all-to-all(%p), replica_groups={}
}

ENTRY %main (a: f32[64], b: bf16[32], c: s32[]) -> f32[64] {
  %ags = (f32[64]{0}, f32[1024]{0}) all-gather-start(%a), replica_groups={}
  %agd = f32[1024]{0} all-gather-done(%ags)
  %convert.1 = f32[256]{0} convert(%b)
  %arp = f32[256]{0} all-reduce(%convert.1), to_apply=%add
  %ar2 = f32[256]{0} all-reduce(%a), to_apply=%add.promoted
  %cond = f32[64] conditional(%c, %a, %a), branch_computations={%branch_a, %branch_b}
  %cl = bf16[32] call(%b), to_apply=%callee
  %cps = (s32[8]{0}, s32[8]{0}) collective-permute-start(%c), source_target_pairs={{0,1}}
  ROOT %o = f32[64] add(%cond, %cond)
}
"""

SHAPE_CASES = ["f32[8,128]{1,0}", "bf16[16]", "(f32[4], s32[2])", "pred[]",
               "u8[3,5]", "token[]", "c64[2]", "f64[]", "s16[0]",
               "(bf16[2,2], (u32[4], pred[7]))", "opaque[4]"]


@pytest.mark.parametrize("text", [HLO, ASYNC_HLO], ids=["test_analysis",
                                                         "async"])
def test_parsers_equal_jax(text):
    assert analysis._split_computations(text) == \
        janalysis._split_computations(text)
    assert analysis.collective_bytes(text) == \
        janalysis.collective_bytes(text)


def test_collective_values_of_jax_test_hlo():
    out = analysis.collective_bytes(HLO)
    assert out == {"all-gather": 8192 * 10, "all-reduce": 2048 * 2 * 10,
                   "reduce-scatter": 65536 * 4, "collective-permute": 1024}


def test_collective_values_of_async_hlo():
    """A start's one-string tuple counts whole (4,352 and 64 B); the
    convert-fed and the 'promoted' f32 all-reduces count at half (bf16
    source width); the conditional its heavier branch; the call its
    callee."""
    out = analysis.collective_bytes(ASYNC_HLO)
    assert out == {"all-gather": 4352 + 2048, "all-reduce": 1024 + 1024,
                   "all-to-all": 64, "collective-permute": 64}


@pytest.mark.parametrize("text", SHAPE_CASES)
def test_shape_bytes_equal_jax(text):
    assert analysis._shape_bytes(text) == janalysis._shape_bytes(text)


def test_shape_bytes_values():
    assert analysis._shape_bytes("f32[8,128]{1,0}") == 8 * 128 * 4
    assert analysis._shape_bytes("bf16[16]") == 32
    assert analysis._shape_bytes("(f32[4], s32[2])") == 16 + 8
    assert analysis._shape_bytes("pred[]") == 1
    assert analysis._DTYPE_BYTES == janalysis._DTYPE_BYTES
    assert analysis._COLLECTIVES == janalysis._COLLECTIVES


def test_h100_constants():
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (989e12, 3.35e12, 50e9)


def test_roofline_terms_and_bottleneck():
    r = analysis.Roofline(flops_per_chip=989e12, bytes_per_chip=3.35e12,
                          coll_bytes_per_chip=0.0, coll_breakdown={},
                          model_flops=989e12 / 2, chips=2)
    assert r.t_compute == 1.0 and r.t_memory == 1.0
    assert r.t_collective == 0.0
    assert r.bottleneck == "compute"          # the first of equal terms
    assert r.useful_flops_ratio == 0.25
    r2 = analysis.Roofline(1, 1, 50e9, {"all-reduce": 50e9}, chips=1)
    assert r2.bottleneck == "collective" and r2.t_collective == 1.0
    r3 = analysis.Roofline(0.0, 6.7e12, 0.0, {})
    assert r3.bottleneck == "memory" and r3.t_memory == 2.0
    assert analysis.Roofline(0, 0, 0, {}).useful_flops_ratio == 0.0
    d = r.as_dict()
    jd = janalysis.Roofline(989e12, 3.35e12, 0.0, {}, model_flops=989e12 / 2,
                            chips=2).as_dict()
    assert set(jd) - set(d) == {"hlo_flops_raw", "hlo_bytes_raw"}
    assert set(d) <= set(jd)
    assert (d["bottleneck"], d["useful_flops_ratio"], d["chips"]) == \
        (jd["bottleneck"], jd["useful_flops_ratio"], jd["chips"])


@pytest.mark.parametrize("arch", configs.list_archs())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_and_analyze(arch, shape):
    cfg, s = configs.get(arch), SHAPES[shape]
    coll = {"all-gather": 3, "all-reduce": 4}
    r = analysis.analyze(cfg, s, chips=256, coll=coll)
    fb = analytic.flops_model(cfg, s.mode, s.seq_len, s.global_batch)
    assert r.flops_per_chip == fb.computed_flops / 256
    assert r.bytes_per_chip == fb.hbm_bytes / 256
    assert r.model_flops == fb.useful_flops
    assert r.coll_bytes_per_chip == 7.0 and r.coll_breakdown == coll


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def cfg(**kw):
    base = dict(compute_dtype="bfloat16", remat="full", d_model=64,
                enc_seq=12, moe=None, tie_embeddings=False)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_memory_from_specs_hand_worked():
    mesh = FakeMesh({"data": 4, "model": 2})
    sh = lambda *spec: NamedSharding(mesh, spec)  # noqa: E731
    args = ({"w": meta(64, 128), "b": meta(128, dtype=torch.bfloat16)},
            meta(8, 5, dtype=torch.int32))
    shard = ({"w": sh("data", "model"), "b": sh()}, sh("data"))
    outs = (meta(8, 1, 6), {"w": meta(64, 128)})
    out_sh = (sh(None, None, "model"), {"w": sh("data", "model")})
    mem = analysis.memory_from_specs(args, shard, outs, out_sh, mesh, (0,))
    assert mem == {"argument_size_in_bytes": 4096 + 256 + 40,
                   "output_size_in_bytes": 96 + 4096,
                   "alias_size_in_bytes": 4096 + 256,
                   "argument_bytes": [4352, 40]}
    with pytest.raises(ValueError):           # 5 does not divide over 4
        analysis.leaf_bytes(meta(5), sh("data"), mesh)
    with pytest.raises(ValueError):           # the trees differ
        analysis.leaf_bytes({"a": meta(4)}, {"b": sh()}, mesh)


def test_fsdp_leaf_hand_worked():
    """One FSDP leaf [64, 128] fp32 over (data 4, model 2), the batch over
    "data": gathered to [64, 64] (16,384 B) in the forward and the
    backward (the recompute shares the backward's gather, whatever the
    remat); its fp32 grad reduce-scattered (operand 16,384 B); its
    model-sharded output makes its input's grad, [B/dp, S, 64] bf16 =
    [2, 16, 64] x 2 B, an all-reduce (twice for the ring)."""
    mesh = FakeMesh({"data": 4, "model": 2})
    args = ({"w": meta(64, 128)}, {"w": ("embed", "ff")},
            {"w": ("data", "model")}, ("data",))
    for remat in ("full", "none"):
        t = analysis.lm_collective_terms(cfg(remat=remat), "train", 16, 8,
                                         mesh, *args)
        assert t == {"fsdp_gather": {"all-gather": 2 * 16384},
                     "grad_reduce": {"reduce-scatter": 16384},
                     "tp_allreduce": {"all-reduce": 2 * 2 * 16 * 64 * 2}}
    t = analysis.lm_collective_terms(cfg(), "decode", 16, 8, mesh, *args)
    assert t == {"fsdp_gather": {"all-gather": 16384}}
    # across two pods the grad shard is all-reduced over "pod" too
    mesh3 = FakeMesh({"pod": 2, "data": 4, "model": 2})
    t = analysis.lm_collective_terms(cfg(), "train", 16, 16, mesh3,
                                     *args[:3], (("pod", "data"),))
    assert t["grad_reduce"] == {"reduce-scatter": 16384,
                                "all-reduce": 2 * 16384 // 4}
    # a batch of 1 spans no axis: the input is replicated over "data", and
    # the [1, 1, 64] bf16 partial products reduced over it (256 B, ring
    # 2x) cost less than the gather
    t = analysis.lm_collective_terms(cfg(), "decode", 1 << 19, 1, mesh,
                                     *args[:3], ())
    assert t == {"fsdp_reduce": {"all-reduce": 2 * 1 * 64 * 2}}


def test_tp_layer_hand_worked():
    """Three stacked attention output projections, heads over "model" 4:
    each an all-reduce of [B/dp, S, d] bf16 = [4, 32, 64] x 2 B = 16,384 B,
    twice for the ring, a layer and forward pass; their input gradients
    move nothing (the heads stay sharded)."""
    mesh = FakeMesh({"data": 2, "model": 4})
    path = {"segments": {"seg0_attn": {"attn": {"wo": meta(3, 4, 16, 64)}}}}
    axes = {"segments": {"seg0_attn": {"attn": {
        "wo": ("layers", "heads", "head_dim", "embed")}}}}
    spec = {"segments": {"seg0_attn": {"attn": {"wo": (None, "model")}}}}
    t = analysis.lm_collective_terms(cfg(), "prefill", 32, 8, mesh, path,
                                     axes, spec, ("data",))
    assert t == {"tp_allreduce": {"all-reduce": 2 * 16384 * 3}}
    t = analysis.lm_collective_terms(cfg(remat="none"), "train", 32, 8,
                                     mesh, path, axes, spec, ("data",))
    grad = 3 * 4 * 16 * 64 * 4 // 4                   # fp32, over model
    assert t == {"tp_allreduce": {"all-reduce": 2 * 16384 * 3},
                 "grad_reduce": {"all-reduce": 2 * grad}}
    # the recompute under remat="full" repeats the forward's
    t = analysis.lm_collective_terms(cfg(), "train", 32, 8, mesh, path,
                                     axes, spec, ("data",))
    assert t["tp_allreduce"] == {"all-reduce": 2 * 16384 * 3 * 2}
    # decode: S = 1; fp32 compute doubles c
    t = analysis.lm_collective_terms(cfg(compute_dtype="float32"), "decode",
                                     32, 8, mesh, path, axes, spec,
                                     ("data",))
    assert t == {"tp_allreduce": {"all-reduce": 2 * 4 * 1 * 64 * 4 * 3}}
    # an input projection, heads over "model": nothing forward; in train
    # its input's [4, 32, 64] gradient is reduced once a layer
    wq = {"segments": {"seg0_attn": {"attn": {"wq": meta(3, 64, 4, 16)}}}}
    axes_q = {"segments": {"seg0_attn": {"attn": {
        "wq": ("layers", "embed", "heads", "head_dim")}}}}
    spec_q = {"segments": {"seg0_attn": {"attn": {
        "wq": (None, None, "model")}}}}
    assert analysis.lm_collective_terms(cfg(), "prefill", 32, 8, mesh, wq,
                                        axes_q, spec_q, ("data",)) == {}
    t = analysis.lm_collective_terms(cfg(), "train", 32, 8, mesh, wq,
                                     axes_q, spec_q, ("data",))
    assert t["tp_allreduce"] == {"all-reduce": 2 * 16384 * 3}


def test_moe_embed_and_encoder_hand_worked():
    """(data 2, model 4), batch 8 x 32 (T = 256): 8 experts, 2 on a model
    shard, top 2, capacity factor 1 (a global capacity of 64)."""
    mesh = FakeMesh({"data": 2, "model": 4})
    moe = types.SimpleNamespace(n_experts=8, top_k=2, capacity_factor=1.0,
                                dispatch="einsum")
    params = {"embed": {"tok": meta(512, 64)},
              "encoder": {"mlp": {"wo": meta(2, 128, 64)}},
              "segments": {"seg0_moe": {"moe": {
                  "router": meta(2, 64, 8), "wo": meta(2, 8, 32, 64)}}}}
    axes = {"embed": {"tok": ("vocab", "embed")},
            "encoder": {"mlp": {"wo": ("layers", "ff", "embed")}},
            "segments": {"seg0_moe": {"moe": {
                "router": ("layers", "embed", "experts"),
                "wo": ("layers", "experts", "ff", "embed")}}}}
    specs = {"embed": {"tok": ("model",)},
             "encoder": {"mlp": {"wo": (None, "model")}},
             "segments": {"seg0_moe": {"moe": {"router": (None, None,
                                                          "model"),
                                               "wo": (None, "model")}}}}
    site = 4 * 32 * 64 * 2                     # [B/dp, S, d] bf16
    enc_site = 4 * 12 * 64 * 2                 # S = enc_seq in the encoder
    t = analysis.lm_collective_terms(cfg(moe=moe), "prefill", 32, 8, mesh,
                                     params, axes, specs, ("data",))
    assert t == {
        "tp_allreduce": {"all-reduce": 2 * site + 2 * enc_site * 2},
        # the [2, 65, 64] bf16 buffer over "data", 2 layers
        "moe_dispatch": {"all-reduce": 2 * 2 * 65 * 64 * 2 * 2},
        # logits [128, 8] fp32 over "model"; one-hot [512, 8] int32
        "moe_route": {"all-gather": 128 * 8 * 4 * 2 + 512 * 8 * 4 * 2},
        # the [128 x 2, 64] bf16 picks over "model"
        "moe_combine": {"all-reduce": 2 * 256 * 64 * 2 * 2}}
    t = analysis.lm_collective_terms(cfg(moe=moe), "decode", 32, 8, mesh,
                                     params, axes, specs, ("data",))
    dsite = 4 * 1 * 64 * 2                     # no encoder in decode
    assert t == {"tp_allreduce": {"all-reduce": 2 * dsite},
                 "moe_dispatch": {"all-reduce": 2 * 2 * 5 * 64 * 2 * 2},
                 "moe_route": {"all-gather": 4 * 8 * 4 * 2
                               + 16 * 8 * 4 * 2},
                 "moe_combine": {"all-reduce": 2 * 8 * 64 * 2 * 2}}
    assert analysis.by_kind(t) == {
        "all-reduce": 2 * dsite + 2 * 2 * 5 * 64 * 2 * 2 + 2 * 8 * 64 * 2 * 2,
        "all-gather": 4 * 8 * 4 * 2 + 16 * 8 * 4 * 2}
    # train, tied: the head's input grad too, the router's in fp32, and
    # the backward's buffer gradient [2, 64, 64] and picks
    t = analysis.lm_collective_terms(cfg(moe=moe, tie_embeddings=True,
                                         remat="none"), "train", 32, 8,
                                     mesh, params, axes, specs, ("data",))
    assert t["tp_allreduce"] == {"all-reduce": 2 * site * 2
                                 + 2 * enc_site * 2 + 2 * site * 2 * 2}
    assert t["moe_dispatch"] == {
        "all-reduce": 2 * 2 * 64 * 2 * 2 * (65 + 64)}
    assert t["moe_combine"] == {"all-reduce": 2 * 256 * 64 * 2 * 2 * 2}
    # the local dispatch: a psum of the [B/dp, S, d] output instead
    local = types.SimpleNamespace(**{**vars(moe), "dispatch": "local"})
    t = analysis.lm_collective_terms(cfg(moe=local), "prefill", 32, 8,
                                     mesh, params, axes, specs, ("data",))
    assert t["moe_psum"] == {"all-reduce": 2 * site * 2}
    assert "moe_dispatch" not in t and "moe_combine" not in t


def test_cobs_terms_hand_worked():
    """Q 2, nb 3, Wl 2 (192 local slots), 4 doc shards, 2 row stripes, top
    32, int32 scores: psum 2 x 2 x 192 x 4 = 3,072 B; all-gather of the
    (value, slot) candidates 2 x 2 x 4 x 32 x 4 = 2,048 B."""
    t = analysis.cobs_collective_terms(2, 3, 2, 4, 2, 32, 4)
    assert t == {"score_psum": {"all-reduce": 3072},
                 "topk_gather": {"all-gather": 2048}}
    assert analysis.cobs_collective_terms(2, 3, 2, 1, 1, 32, 4) == {}
    # k is cut to the local slots; int16 scores halve the psum
    t = analysis.cobs_collective_terms(2, 1, 1, 4, 2, 64, 2)
    assert t == {"score_psum": {"all-reduce": 2 * 2 * 32 * 2},
                 "topk_gather": {"all-gather": 2 * 2 * 4 * 32 * 4}}


def test_flatten_orders_as_jax():
    import jax
    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5}}
    assert [v for _, v in analysis.flatten(tree)] == jax.tree.leaves(tree)
    assert [p for p, _ in analysis.flatten(tree)] == \
        ["/a/x", "/a/y", "/b/0", "/b/1/0", "/b/1/1"]
    assert analysis.flatten(None) == [] and analysis.flatten(7) == [("", 7)]
