"""The port's dry-run specs and sizing against the reference's
(``repro_torch.models.partitioning``, ``launch.mesh``, ``launch.steps
.make_step``, ``launch.dryrun``, ``benchmarks.roofline``).

Every arch x input shape at full config: the parameters' names, shapes
and types, their logical axes, the batch's and the cache's specs and
axes, and the optimizer state's, each equal to the reference's, with
nothing allocated on either side (the port's models on ``meta``);
``Rules.spec`` equal to the reference's for every parameter on a
16 x 16 and a 2 x 16 x 16 mesh, fsdp on and off.  Then the dry-run CLI
and the roofline over its records.
"""

from __future__ import annotations

import functools
import json
import types

import jax
import pytest
import torch

from repro.launch import steps as rsteps
from repro.models import build_model as rbuild
from repro.models import get_config as rconfig
from repro.models.config import INPUT_SHAPES as RSHAPES
from repro.models.partitioning import Rules as RRules
from repro.training import optimizer as ropt
from repro_torch.launch import dryrun, mesh as pmesh
from repro_torch.launch.steps import (cache_specs_and_axes, input_specs,
                                      make_step, step_inputs)
from repro_torch.models import ARCH_IDS, INPUT_SHAPES, build_model, get_config
from repro_torch.models.arch import flat_specs
from repro_torch.models.config import InputShape
from repro_torch.models.layers import DTYPES
from repro_torch.models.partitioning import (DEFAULT_RULES, MeshShape, Rules,
                                             device_bytes, is_spec, make_mesh,
                                             map_specs, spec_tree)
from repro_torch.training import optimizer as popt
from repro_torch.tree import flatten


def _norm(t):
    """A spec tree of either package as (shape, dtype name) leaves."""
    if isinstance(t, jax.ShapeDtypeStruct):
        return (tuple(t.shape), str(t.dtype))
    if is_spec(t):
        return (tuple(t[0]), str(t[1]).replace("torch.", ""))
    if isinstance(t, dict):
        return {k: _norm(v) for k, v in t.items()}
    return tuple(_norm(x) for x in t)


_MODELS = {}


def _models(arch):
    """(reference model, the port's model on meta), built once."""
    if arch not in _MODELS:
        _MODELS[arch] = (rbuild(rconfig(arch)),
                         build_model(get_config(arch), device="meta"))
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_axes_match_reference(arch):
    """abstract_params (names through the bridge's flattening, shapes,
    types) and param_axes equal the reference's at full config; the
    meta model's parameters are those specs, and nothing is allocated."""
    rm, pm = _models(arch)
    ref = flatten(_norm(rm.abstract_params()), ".")
    got = flatten(_norm(pm.abstract_params()), ".")
    assert got == ref
    assert pm.param_axes() == rm.param_axes()
    own = {n: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for n, p in pm.named_parameters()}
    assert own == got
    assert all(p.device.type == "meta" for p in pm.parameters())


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_step_specs_match_reference(arch, shape):
    """The step's argument specs and axes — batch, cache (decode, with
    ``kv_seq`` at B 1 and 65536 tokens or more), optimizer state (train,
    zero2 both ways) — equal the reference's ``make_step``'s, in its
    order (params, state / cache, batch)."""
    rm, pm = _models(arch)
    rs, ps = RSHAPES[shape], INPUT_SHAPES[shape]
    assert _norm(pm.batch_specs(ps)) == _norm(rm.batch_specs(rs))
    assert pm.batch_axes(ps) == rm.batch_axes(rs)
    if ps.kind == "decode":
        r_sds, r_axes = rm.cache_specs(rs.global_batch, rs.seq_len)
        p_sds, p_axes = cache_specs_and_axes(pm, ps.global_batch, ps.seq_len)
        assert _norm(p_sds) == _norm(r_sds)
        assert p_axes == r_axes
    if ps.kind == "train":
        assert _norm(popt.abstract_state(pm.abstract_params())) == \
            _norm(ropt.abstract_state(rm.abstract_params()))
        for zero2 in (False, True):
            assert popt.state_axes(pm.param_axes(), zero2) == \
                ropt.state_axes(rm.param_axes(), zero2)
    _, r_sds, r_axes = rsteps.make_step(rm, rs, zero2=True)
    _, p_sds, p_axes = make_step(pm, ps, zero2=True)
    assert _norm(p_sds) == _norm(r_sds)
    assert p_axes == r_axes
    assert _norm(input_specs(pm, ps)) == _norm(rsteps.input_specs(rm, rs))


def _fake_mesh(sizes, names):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, sizes)))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_spec_matches_reference_for_every_parameter(multi_pod, fsdp):
    """``Rules.spec`` of every parameter of every arch on the production
    meshes equals the reference's (its Rules reads only the mesh's axis
    names and sizes, so a description stands in for 256 devices), and
    ``device_bytes`` divides by exactly the sharded axes' sizes."""
    mesh = pmesh.make_production_mesh(multi_pod)
    assert (mesh.axis_names, mesh.sizes) == (
        (("pod", "data", "model"), (2, 16, 16)) if multi_pod
        else (("data", "model"), (16, 16)))
    rrules = RRules(_fake_mesh(mesh.sizes, mesh.axis_names), fsdp=fsdp)
    prules = Rules(mesh, fsdp=fsdp)
    assert prules.table == rrules.table
    for arch in ARCH_IDS:
        rm, pm = _models(arch)
        axes, specs = pm.param_axes(), pm.abstract_params()
        got = spec_tree(Rules(mesh, fsdp=fsdp), axes, specs)

        def check(ax, sd):
            want = tuple(rrules.spec(ax, shape=sd[0]))
            assert prules.spec(ax, shape=sd[0]) == want, (arch, ax, sd)
            n = 1
            for m in want:
                for a in (m if isinstance(m, tuple) else (m,)):
                    n *= mesh.shape[a] if a else 1
            whole = torch.empty((), dtype=sd[1]).element_size()
            for s in sd[0]:
                whole *= s
            assert device_bytes(sd[0], sd[1], want, mesh) * n == whole
            return want

        assert map_specs(check, axes, specs) == got


def test_rules_spec_drops_indivisible():
    """The reference's rules cases: 36 heads on a 16-way model axis are
    replicated, 48 are sharded; a mesh axis appears once in a spec; no
    mesh means no sharding."""
    assert Rules(None).mesh is None
    mesh = make_mesh((16, 16), ("data", "model"))
    r = Rules(mesh)
    r.table = {"batch": "data", "heads": "model", "ff": "model"}
    assert r.spec(("batch", None, "heads", None),
                  shape=(256, 1, 36, 128))[2] is None
    assert r.spec(("batch", None, "heads", None),
                  shape=(256, 1, 48, 128))[2] == "model"
    spec = r.spec(("heads", "ff"), shape=(48, 1024))
    assert [s for s in spec if s == "model"] == ["model"]


def test_rules_resolve_against_the_mesh():
    """Axes the mesh lacks drop out ("pod" on one pod), fsdp maps
    "embed" to "data", overrides apply, and a mesh's name and size are
    the reference's record names."""
    one = Rules(make_mesh((16, 16), ("data", "model")))
    assert one.table["batch"] == ("data",) and one.table["embed"] is None
    two = Rules(pmesh.make_production_mesh(True), fsdp=True,
                overrides={"kv_seq": "data"})
    assert two.table["batch"] == ("pod", "data")
    assert two.table["embed"] == "data" and two.table["kv_seq"] == "data"
    assert set(DEFAULT_RULES) == set(one.table)
    assert pmesh.make_production_mesh(True).name == "2x16x16"
    assert pmesh.make_smoke_mesh().size == 1
    with pytest.raises(ValueError):
        MeshShape(("data",), (1, 2))


def test_h100_figures_and_peaks():
    """The card's published figures (NVIDIA's H100 SXM data sheet) and
    the peak each config type is priced at."""
    assert (pmesh.PEAK_FLOPS_BF16, pmesh.PEAK_FLOPS_TF32,
            pmesh.PEAK_FLOPS_FP32) == (989e12, 495e12, 67e12)
    assert (pmesh.HBM_BW, pmesh.NVLINK_BW, pmesh.CHIP_HBM_BYTES) == (
        3.35e12, 450e9, 80e9)
    assert pmesh.peak_flops("bfloat16") == 989e12
    assert pmesh.peak_flops("float32") == 67e12
    with pytest.raises(ValueError):
        pmesh.peak_flops("int8")


@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_1p2b", "rwkv6_1p6b",
                                  "seamless_m4t_large_v2", "hstu_gr"])
def test_prefill_returns_the_cache_its_specs_name(arch):
    """What a prefill returns is the cache ``cache_specs`` describes at
    the prompt's length (so the dry-run's decode arguments are what a
    server holds after a prefill), on meta at full config."""
    _, pm = _models(arch)
    shape = InputShape("p", 512, 2, "prefill")
    fn, arg_specs, _ = make_step(pm, shape)
    _, cache = fn(*step_inputs(shape, arg_specs, "meta"))
    want, _ = cache_specs_and_axes(pm, 2, 512)
    assert _norm(_as_specs(cache)) == _norm(want)


def _as_specs(t):
    if isinstance(t, torch.Tensor):
        return (tuple(t.shape), t.dtype)
    if isinstance(t, dict):
        return {k: _as_specs(v) for k, v in t.items()}
    return tuple(_as_specs(x) for x in t)


def test_dryrun_writes_the_reference_records(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun`` for hstu_gr at full size:
    one record per mesh with the reference record's keys, long_500k
    skipped as the reference skips it, the arguments per device shrinking
    with the mesh, and exit 0; then the roofline over those records."""
    assert dryrun.main(["--arch", "hstu_gr", "--out", str(tmp_path)]) == 0
    assert "all dry-runs passed" in capsys.readouterr().out
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert len(recs) == 12
    ok = recs["baseline__hstu_gr__train_4k__16x16.json"]
    for key in ("arch", "shape", "mesh", "params", "status", "fsdp",
                "jaxpr_flops_global", "memory", "collectives", "n_chips"):
        assert key in ok
    assert ok["status"] == "ok" and ok["n_chips"] == 256
    assert ok["collectives_reason"] is None
    for name, rec in recs.items():
        if rec["status"] == "ok":
            shape = INPUT_SHAPES[rec["shape"]]
            got = rec["collectives"]
            if shape.kind == "train":
                got = _closed_counts(got)
            assert got == _closed_form(get_config("hstu_gr"), shape,
                                       rec["mesh"]), name
    mem = ok["memory"]
    assert mem["temp_size_in_bytes"] is None and mem["temp_reason"]
    assert sum(mem["argument_parts"]) == mem["argument_size_in_bytes"]
    card = recs["baseline__hstu_gr__train_4k__1x1.json"]["memory"]
    assert card["argument_size_in_bytes"] > mem["argument_size_in_bytes"]
    assert card["argument_parts"][0] == sum(
        p.numel() * 4 for p in _models("hstu_gr")[1].parameters())
    skip = recs["baseline__hstu_gr__long_500k__2x16x16.json"]
    assert skip["status"] == "skipped" and "long_500k" in skip["reason"]

    from repro_torch.benchmarks import roofline
    mp = pytest.MonkeyPatch()
    mp.setattr(roofline, "ARTIFACTS", tmp_path)
    try:
        rows = roofline.load()
        assert [r["shape"] for r in rows] == ["decode_32k", "prefill_32k",
                                              "train_4k"]
        for r in rows:
            rec = recs[f"baseline__hstu_gr__{r['shape']}__16x16.json"]
            flops_chip = rec["jaxpr_flops_global"] / 256
            assert r["compute_s"] == round(flops_chip / 67e12, 6)
            m = rec["memory"]
            assert r["hbm_bytes_chip"] == (m["argument_size_in_bytes"]
                                           + m["output_size_in_bytes"])
            coll = rec["collectives"]["total_bytes"]
            assert r["coll_bytes_chip"] == coll
            assert r["collective_s"] == round(coll / pmesh.NVLINK_BW, 6)
            assert r["roofline_bound_s"] == max(r["compute_s"],
                                                r["memory_s"],
                                                r["collective_s"])
        assert len(roofline.load(mesh=None)) == 9
    finally:
        mp.undo()


# --- collectives: a closed form of what the model code calls ------------------


def _kinds(**counts):
    """A record's ``collectives`` from {kind: (count, bytes)}."""
    out = {k: {"count": 0, "bytes": 0} for k in (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")}
    for k, (n, b) in counts.items():
        out[k.replace("_", "-")] = {"count": n, "bytes": b}
    out["total_bytes"] = sum(v["bytes"] or 0 for v in out.values())
    return out


def _closed_form(cfg, shape, mesh_name, fsdp=False, zero2=False):
    """rank 0's collectives of one step of hstu-gr or qwen3_4b (full
    configs) on a (data, model) or (pod, data, model) mesh, fsdp off:

    * serve (prefill, decode: S tokens, 1 for decode): one all-reduce of
      the embedding (B_l S d) over "model" (vocab-parallel lookup), then
      per layer one of the attention's and one of the FFN's output where
      their heads / ff are sharded (qwen3: 32 heads and 9728 ff on 16);
      hstu-gr's 4 heads stay whole on 16, but ``ln_attn``'s 256 weights
      split, so each layer gathers them (one all-gather of 256 floats);
    * train: the forward's as above; under per-layer remat the
      recompute stops after the last op that saves a tensor, so it
      repeats a layer's attention all-reduce but not the FFN's; the
      backward sums over "model" the gradients of what enters a sharded
      product (the attention's and the FFN's input; qwen3's q_norm and
      k_norm; its wk and wv, whose 8 kv heads stay whole on 16); the CE
      over 512-token chunks, each (max, sum of exponentials, label
      logit) forward, (max, sum) in its recompute, and the gradient of
      its normed input; then the CE metric over the batch axes, one
      all-reduce of the gradients a type over them, and the global norm
      over "model".

    fsdp on ("embed" on "data": d 256 and 2560 split 16 ways), beside
    those: every weight with an "embed" dimension is gathered whole
    (its model shard) where it is read, one all-gather each: the top
    level's three (tok, final_norm, unembed) once a step, a layer's
    (hstu-gr: ln, uvqk, wo; qwen3: ln1, ln2, wq, wk, wv, wo and the
    FFN's wi, wg, wo) in its forward and, in a train step, again in
    its recompute; the backward reduce-scatters each one's gradient
    over "data" once (the top level's three and each layer's).  Serve
    bytes: those weights' bytes on one model shard, once
    (``_fsdp_bytes``).  The train step's tail changes with the specs:
    the gradients are summed over the batch axes their weight does not
    shard, one all-reduce a (type, axes) (hstu-gr: ln_attn over the
    batch axes, and on two pods the others over "pod": 1 / 2; qwen3:
    q_norm and k_norm, float32, over the batch axes, and on two pods
    the bf16 weights and the float32 norms over "pod": 1 / 3), and the
    global norm sums once over each set of axes a weight is sharded on
    (hstu-gr: {model} ln_attn, {data} ln, uvqk, wo and final_norm (its
    4 heads stay whole), {data, model} tok and unembed: 3; qwen3:
    {data} the norms, wk and wv (8 kv heads stay whole), {data, model}
    the rest: 2).

    ZeRO-2 adds to the plain train step the parameters' all-gather over
    "data" after the update, one a type (hstu-gr float32: 1; qwen3 bf16
    weights and float32 norms: 2)."""
    sizes = [int(x) for x in mesh_name.split("x")]
    if sizes[-1] == 1:
        rec = _kinds()
        return _closed_counts(rec) if shape.kind == "train" else rec
    n_batch = sizes[0] * (sizes[1] if len(sizes) == 3 else 1)
    L, d = cfg.n_layers, cfg.d_model
    isz = 4 if cfg.dtype == "float32" else 2
    S = 1 if shape.kind == "decode" else shape.seq_len
    act = shape.global_batch // n_batch * S * d * isz
    hstu = cfg.hstu
    two_pods = len(sizes) == 3
    n_g = (3 if hstu else 9) if fsdp else 0    # a layer's gathered weights
    top = 3 if fsdp else 0
    if shape.kind != "train":
        W = _fsdp_bytes(cfg, mesh_name) if fsdp else 0
        if hstu:
            return _kinds(all_reduce=(1, act), all_gather=(
                L + top + n_g * L, L * cfg.n_heads * cfg.head_dim * 4 + W))
        return _kinds(all_reduce=(1 + 2 * L, (1 + 2 * L) * act),
                      all_gather=(top + n_g * L, W))
    chunks = shape.seq_len // 512
    if not fsdp:
        grads, norm = (1 if hstu else 2), 1
    elif hstu:
        grads, norm = (2 if two_pods else 1), 3
    else:
        grads, norm = (3 if two_pods else 1), 2
    tail = 1 + grads + norm             # CE metric, gradients, norm
    gathers = top + 2 * n_g * L + (1 if hstu else 2) * zero2
    rs = (top + n_g * L, None)
    if hstu:
        return _closed_counts(_kinds(all_reduce=(1 + 6 * chunks + tail, None),
                                     all_gather=(2 * L + gathers, None),
                                     reduce_scatter=rs))
    per_layer = 2 + 1 + 2 + 2 * cfg.qk_norm + 2
    return _closed_counts(_kinds(all_reduce=(
        1 + per_layer * L + 6 * chunks + tail, None),
        all_gather=(gathers, None), reduce_scatter=rs))


def _fsdp_bytes(cfg, mesh_name):
    """The bytes, on one model shard, of every weight a serve step reads
    with an "embed" dimension (HSTU's task tower is not read): what
    fsdp's all-gathers of one prefill or decode step carry."""
    mesh = pmesh.make_production_mesh(multi_pod=mesh_name.count("x") == 2)
    rules = Rules(mesh)
    model = build_model(cfg, device="meta")
    return sum(device_bytes(s.shape, DTYPES[s.dtype],
                            rules.spec(s.axes, s.shape), mesh)
               for k, s in flat_specs(model.param_specs()).items()
               if "embed" in s.axes and not k.startswith("task_tower"))


def _closed_counts(rec):
    """A closed form that fixes the counts only (bytes None)."""
    return {k: v["count"] for k, v in rec.items() if isinstance(v, dict)}


def _check_closed_form(arch, shape, **kw):
    cfg = get_config(arch)
    for mesh in (pmesh.make_production_mesh(),
                 pmesh.make_production_mesh(multi_pod=True)):
        got = dryrun.trace_collectives(cfg, shape, mesh, **kw)
        want = _closed_form(cfg, INPUT_SHAPES[shape], mesh.name, **kw)
        if INPUT_SHAPES[shape].kind == "train":
            got = _closed_counts(got)
        assert got == want, (arch, shape, mesh.name, kw)


@pytest.mark.parametrize("arch", ["hstu_gr", "qwen3_4b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_collectives_equal_a_closed_form(arch, shape):
    """rank 0's tally on the meta device (``dryrun.trace_collectives``)
    on 16 x 16 and 2 x 16 x 16 against ``_closed_form``: counts and
    bytes of the serve steps, counts of the train step."""
    _check_closed_form(arch, shape)


@pytest.mark.parametrize("mode", ["fsdp", "zero2"])
@pytest.mark.parametrize("arch", ["hstu_gr", "qwen3_4b"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_fsdp_and_zero2_collectives_equal_a_closed_form(arch, shape, mode):
    """The same under fsdp (``trace_collectives(..., fsdp=True)``) and
    under ZeRO-2 (``zero2=True``): ``_closed_form``'s gathers,
    reduce-scatters and parameter all-gathers."""
    _check_closed_form(arch, shape, fsdp=mode == "fsdp",
                       zero2=mode == "zero2")


def test_records_outside_the_mesh_port_keep_null_collectives():
    """No record is left without its collectives: fsdp "on" and "zero2"
    records carry theirs, traced under their own rules and step, with a
    null ``collectives_reason``, as the SSM family and a kv_seq decode
    do; a zero2 train record's equal ``trace_collectives(...,
    zero2=True)`` and differ from the plain step's (the parameters'
    all-gather); a 1 x 1 record counts nothing."""
    rec = dryrun.run_combo("rwkv6_1p6b", "decode_32k", ["single"])[0]
    assert rec["collectives_reason"] is None
    assert rec["collectives"]["all-reduce"]["count"] > 0
    mesh = pmesh.make_production_mesh()
    rec = dryrun.run_combo("qwen3_4b", "decode_32k", ["single", "card"],
                           fsdp="on")
    assert rec[0]["fsdp"] is True and rec[0]["collectives_reason"] is None
    assert rec[0]["collectives"] == dryrun.trace_collectives(
        "qwen3_4b", "decode_32k", mesh, fsdp=True)
    assert rec[0]["collectives"]["all-gather"]["count"] > 0
    assert rec[1]["collectives"]["total_bytes"] == 0
    shape = InputShape("t", 4096, 32, "train")
    rec = dryrun.run_combo("hstu_gr", shape, ["single"], fsdp="zero2")[0]
    assert rec["fsdp"] == "zero2" and rec["collectives_reason"] is None
    want = dryrun.trace_collectives("hstu_gr", shape, mesh, zero2=True)
    assert rec["collectives"] == want
    assert want != dryrun.trace_collectives("hstu_gr", shape, mesh)
    rec = dryrun.run_combo("starcoder2_7b", "long_500k", ["single"])[0]
    assert rec["collectives_reason"] is None
    assert rec["collectives"]["all-reduce"]["count"] > 0
    rec = dryrun.run_combo("qwen3_4b", "decode_32k", ["card"])[0]
    assert rec["collectives"]["total_bytes"] == 0


def _serve_closed_form(cfg, shape, mesh_name):
    """rank 0's collectives of a prefill or decode step of zamba2_1p2b,
    rwkv6_1p6b, seamless_m4t_large_v2 or (long_500k) starcoder2 on a
    production mesh (model 16), fsdp off, kv_seq on "data" for a batch
    of one, from what the model code calls (B_l rows a rank, S tokens,
    1 for a decode; act = B_l S d bytes of the model's type):

    * every family: one all-reduce of the vocab-parallel embedding;
    * zamba2, a Mamba2 block: three all-gathers (the projection, B_l S
      (2 di + 2 N + H) elements; the conv weight, K (di + 2 N); the conv
      state, B_l (K - 1) (di + 2 N)), three all-reduces (the gated norm's
      float32 sum of squares, B_l S; w_out's and the FFN's act); a
      section's shared attention one all-reduce of act;
    * rwkv6, a layer: the ln_out norm's squares, w_out's act, the FFN's
      act;
    * seamless: an encoder layer two all-reduces of B_l F d (attention,
      FFN), a decoder layer three of act (self, cross, FFN);
    * a kv_seq decode, each ring layer: one pmax of the float32 lse
      (1, Hl) and two psums (the weighted outputs (1, 1, Hl, D), the
      weights (1, Hl)), Hl the rank's real heads (starcoder2_7b's 36
      padded to 48: 3 on rank 0), beside its model-axis all-reduces."""
    sizes = [int(x) for x in mesh_name.split("x")]
    n_batch = sizes[0] * (sizes[1] if len(sizes) == 3 else 1)
    B = shape.global_batch
    b = B // n_batch if B % n_batch == 0 else B
    S = 1 if shape.kind == "decode" else shape.seq_len
    d, isz = cfg.d_model, 2
    act = b * S * d * isz
    ar, ar_b, ag, ag_b = 1, act, 0, 0
    fam = cfg.family
    if fam == "hybrid":
        di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
        C = di + 2 * N
        L, n_sec = cfg.n_layers, cfg.n_layers // cfg.attn_every
        ag, ag_b = 3 * L, L * isz * (b * S * (2 * di + 2 * N + H) + K * C
                                    + b * (K - 1) * C)
        ar += 3 * L + n_sec
        ar_b += L * (b * S * 4 + 2 * act) + n_sec * act
        ring_layers = n_sec
    elif fam == "ssm_rwkv6":
        ar += 3 * cfg.n_layers
        ar_b += cfg.n_layers * (b * S * 4 + 2 * act)
        ring_layers = 0
    elif fam == "encdec":
        ar += 3 * cfg.n_layers
        ar_b += 3 * cfg.n_layers * act
        if shape.kind != "decode":
            ar += 2 * cfg.n_enc_layers
            ar_b += 2 * cfg.n_enc_layers * b * cfg.n_frontend_tokens * d * isz
        ring_layers = cfg.n_layers
    else:                                        # dense
        ar += 2 * cfg.n_layers
        ar_b += 2 * cfg.n_layers * act
        ring_layers = cfg.n_layers
    if shape.name == "long_500k" and ring_layers:
        hp = max(cfg.n_heads, cfg.head_pad)      # rank 0's real heads
        hl = min(hp // sizes[-1], cfg.n_heads)
        ar += 3 * ring_layers
        ar_b += ring_layers * 4 * (hl + hl * cfg.head_dim + hl)
    return _kinds(all_reduce=(ar, ar_b), all_gather=(ag, ag_b))


@pytest.mark.parametrize("arch,shape", [
    ("zamba2_1p2b", "prefill_32k"), ("zamba2_1p2b", "decode_32k"),
    ("zamba2_1p2b", "long_500k"), ("rwkv6_1p6b", "prefill_32k"),
    ("rwkv6_1p6b", "decode_32k"), ("rwkv6_1p6b", "long_500k"),
    ("seamless_m4t_large_v2", "prefill_32k"),
    ("seamless_m4t_large_v2", "decode_32k"),
    ("starcoder2_7b", "long_500k"), ("starcoder2_15b", "long_500k")])
def test_collectives_of_the_families_and_long_500k_equal_a_closed_form(
        arch, shape):
    """rank 0's tally on the meta device on 16 x 16 and 2 x 16 x 16
    (kv_seq on "data" for long_500k, as the dry-run sets it) against
    ``_serve_closed_form``: counts and bytes."""
    cfg = get_config(arch)
    s = INPUT_SHAPES[shape]
    ovr = {"kv_seq": "data"} if s.global_batch == 1 else None
    for mesh in (pmesh.make_production_mesh(),
                 pmesh.make_production_mesh(multi_pod=True)):
        got = dryrun.trace_collectives(cfg, shape, mesh, ovr)
        assert got == _serve_closed_form(cfg, s, mesh.name), (
            arch, shape, mesh.name)


def test_fsdp_auto_is_a_quarter_of_the_chips_memory():
    """The "auto" rule shards the weights over "data" once a device's
    share passes a quarter of its memory: the port's threshold is that
    share of the H100's 80 GB, as the reference's 4e9 is of the TPU
    v5e's 16e9 (ROADMAP Queue 3, item 32, kept on the port's side);
    dbrx_132b's 16.5 GB a device (132e9 bf16 weights over model 16)
    stays under it on both production meshes, and ``--fsdp on`` shards
    it."""
    assert dryrun.FSDP_AUTO_BYTES / pmesh.CHIP_HBM_BYTES == 0.25
    assert dryrun.FSDP_AUTO_SHARE == 4e9 / 16e9
    for m in ("single", "multi"):
        for mode, want in (("auto", False), ("on", True)):
            rec = dryrun.size_record("dbrx_132b", "decode_32k", m,
                                     _dbrx_traced(), fsdp=mode)
            assert rec["fsdp"] is want, (m, mode)


@functools.lru_cache(maxsize=None)
def _dbrx_traced():
    return dryrun.trace("dbrx_132b", "decode_32k")
