"""The port's decoder-only Transformer (dense, MoE, VLM) on the CPU, held
against ``repro``'s.

Inputs: the smoke configs of the seven Transformer ids, in float32
unless a case says otherwise.  Weights are initialised once in JAX; the
norm weights (ones at init) are given numpy noise so that every term is
live, and the same tree is loaded into the port through
``convert.load_jax_params``.  Token ids and frontend embeddings are
numpy-made from a seed.  The reference's init rule takes a 3-d weight's
fan-in from its second-to-last axis, the head count of ``wq`` / ``wk``
(d, heads, hd), so at init q and k are ~sqrt(d / heads) times a unit
scale and the attention logits reach ~100 at smoke width: a softmax
that near one-hot turns float32 reorderings (1e-7) into output
differences of ~1e-5.  ``wq`` and ``wk`` are therefore rescaled to
fan-in d (logits O(1)); one case keeps the reference's scale at a
looser limit (``test_prefill_at_the_reference_init_scale``).

Tolerance: 1e-5 of the largest |value| of the tensor compared, in
float32.  Both sides compute in float32 but sum the projections in other
orders; the observed worst case is 1.3e-6 of the largest value.  The
bfloat16 cases (one per family) use 2e-2: the two frameworks round to
bf16 at other places (XLA fuses the casts of a product chain, PyTorch
rounds after each op), a difference of a few bf16 ulps (2**-8 each)
that two layers carry into the logits (observed at most 5.8e-3).  int8 cache entries are compared
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, get_config, layers, moe
from repro_torch.models.arch import TransformerModel
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.convert import load_jax_params, state_from_tree

torch.set_num_threads(1)

ARCHS = ["qwen3_4b", "yi_9b", "starcoder2_7b", "starcoder2_15b",
         "internvl2_2b", "deepseek_moe_16b", "dbrx_132b"]
FAMILY_ARCH = {"dense": "qwen3_4b", "moe": "deepseek_moe_16b",
               "vlm": "internvl2_2b"}
REL = 1e-5
BF16_REL = 2e-2


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _live_norms(params, rng):
    """Norm weights (ones at init) as 1 + 0.1 N(0, 1)."""
    for path in (("final_norm",), ("layers", "ln1"), ("layers", "ln2"),
                 ("layers", "attn", "q_norm"), ("layers", "attn", "k_norm")):
        node = params
        for key in path[:-1]:
            node = node[key]
        if path[-1] in node:
            w = node[path[-1]]
            node[path[-1]] = (np.asarray(w, np.float32) + 0.1 * rng.normal(
                size=w.shape)).astype(w.dtype)
    return params


def _unit_logits(params):
    """wq, wk (L, d, heads, hd) drawn at fan-in d instead of heads."""
    attn = params["layers"]["attn"]
    for key in ("wq", "wk"):
        w = attn[key]
        attn[key] = (np.asarray(w, np.float32)
                     * np.sqrt(w.shape[-2] / w.shape[-3])).astype(w.dtype)
    return params


_PAIRS = {}


def _pair(arch, seed=0, init_scale=False, **kw):
    """(reference model, its numpy tree, the port's model on the CPU with
    the same weights), cached per arguments; ``init_scale`` keeps the
    reference init's scale of wq / wk."""
    key = (arch, seed, init_scale, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        kw.setdefault("dtype", "float32")
        jcfg, tcfg = _cfgs(arch, **kw)
        jm = jbuild(jcfg)
        params = _live_norms(jax.tree.map(np.asarray,
                                          jm.init(jax.random.PRNGKey(seed))),
                             np.random.default_rng(seed))
        if not init_scale:
            params = _unit_logits(params)
        tm = build_model(tcfg, device="cpu")
        load_jax_params(tm, params)
        _PAIRS[key] = (jm, params, tm)
    return _PAIRS[key]


def _batch(cfg, rng, S, dtype=np.float32):
    toks = rng.integers(0, cfg.vocab, (2, S))
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}
    if cfg.family == "vlm":
        fe = rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
        fe = fe.astype(dtype)
        jb["frontend"] = jnp.asarray(fe)
        tb["frontend"] = torch.as_tensor(fe.astype(np.float32))
    return jb, tb


# --- configuration, registry and parameter tree ---------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch, smoke):
    dash = arch.replace("_", "-")
    assert dataclasses.asdict(get_config(dash, smoke=smoke)) == \
        dataclasses.asdict(jget(arch, smoke=smoke))


def test_registry_builds_every_transformer_id():
    for arch in ARCHS:
        model = build_model(get_config(arch, smoke=True), device="cpu")
        assert isinstance(model, TransformerModel), arch
    model = build_model(get_config("qwen3_4b", smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        model.loss({"tokens": torch.zeros((1, 4), dtype=torch.long)})


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_state_dict_names_mirror_the_reference_tree(family):
    """In the config's own bf16: every name and shape of the tree, every
    value carried bit for bit, the MoE router kept float32."""
    arch = FAMILY_ARCH[family]
    jm = jbuild(jget(arch, smoke=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tm = build_model(get_config(arch, smoke=True), device="cpu")
    load_jax_params(tm, tree)
    flat = state_from_tree(tree)
    own = tm.state_dict()
    assert set(flat) == set(own)
    for name, arr in flat.items():
        assert tuple(arr.shape) == tuple(own[name].shape), name
        assert np.array_equal(arr.astype(np.float32),
                              own[name].float().numpy()), name
    assert own["layers.attn.wq"].dtype == torch.bfloat16
    if family == "moe":
        assert own["layers.moe.router"].dtype == torch.float32
        assert "layers.moe.shared_wi" in own
    if family == "vlm":
        assert tuple(own["projector"].shape) == (tm.cfg.d_model,) * 2


# --- prefill and decode against the reference ----------------------------------


@pytest.mark.parametrize("arch,q_chunk", [(a, 0) for a in ARCHS]
                         + [("starcoder2_15b", 16)])
def test_prefill_matches_reference(arch, q_chunk):
    """80 tokens (past the 64-token window of starcoder2; a VLM prepends
    its frontend): last-position logits and every layer's K/V.  With
    ``attn_q_chunk`` 16 the q-chunked branch, windowed."""
    jm, params, tm = _pair(arch, attn_q_chunk=q_chunk)
    jb, tb = _batch(tm.cfg, np.random.default_rng(1), 80)
    jl, (jk, jv) = jax.jit(jm.prefill)(params, jb)
    tl, (tk, tv) = make_prefill_step(tm)(tb)
    _close(tl, jl)
    _close(tk, jk)
    _close(tv, jv)
    assert tk.shape == (tm.cfg.n_layers, 2,
                        80 + tm.cfg.n_frontend_tokens, tm.cfg.n_kv_heads,
                        tm.cfg.head_dim)


def test_prefill_at_the_reference_init_scale():
    """yi_9b (no qk-norm) with wq / wk at the reference init's scale:
    attention logits ~100, a float32 reordering moves the logits by up to
    1.5e-5 of the largest (observed), so the limit is 1e-4."""
    jm, params, tm = _pair("yi_9b", init_scale=True)
    jb, tb = _batch(tm.cfg, np.random.default_rng(1), 80)
    jl, jc = jax.jit(jm.prefill)(params, jb)
    tl, tc = tm.prefill(tb)
    _close(tl, jl, 1e-4)
    for got, want in zip(tc, jc):
        _close(got, want, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch):
    """Prefill 24 tokens, then 3 steps at per-row positions past the
    ring's end (the rows wrap to different slots): logits each step and
    the cache after (the port writes it in place)."""
    jm, params, tm = _pair(arch)
    rng = np.random.default_rng(2)
    jb, tb = _batch(tm.cfg, rng, 24)
    _, jc = jm.prefill(params, jb)
    _, tc = tm.prefill(tb)
    n = tc[0].shape[2]
    jstep = jax.jit(jm.decode_step)
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.array([n + step, n + step + 5], np.int32)
        jl, jc = jstep(params, jc, {"token": jnp.asarray(tok),
                                    "pos": jnp.asarray(pos)})
        tl, tc2 = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                      "pos": torch.as_tensor(pos)})
        assert all(a is b for a, b in zip(tc2, tc))
        _close(tl, jl)
    for got, want in zip(tc, jc):
        _close(got, want)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_head_pad_matches_reference(mode):
    """starcoder2_7b's smoke config (9 heads, kv 3) padded to 12 heads,
    as ``tests/test_perf_features.py`` sets it up; the padded heads'
    wq / wo are random, so a head mask that leaks or a kv group that
    shifts shows.  Decode launches on the 9 real heads."""
    jm, params, tm = _pair("starcoder2_7b", head_pad=12)
    assert tuple(tm.layers.attn.wq.shape[2:]) == (12, 32)
    rng = np.random.default_rng(3)
    jb, tb = _batch(tm.cfg, rng, 40)
    jl, jc = jm.prefill(params, jb)
    tl, tc = tm.prefill(tb)
    if mode == "prefill":
        _close(tl, jl)
        for got, want in zip(tc, jc):
            _close(got, want)
        return
    for step in range(2):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.array([40 + step, 43 + step], np.int32)
        jl, jc = jm.decode_step(params, jc, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tl, tc = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(tl, jl)


def test_head_pad_decode_pads_only_after_the_real_heads():
    """A decode through ``attention`` with 9 real heads padded to 12 (kv
    3) equals, bit for bit, the same weights cut to the 9 real heads
    without padding: the padded heads (large random weights here) add
    nothing, and real head h keeps kv head h // 3."""
    from repro_torch.kernels import decode_attn as dk
    cfg = dataclasses.replace(get_config("starcoder2_7b", smoke=True),
                              dtype="float32", head_pad=12)
    g = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s.shape, generator=g) * 10 ** (k in "wq wo")
              for k, s in layers.attention_specs(cfg).items()}
    x = torch.randn(2, 1, cfg.d_model, generator=g)
    pos = torch.tensor([20, 27])
    cache = tuple(torch.randn(2, 20, 3, 32, generator=g) for _ in range(2))

    def run(c, p):
        kv = tuple(t.clone() for t in cache)
        y, _ = layers.attention(p, x, c, positions=pos[:, None], cache=kv,
                                cache_index=pos)
        return y, kv

    real = {**params, "wq": params["wq"][:, :9].contiguous(),
            "wo": params["wo"][:9].contiguous()}
    before = dk.launches
    y, kv = run(cfg, params)
    assert dk.launches == before                     # the CPU twin ran
    want, want_kv = run(dataclasses.replace(cfg, head_pad=0), real)
    assert torch.equal(y, want)
    assert all(torch.equal(a, b) for a, b in zip(kv, want_kv))


def test_quantize_kv_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 2, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # an all-zero row
    for dt in (np.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt)
        jq, js = jlayers.quantize_kv(xj)
        tq, ts = layers.quantize_kv(torch.as_tensor(
            np.array(xj.astype(jnp.float32))).to(
                torch.float32 if dt is np.float32 else torch.bfloat16))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _close(layers.dequantize_kv(tq, ts, torch.float32),
               jlayers.dequantize_kv(jq, js, jnp.float32))


def test_kv_quant_decode_matches_reference():
    """The int8 ring: prefill unquantized, quantize it with the
    reference's ``quantize_kv`` into a 4-tuple cache, then 3 decode
    steps; logits each step, and after them the int8 K and V (exactly)
    and both scale tensors."""
    jm, params, tm = _pair("qwen3_4b", kv_quant=True)
    rng = np.random.default_rng(5)
    jb, tb = _batch(tm.cfg, rng, 20)
    _, (k, v) = jm.prefill(params, jb)
    (kq, ks), (vq, vs) = jlayers.quantize_kv(k), jlayers.quantize_kv(v)
    jc = (kq, vq, ks, vs)
    tc = tuple(torch.as_tensor(np.array(t)) for t in jc)
    assert [t.dtype for t in tc] == [torch.int8] * 2 + [torch.float32] * 2
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.array([20 + step, 31 + step], np.int32)
        jl, jc = jm.decode_step(params, jc, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tl, tc = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(tl, jl)
    assert np.array_equal(tc[0].numpy(), np.asarray(jc[0]))
    assert np.array_equal(tc[1].numpy(), np.asarray(jc[1]))
    _close(tc[2], jc[2])
    _close(tc[3], jc[3])


def test_kv_quant_decode_refuses_an_unquantized_cache():
    """Under ``kv_quant`` a decode handed the prefill's unquantized
    (k, v) raises a ValueError naming the int8 4-tuple layout (the
    reference silently runs unquantized on it)."""
    _, _, tm = _pair("qwen3_4b", kv_quant=True)
    _, kv = tm.prefill({"tokens": torch.zeros((2, 12), dtype=torch.long)})
    assert len(kv) == 2
    with pytest.raises(ValueError, match=r"int8 ring \(k int8, v int8, "
                                         r"k scales, v scales\)"):
        tm.decode_step(kv, {"token": torch.zeros((2, 1), dtype=torch.long),
                            "pos": torch.tensor([12, 12])})


def _int8_ring(k, v, slots, quantize):
    """``tests/test_perf_features.py::test_kv_quant_decode_within_
    tolerance``'s construction, in numpy for both sides: a ring of ``slots`` with the prefill's P entries quantized
    into its first P slots, zero int8 and unit scales after them."""
    L, B, P, KV, D = k.shape
    (kq, ks), (vq, vs) = quantize(k), quantize(v)
    ring = []
    for t, fill, dt in ((kq, 0, np.int8), (vq, 0, np.int8),
                        (ks, 1, np.float32), (vs, 1, np.float32)):
        r = np.full((L, B, slots) + tuple(t.shape[3:]), fill, dt)
        r[:, :, :P] = np.asarray(t)
        ring.append(r)
    return tuple(ring)


def test_kv_quant_ring_from_a_prefill_matches_reference():
    """The int8 ring built from each side's own prefill (15 tokens into
    16 slots, as the reference's kv_quant test builds it): the int8 K/V
    equal, the scales within REL; one decode step at position 15 gives
    the reference's logits and stays within the reference test's 2% of
    the unquantized decode."""
    jm, params, tm = _pair("qwen3_4b", kv_quant=True)
    jplain, _, tplain = _pair("qwen3_4b")
    toks = np.random.default_rng(12).integers(0, 500, (2, 16))
    _, (jk, jv) = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :15])})
    _, (tk, tv) = tm.prefill({"tokens": torch.as_tensor(toks[:, :15])})
    jring = _int8_ring(np.asarray(jk), np.asarray(jv), 16,
                       lambda t: tuple(map(np.asarray, jlayers.quantize_kv(
                           jnp.asarray(t)))))
    tring = _int8_ring(tk.numpy(), tv.numpy(), 16,
                       lambda t: tuple(x.numpy() for x in layers.quantize_kv(
                           torch.as_tensor(t))))
    assert np.array_equal(tring[0], jring[0])
    assert np.array_equal(tring[1], jring[1])
    _close(tring[2], jring[2])
    _close(tring[3], jring[3])
    batch = {"token": toks[:, 15:], "pos": np.full((2,), 15, np.int32)}
    jl, _ = jm.decode_step(params, tuple(map(jnp.asarray, jring)),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = tm.decode_step(tuple(map(torch.as_tensor, tring)),
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(tl, jl)
    assert len(tc) == 4 and tc[0].dtype == torch.int8
    ring = tuple(torch.zeros((t.shape[0], 2, 16) + tuple(t.shape[3:]))
                 for t in (tk, tv))
    for dst, src in zip(ring, (tk, tv)):
        dst[:, :, :15] = src
    lf, _ = tplain.decode_step(ring, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    assert ((lf - tl).abs().max() / lf.abs().max()).item() < 0.02


@pytest.mark.parametrize("family", ["dense", "moe", "vlm"])
def test_bfloat16_prefill_and_decode_match_reference(family):
    """The config's own bf16, at BF16_REL: prefill logits and two decode
    steps (a VLM's frontend made bf16 on both sides)."""
    arch = FAMILY_ARCH[family]
    jm, params, tm = _pair(arch, seed=1, dtype="bfloat16")
    rng = np.random.default_rng(6)
    jb, tb = _batch(tm.cfg, rng, 32, dtype=jnp.bfloat16)
    jl, jc = jm.prefill(params, jb)
    tl, tc = tm.prefill(tb)
    _close(tl, jl, BF16_REL)
    for step in range(2):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.full((2,), tc[0].shape[2] + step, np.int32)
        jl, jc = jm.decode_step(params, jc, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tl, tc = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(tl, jl, BF16_REL)


# --- MoE --------------------------------------------------------------------------


def _routing_counts(x, router, k):
    """Slots sent to each expert (numpy, float64 routing)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    eidx = np.argsort(-logits, axis=-1)[:, :k]
    return np.bincount(eidx.ravel(), minlength=router.shape[1])


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_moe_ffn_matches_reference(capacity_factor, monkeypatch):
    """``moe_ffn`` (output, and ``moe_aux`` of its routing) and
    ``shared_expert_ffn`` at the reference's capacity factor and at one
    small enough that slots drop (both modules patched alike)."""
    monkeypatch.setattr(jmoe, "CAPACITY_FACTOR", capacity_factor)
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", capacity_factor)
    jcfg, tcfg = _cfgs("deepseek_moe_16b", dtype="float32")
    p = {k: np.asarray(v) for k, v in jlayers.init_tree(
        jmoe.moe_specs(jcfg), jax.random.PRNGKey(8)).items()}
    assert set(p) == set(moe.moe_specs(tcfg))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 24, tcfg.d_model)).astype(np.float32)
    T, k, E = 48, tcfg.top_k, tcfg.n_experts
    cap = int(T * k / E * capacity_factor) + 1
    dropped = _routing_counts(x, p["router"], k).max() > cap
    assert dropped == (capacity_factor < 1)
    jy, jaux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                            jcfg)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    ty, routing = moe.moe_ffn(tp, torch.as_tensor(x), tcfg)
    taux = moe.moe_aux(*routing, tcfg)
    _close(ty, jy)
    assert taux.dtype == torch.float32
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    _close(moe.shared_expert_ffn(tp, torch.as_tensor(x), tcfg),
           jmoe.shared_expert_ffn(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jcfg))


# --- specs, caches and steps -----------------------------------------------------


@pytest.mark.parametrize("arch,kw", [("qwen3_4b", {}),
                                     ("starcoder2_7b", {}),
                                     ("qwen3_4b", {"kv_quant": True})])
def test_cache_specs_match_reference_and_prefill(arch, kw):
    """Shapes and types as the reference's ``cache_specs`` (a ring of
    min(S, window) slots; int8 plus float32 scales under ``kv_quant``);
    ``init_cache`` zeros of them; at S <= window the prefill's K/V have
    the same shapes."""
    jcfg, tcfg = _cfgs(arch, **kw)
    tm = build_model(tcfg, device="cpu")
    for S in (40, 100):
        jsds, _ = jbuild(jcfg).cache_specs(3, S)
        want = [(tuple(s.shape), str(s.dtype)) for s in jsds]
        specs = tm.cache_specs(3, S)
        assert [(s, str(d).replace("torch.", "")) for s, d in specs] == want
        cache = tm.init_cache(3, S)
        assert [(tuple(t.shape), t.dtype) for t in cache] == list(specs)
        assert all(not t.any() for t in cache)
    _, (k, v) = tm.prefill({"tokens": torch.zeros((3, 40), dtype=torch.long)})
    assert tuple(k.shape) == tuple(v.shape) == tm.cache_specs(3, 40)[0][0]


@pytest.mark.parametrize("arch", ["qwen3_4b", "internvl2_2b"])
def test_batch_specs_match_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jm, tm = jbuild(jcfg), build_model(tcfg, device="cpu")
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        want = {k: (tuple(s.shape), str(s.dtype))
                for k, s in jm.batch_specs(JSHAPES[name]).items()}
        got = {k: (s, str(d).replace("torch.", ""))
               for k, (s, d) in tm.batch_specs(INPUT_SHAPES[name]).items()}
        assert got == want, name


@pytest.mark.parametrize("arch", ["qwen3_4b", "deepseek_moe_16b"])
def test_eager_serve_step_equals_decode_step(arch):
    """``make_serve_step`` on the CPU (eager) is ``decode_step``: equal
    logits and caches, bit for bit, from two copies of one cache; the
    step updates the cache in place and returns it."""
    _, _, tm = _pair(arch)
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, 500, (2, 16)))
    logits, cache = make_prefill_step(tm)({"tokens": toks})
    a, b = tuple(t.clone() for t in cache), tuple(t.clone() for t in cache)
    step = make_serve_step(tm)
    for i in range(2):
        batch = {"token": toks[:, i:i + 1], "pos": torch.tensor([16 + i, 3])}
        la, a2 = step(a, batch)
        lb, b = tm.decode_step(b, batch)
        assert all(x is y for x, y in zip(a2, a))
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
