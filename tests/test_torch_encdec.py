"""The port's encoder-decoder (``EncDecModel``, SeamlessM4T-v2 style) and
cross-attention on the CPU, held against ``repro``'s.

Inputs: ``seamless_m4t_large_v2``'s smoke config (2 + 2 layers, d 128,
4 x 4 heads of 32, 8 frames), in float32 unless a case says otherwise.
Weights are initialised once in JAX; the norm weights (ones at init:
``ln1``, ``lnx``, ``ln2``, ``enc_norm``, ``final_norm``) get numpy noise
so that every term is live, and the same tree is loaded into the port
through ``convert.load_jax_params``.  Frame embeddings and token ids are
numpy-made from a seed.  The reference's init rule takes ``wq`` /
``wk``'s fan-in from the head count, so attention logits reach ~100
and a near one-hot softmax turns float32 reorderings into ~1e-5 output
differences: ``wq`` and ``wk`` (self and cross) are rescaled to fan-in
d, and one case keeps the reference's scale at a looser limit.

Tolerance: 1e-5 of the largest |value| of the tensor compared, in
float32 (1e-4 at the reference init's scale).  The bfloat16 case uses
2e-2: the frameworks round to bf16 at other places (XLA fuses the casts
of a product chain, PyTorch rounds after each op) and the decode's
cross-attention runs the ``decode_attn`` twin, whose softmax weights
stay float32 where the reference's ``_sdpa`` casts them to bf16.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.models import layers as jlayers
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro_torch.kernels import decode_attn as dk
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, get_config, layers
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.convert import load_jax_params, state_from_tree
from repro_torch.models.encdec import EncDecModel

torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"
REL = 1e-5
REL_INIT = 1e-4
BF16_REL = 2e-2


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget(ARCH, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _live_norms(params, rng):
    """Norm weights (ones at init) as 1 + 0.1 N(0, 1)."""
    groups = [(params, ("final_norm", "enc_norm")),
              (params["encoder"], ("ln1", "ln2")),
              (params["decoder"], ("ln1", "lnx", "ln2"))]
    for node, keys in groups:
        for key in keys:
            w = node[key]
            node[key] = (np.asarray(w, np.float32)
                         + 0.1 * rng.normal(size=w.shape)).astype(w.dtype)
    return params


def _unit_logits(params):
    """wq, wk (L, d, heads, hd) of every attention drawn at fan-in d
    instead of heads."""
    for attn in (params["encoder"]["attn"], params["decoder"]["attn"],
                 params["decoder"]["xattn"]):
        for key in ("wq", "wk"):
            w = attn[key]
            attn[key] = (np.asarray(w, np.float32)
                         * np.sqrt(w.shape[-2] / w.shape[-3])).astype(w.dtype)
    return params


_PAIRS = {}


def _pair(seed=0, init_scale=False, **kw):
    """(reference model, its numpy tree, the port's model on the CPU with
    the same weights), cached per arguments."""
    key = (seed, init_scale, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        kw.setdefault("dtype", "float32")
        jcfg, tcfg = _cfgs(**kw)
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
    fr = rng.normal(size=(2, cfg.n_frontend_tokens, cfg.d_model))
    toks = rng.integers(0, cfg.vocab, (2, S))
    jb = {"frames": jnp.asarray(fr.astype(np.float32)).astype(dtype),
          "tokens": jnp.asarray(toks)}
    tb = {"frames": torch.as_tensor(np.array(jb["frames"], np.float32)),
          "tokens": torch.as_tensor(toks)}
    return jb, tb


def _leaves(cache):
    """The cache in ``jax.tree.leaves`` order (keys sorted: "cross"
    first)."""
    return [*cache["cross"], *cache["self"]]


# --- configuration, registry and parameter tree ---------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_config_copy_matches_reference(arch, smoke):
    assert dataclasses.asdict(get_config(arch, smoke=smoke)) == \
        dataclasses.asdict(jget(arch, smoke=smoke))


def _spec_shapes(specs, prefix=""):
    """{state_dict name: (shape, dtype name)} of a ParamSpec tree (either
    package's)."""
    out = {}
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out.update(_spec_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = (tuple(v.shape), v.dtype)
    return out


def test_full_config_counts_the_reference_parameters():
    """At full size: 24 + 24 layers, d 1024, 16 x 16 heads of 64, GLU
    FFN of 8192, vocab 256206 padded to 256256, 1536 frames, bf16,
    ``attn_q_chunk`` 2048, 2.035 B by ``param_count``; the port's spec
    tree (what the model allocates) has the reference's names, shapes
    and types."""
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.glu, cfg.vocab,
            cfg.vocab_padded, cfg.n_frontend_tokens, cfg.dtype,
            cfg.attn_q_chunk) == (24, 24, 1024, 16, 16, 64, 8192, True,
                                  256206, 256256, 1536, "bfloat16", 2048)
    assert round(cfg.param_count() / 1e9, 3) == 2.035
    ns = SimpleNamespace(cfg=cfg)
    ns.enc_block_specs = lambda: EncDecModel.enc_block_specs(ns)
    ns.dec_block_specs = lambda: EncDecModel.dec_block_specs(ns)
    got = _spec_shapes(EncDecModel.param_specs(ns))
    assert got == _spec_shapes(jbuild(jget(ARCH)).param_specs())


def test_state_dict_names_mirror_the_reference_tree():
    """In the config's own bf16: every name and shape of the tree
    (``encoder.attn.wq``, ``decoder.xattn.wk``, ``enc_norm``...), every
    value carried bit for bit."""
    jcfg, tcfg = _cfgs()
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(7)))
    tm = build_model(tcfg, device="cpu")
    load_jax_params(tm, tree)
    flat = state_from_tree(tree)
    own = tm.state_dict()
    assert set(flat) == set(own)
    for name, arr in flat.items():
        assert tuple(arr.shape) == tuple(own[name].shape), name
        assert str(own[name].dtype).replace("torch.", "") == str(arr.dtype), \
            name
        assert np.array_equal(arr.astype(np.float32),
                              own[name].float().numpy()), name
    for name in ("encoder.attn.wq", "decoder.xattn.wk", "decoder.lnx",
                 "enc_norm"):
        assert name in own, name


def test_registry_builds_encdec():
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    assert isinstance(model, EncDecModel)
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        model.loss({"tokens": torch.zeros((1, 4), dtype=torch.long)})


# --- cross-attention -------------------------------------------------------------


def _attn_inputs(cfg, rng, S, F=8):
    p = {k: (rng.normal(size=s.shape) / np.sqrt(
        s.shape[0] if k != "wo" else s.shape[0] * s.shape[1])).astype(
            np.float32) for k, s in layers.attention_specs(cfg).items()}
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    ek, ev = (rng.normal(size=(2, F, cfg.n_kv_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    return p, x, ek, ev


@pytest.mark.parametrize("S,qk_norm", [(6, False), (1, False), (6, True),
                                       (1, True)])
def test_cross_attention_matches_reference(S, qk_norm):
    """``attention`` with ``kv_override`` against the reference's, at S
    queries (the prefill: plain ``_sdpa``) and at one query (the decode:
    the ``decode_attn`` twin on the CPU), at positions far from 0: no
    RoPE on q, ``q_norm`` applied, ``k_norm`` not, K/V handed back as
    given."""
    _, cfg = _cfgs(qk_norm=qk_norm, dtype="float32")
    rng = np.random.default_rng(11)
    p, x, ek, ev = _attn_inputs(cfg, rng, S)
    if qk_norm:
        p["q_norm"] = (1 + 0.3 * rng.normal(size=p["q_norm"].shape)).astype(
            np.float32)
        p["k_norm"] = (1 + 0.3 * rng.normal(size=p["k_norm"].shape)).astype(
            np.float32)
    pos = np.arange(S)[None, :] + 37
    jy, (jk, jv) = jlayers.attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg,
        positions=jnp.asarray(pos), kv_override=(jnp.asarray(ek),
                                                 jnp.asarray(ev)),
        causal=False)
    before = dk.launches
    ty, (tk, tv) = layers.attention(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        cfg, positions=torch.as_tensor(pos),
        kv_override=(torch.as_tensor(ek), torch.as_tensor(ev)), causal=False)
    assert dk.launches == before                 # the CPU twin ran
    _close(ty, jy)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("S", [6, 1])
def test_cross_attention_ignores_positions(S):
    """Neither q nor the given K/V is rotated: the output at positions 0
    and at positions 37.. is the same, bit for bit (a RoPE applied to the
    cross q would rotate it by the query's position)."""
    _, cfg = _cfgs(dtype="float32")
    assert cfg.rope_theta
    p, x, ek, ev = _attn_inputs(cfg, np.random.default_rng(12), S)
    p = {k: torch.as_tensor(v) for k, v in p.items()}
    run = lambda pos: layers.attention(
        p, torch.as_tensor(x), cfg, positions=torch.as_tensor(pos),
        kv_override=(torch.as_tensor(ek), torch.as_tensor(ev)),
        causal=False)[0]
    a = run(np.arange(S)[None, :])
    b = run(np.arange(S)[None, :] + 37)
    assert torch.equal(a, b)
    # the same weights through self-attention do depend on the positions
    self_a = layers.attention(p, torch.as_tensor(x), cfg,
                              positions=torch.arange(S)[None, :] + 1,
                              causal=False)[0]
    self_b = layers.attention(p, torch.as_tensor(x), cfg,
                              positions=torch.arange(S)[None, :] + 37,
                              causal=False)[0]
    assert S == 1 or not torch.allclose(self_a, self_b)


# --- encoder, prefill and decode against the reference ---------------------------


def test_encode_matches_reference():
    jm, params, tm = _pair()
    jb, tb = _batch(tm.cfg, np.random.default_rng(1), 4)
    _close(tm.encode(tb["frames"]), jax.jit(jm.encode)(params, jb["frames"]))


def test_prefill_matches_reference():
    """Last-position logits and every leaf of the cache: the self K/V
    of 2 x 20 tokens and the cross K/V projected from the encoder
    output (not from the ``lnx``-normed decoder stream)."""
    jm, params, tm = _pair()
    jb, tb = _batch(tm.cfg, np.random.default_rng(1), 20)
    jl, jc = jax.jit(jm.prefill)(params, jb)
    tl, tc = make_prefill_step(tm)(tb)
    _close(tl, jl)
    assert set(tc) == {"self", "cross"}
    jleaves = jax.tree.leaves(jc)
    assert len(jleaves) == 4
    for got, want in zip(_leaves(tc), jleaves):
        _close(got, want)
    cfg = tm.cfg
    assert tuple(tc["cross"][0].shape) == (cfg.n_layers, 2,
                                           cfg.n_frontend_tokens,
                                           cfg.n_kv_heads, cfg.head_dim)


def test_prefill_at_the_reference_init_scale():
    """wq / wk at the reference init's scale (attention logits ~100): a
    float32 reordering moves the logits further, so the limit is 1e-4."""
    jm, params, tm = _pair(init_scale=True)
    jb, tb = _batch(tm.cfg, np.random.default_rng(1), 20)
    jl, jc = jax.jit(jm.prefill)(params, jb)
    tl, tc = tm.prefill(tb)
    _close(tl, jl, REL_INIT)
    for got, want in zip(_leaves(tc), jax.tree.leaves(jc)):
        _close(got, want, REL_INIT)


def test_decode_steps_match_reference():
    """Prefill 2 x 12 tokens, then 3 steps at per-row positions past the
    ring's end (the rows wrap to different slots): logits each step, the
    self ring after (written in place) and the cross K/V (read only)."""
    jm, params, tm = _pair()
    rng = np.random.default_rng(2)
    jb, tb = _batch(tm.cfg, rng, 12)
    _, jc = jm.prefill(params, jb)
    _, tc = tm.prefill(tb)
    cross = [t.clone() for t in tc["cross"]]
    jstep = jax.jit(jm.decode_step)
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.array([12 + step, 17 + step], np.int32)
        jl, jc = jstep(params, jc, {"token": jnp.asarray(tok),
                                    "pos": jnp.asarray(pos)})
        tl, tc2 = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                      "pos": torch.as_tensor(pos)})
        assert all(a is b for a, b in zip(_leaves(tc2), _leaves(tc)))
        _close(tl, jl)
    for got, want in zip(_leaves(tc), jax.tree.leaves(jc)):
        _close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(tc["cross"], cross))


def test_bfloat16_prefill_and_decode_match_reference():
    """The config's own bf16, at BF16_REL: prefill logits and two decode
    steps (the frames bf16 on both sides)."""
    jm, params, tm = _pair(seed=1, dtype="bfloat16")
    rng = np.random.default_rng(6)
    jb, tb = _batch(tm.cfg, rng, 16, dtype=jnp.bfloat16)
    jl, jc = jm.prefill(params, jb)
    tl, tc = tm.prefill(tb)
    _close(tl, jl, BF16_REL)
    for step in range(2):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.full((2,), 16 + step, np.int32)
        jl, jc = jm.decode_step(params, jc, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tl, tc = tm.decode_step(tc, {"token": torch.as_tensor(tok),
                                     "pos": torch.as_tensor(pos)})
        _close(tl, jl, BF16_REL)


def test_relay_prefill_then_decode_equals_longer_prefill():
    """The decoder's psi reuse: prefill(P) into a ring of P + 1 slots,
    then decode(token P) at position P, gives prefill(P + 1)'s last
    logits (the same frames)."""
    _, _, tm = _pair(seed=2)
    rng = np.random.default_rng(7)
    _, tb = _batch(tm.cfg, rng, 11)
    full, _ = tm.prefill(tb)
    P = 10
    _, c = tm.prefill({"frames": tb["frames"], "tokens": tb["tokens"][:, :P]})
    ring = tm.init_cache(2, P + 1)
    for dst, src in zip(ring["self"], c["self"]):
        dst[:, :, :P] = src
    ring["cross"] = c["cross"]
    step, _ = tm.decode_step(ring, {"token": tb["tokens"][:, P:],
                                    "pos": torch.full((2,), P)})
    _close(step, full)


# --- specs, caches and steps -----------------------------------------------------


def test_cache_specs_and_init_cache_match_reference():
    """Shapes and types as the reference's ``cache_specs``; ``init_cache``
    zeros of them; the prefill's cache has the same shapes."""
    jcfg, tcfg = _cfgs()
    tm = build_model(tcfg, device="cpu")
    for S in (12, 40):
        jsds, _ = jbuild(jcfg).cache_specs(3, S)
        want = [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(jsds)]
        specs = tm.cache_specs(3, S)
        assert [(s, str(d).replace("torch.", ""))
                for s, d in _leaves(specs)] == want
        cache = tm.init_cache(3, S)
        assert [(tuple(t.shape), t.dtype) for t in _leaves(cache)] == \
            _leaves(specs)
        assert all(not t.any() for t in _leaves(cache))
    fr = torch.zeros((3, tcfg.n_frontend_tokens, tcfg.d_model))
    _, c = tm.prefill({"frames": fr,
                       "tokens": torch.zeros((3, 12), dtype=torch.long)})
    assert [tuple(t.shape) for t in _leaves(c)] == \
        [s for s, _ in _leaves(tm.cache_specs(3, 12))]


def test_batch_specs_match_reference():
    jcfg, tcfg = _cfgs()
    jm, tm = jbuild(jcfg), build_model(tcfg, device="cpu")
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        want = {k: (tuple(s.shape), str(s.dtype))
                for k, s in jm.batch_specs(JSHAPES[name]).items()}
        got = {k: (s, str(d).replace("torch.", ""))
               for k, (s, d) in tm.batch_specs(INPUT_SHAPES[name]).items()}
        assert got == want, name


def test_eager_serve_step_equals_decode_step():
    """``make_serve_step`` on the CPU (eager) is ``decode_step``: equal
    logits and caches, bit for bit, from two copies of one cache; the
    step updates the self ring in place and returns the same tensors."""
    _, _, tm = _pair()
    rng = np.random.default_rng(9)
    _, tb = _batch(tm.cfg, rng, 16)
    _, cache = make_prefill_step(tm)(tb)
    clone = lambda c: {k: tuple(t.clone() for t in v) for k, v in c.items()}
    a, b = clone(cache), clone(cache)
    step = make_serve_step(tm)
    for i in range(2):
        batch = {"token": tb["tokens"][:, i:i + 1],
                 "pos": torch.tensor([16 + i, 3])}
        la, a2 = step(a, batch)
        lb, b = tm.decode_step(b, batch)
        assert all(x is y for x, y in zip(_leaves(a2), _leaves(a)))
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
