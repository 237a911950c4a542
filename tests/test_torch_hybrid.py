"""The port's Zamba2 hybrid on the CPU, held against ``repro``'s.

Inputs: a float32 variant of ``zamba2_1p2b``'s smoke config with
``n_layers=5`` and ``attn_every=2`` — two sections, each with its
shared-attention call, and a one-layer tail.  Weights are initialised
once in JAX; ``lora_b`` (zeros at init), ``A_log``, ``dt_bias`` and ``D``
are overwritten with numpy noise so that every term is live, and the
same tree is loaded into the port through ``convert.load_jax_params``.
Token ids are numpy-made.

Tolerance: 5e-4 of the largest |value| of the tensor compared.  Both
sides compute in float32, but XLA and PyTorch sum the projections and
the SSD contractions in different orders, and the recurrent state and
the residual stream carry the differences layer to layer; the observed
worst case is ~1e-4 of the largest value.  Layer-level comparisons
(``attention``, ``ffn``, ``mamba2_*``) use the same bound.
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
from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, get_config
from repro_torch.models import layers, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_jax_params, state_from_tree

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

REL = 5e-4


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _cfgs(**kw):
    jcfg = dataclasses.replace(jget("zamba2_1p2b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _live_noise(params, rng):
    """Overwrite the leaves whose init would leave a term dead or
    trivial: the LoRA's zero B, and the SSM's A_log, dt_bias and D."""
    params["shared_attn"]["lora_b"] = (
        rng.normal(size=params["shared_attn"]["lora_b"].shape) * 0.1
    ).astype(np.float32)
    for group in ("sections", "tail"):
        mixer = params[group]["mixer"]
        for key, scale, offset in (("A_log", 0.5, 0.0), ("dt_bias", 0.5, 0.0),
                                   ("D", 0.5, 1.0)):
            mixer[key] = (rng.normal(size=mixer[key].shape) * scale
                          + offset).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _cfgs(n_layers=5, attn_every=2, dtype="float32")
    jm = jbuild(jcfg)
    params = _live_noise(jax.tree.map(np.asarray,
                                      jm.init(jax.random.PRNGKey(0))),
                         np.random.default_rng(0))
    tm = build_model(tcfg, device="cpu")
    load_jax_params(tm, params)
    assert (tm.n_sections, tm.n_tail) == (2, 1)
    return jm, params, tm


def _cache_leaves(cache):
    """The port's cache in the order of ``jax.tree.leaves`` of the
    reference's (dict keys sorted: "a" before "m")."""
    m = cache["m"]
    return [*cache["a"], *m["sections"], *m["tail"]]


# --- configuration, registry and parameter tree -----------------------------------


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    assert dataclasses.asdict(get_config("zamba2-1.2b", smoke=smoke)) == \
        dataclasses.asdict(jget("zamba2-1.2b", smoke=smoke))


def test_other_families_still_raise():
    """Every family builds and has a loss (the hybrid's neighbours, the
    SSM stacks, too; held against the reference in
    ``tests/test_torch_lm_train_ssm.py``); an unknown family raises."""
    for family in ("hybrid", "ssm_rwkv6", "ssm_mamba2"):
        cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True),
                                  family=family)
        model = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        loss, metrics = model.loss(
            {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.ones((1, 4), dtype=torch.long)})
        assert loss.dim() == 0 and torch.isfinite(loss), family
        assert set(metrics) == {"ce"}
    cfg = dataclasses.replace(get_config("zamba2_1p2b", smoke=True),
                              family="no_such_family")
    with pytest.raises(KeyError):
        build_model(cfg, device="cpu")


def test_state_dict_names_mirror_the_reference_tree(pair):
    _, params, tm = pair
    tree = state_from_tree(params)
    own = tm.state_dict()
    assert set(tree) == set(own)
    for k, v in tree.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    # sections are stacked twice: (n_sections, attn_every, ...)
    assert tuple(own["sections.mixer.w_in"].shape[:2]) == (2, 2)


def test_cache_specs_match_reference(pair):
    jm, _, tm = pair
    jsds, _ = jm.cache_specs(3, 40)
    want = [(tuple(s.shape), str(s.dtype)) for s in jax.tree.leaves(jsds)]
    cache = tm.init_cache(3, 40)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in _cache_leaves(cache)]
    assert got == want
    assert all(float(t.abs().sum()) == 0 for t in _cache_leaves(cache))


def test_init_draws_every_parameter_from_the_generator():
    _, tcfg = _cfgs(n_layers=3, attn_every=2)
    a = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build_model(tcfg, device="cpu").init(torch.Generator().manual_seed(5))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa.float()).all(), name
    assert float(a.shared_attn.lora_b.abs().sum()) == 0     # zeros, as in JAX
    assert a.tok.dtype == torch.bfloat16


# --- the bridge -----------------------------------------------------------------


def test_bfloat16_tree_loads_through_the_bridge():
    """The smoke config at its default bfloat16: JAX's leaves arrive as
    ``ml_dtypes`` numpy arrays, which torch cannot read directly; the
    bridge goes through float32 and every value survives exactly."""
    jcfg, tcfg = _cfgs()
    assert tcfg.dtype == "bfloat16"
    params = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(3)))
    tree = state_from_tree(params)
    assert any(v.dtype.name == "bfloat16" for v in tree.values())
    tm = load_jax_params(build_model(tcfg, device="cpu"), params)
    own = tm.state_dict()
    for name, arr in tree.items():
        assert own[name].dtype == torch.bfloat16 or arr.dtype == np.float32
        np.testing.assert_array_equal(own[name].float().numpy(),
                                      arr.astype(np.float32), err_msg=name)


def test_float16_leaves_load_through_float32():
    import torch.nn as nn
    m = nn.Module()
    m.w = nn.Parameter(torch.zeros(3, dtype=torch.float16), requires_grad=False)
    arr = np.array([0.5, -1.25, 3.0], np.float16)
    load_jax_params(m, {"w": arr})
    assert m.w.tolist() == [0.5, -1.25, 3.0]


# --- the model against the reference --------------------------------------------------


@pytest.mark.parametrize("L", [64, 256])
def test_prefill_and_decode_match_reference(pair, L):
    """Prefill (one chunk at L = 64, two at 256) through the step
    factories: last-position logits and every cache leaf; then 3 decode
    steps against the returned cache."""
    jm, params, tm = pair
    rng = np.random.default_rng(L)
    toks = rng.integers(0, tm.cfg.vocab, (2, L))
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, tc = make_prefill_step(tm)({"tokens": torch.as_tensor(toks)})
    _close(tl, jl)
    jleaves = jax.tree.leaves(jc)
    tleaves = _cache_leaves(tc)
    assert len(jleaves) == len(tleaves) == 6
    for got, want in zip(tleaves, jleaves):
        _close(got, want)
    serve = make_serve_step(tm)
    for step in range(3):
        tok = rng.integers(0, tm.cfg.vocab, (2, 1))
        pos = np.array([L + step, L + step + 5], np.int32)   # rows wrap apart
        jl, jc = jm.decode_step(params, jc, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos)})
        tl, tc = serve(tc, {"token": torch.as_tensor(tok),
                            "pos": torch.as_tensor(pos)})
        _close(tl, jl)
    for got, want in zip(_cache_leaves(tc), jax.tree.leaves(jc)):
        _close(got, want)


def test_steps_are_the_model_methods(pair):
    _, _, tm = pair
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 500, (2, 64)))
    a_logits, a_cache = make_prefill_step(tm)({"tokens": toks})
    b_logits, b_cache = tm.prefill({"tokens": toks})
    assert torch.equal(a_logits, b_logits)
    batch = {"token": toks[:, :1], "pos": torch.full((2,), 64)}
    a2, _ = make_serve_step(tm)(a_cache, batch)
    b2, _ = tm.decode_step(b_cache, batch)
    assert torch.equal(a2, b2)


def test_decode_writes_the_ring_in_place(pair):
    """The deliberate difference from the reference: the new K/V land in
    the caller's cache tensors, which ``decode_step`` hands back."""
    _, _, tm = pair
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 500, (2, 64)))
    _, cache = tm.prefill({"tokens": toks})
    k_before = cache["a"][0].clone()
    _, new = tm.decode_step(cache, {"token": toks[:, :1],
                                    "pos": torch.tensor([64, 70])})
    assert new["a"][0] is cache["a"][0]
    changed = (cache["a"][0] != k_before).any(-1).any(-1)   # (n_sec, B, S)
    assert changed[:, 0].nonzero()[:, 1].unique().tolist() == [0]
    assert changed[:, 1].nonzero()[:, 1].unique().tolist() == [6]


# --- layers against the reference -------------------------------------------------------


def _layer_params(params, group, *idx):
    return jax.tree.map(lambda a: a[idx], params[group])


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_matches_reference(pair, L, with_state):
    jm, params, tm = pair
    cfg = tm.cfg
    rng = np.random.default_rng(L + with_state)
    p = _layer_params(params, "sections", 1, 1)["mixer"]
    u = rng.normal(size=(2, L, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = (rng.normal(size=(2, cfg.n_ssm_heads, cfg.ssm_state,
                                  cfg.ssm_head_dim)).astype(np.float32),
                 rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner
                                  + 2 * cfg.ssm_state)).astype(np.float32))
    jy, (js, jconv) = jssm.mamba2_forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(u), jm.cfg,
        None if state is None else tuple(map(jnp.asarray, state)))
    ty, (ts, tconv) = ssm.mamba2_forward(
        jax.tree.map(torch.as_tensor, p), torch.as_tensor(u), cfg,
        None if state is None else tuple(map(torch.as_tensor, state)))
    _close(ty, jy)
    _close(ts, js)
    _close(tconv, jconv)


def test_mamba2_decode_matches_reference(pair):
    jm, params, tm = pair
    cfg = tm.cfg
    rng = np.random.default_rng(9)
    p = _layer_params(params, "tail", 0)["mixer"]
    u = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    state = (rng.normal(size=(2, cfg.n_ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim)).astype(np.float32),
             rng.normal(size=(2, cfg.ssm_conv - 1, cfg.d_inner
                              + 2 * cfg.ssm_state)).astype(np.float32))
    jy, jst = jssm.mamba2_decode(jax.tree.map(jnp.asarray, p), jnp.asarray(u),
                                 jm.cfg, tuple(map(jnp.asarray, state)))
    ty, tst = ssm.mamba2_decode(jax.tree.map(torch.as_tensor, p),
                                torch.as_tensor(u), cfg,
                                tuple(map(torch.as_tensor, state)))
    _close(ty, jy)
    for a, b in zip(tst, jst):
        _close(a, b)


@pytest.mark.parametrize("L", [100, 128, 200, 384])
def test_mamba2_forward_takes_only_what_the_reference_can(pair, L):
    """L <= 128 or a multiple of 128 runs; anything else raises (the
    reference's chunk reshape fails there too) — nothing is padded."""
    _, params, tm = pair
    p = jax.tree.map(torch.as_tensor, _layer_params(params, "tail", 0)["mixer"])
    u = torch.zeros(1, L, tm.cfg.d_model)
    if L <= 128 or L % 128 == 0:
        y, _ = ssm.mamba2_forward(p, u, tm.cfg)
        assert y.shape == (1, L, tm.cfg.d_model)
    else:
        with pytest.raises(ValueError, match="multiple of 128"):
            ssm.mamba2_forward(p, u, tm.cfg)


def _attn_cfg(**kw):
    base = dict(name="attn-test", family="dense", n_layers=1, d_model=64,
                vocab=256, n_heads=4, n_kv_heads=2, head_dim=16,
                qk_norm=True, attn_q_chunk=16, dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _attn_params(jcfg, seed):
    specs = jlayers.attention_specs(jcfg)
    tree = jlayers.init_tree(specs, jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("S,prefix_len,window", [(24, 0, 0), (64, 0, 0),
                                                 (24, 0, 8), (64, 0, 12)])
def test_attention_prefill_matches_reference(S, prefix_len, window):
    """GQA with qk-norm and RoPE; S = 64 >= 4 * attn_q_chunk takes the
    q-chunked branch, S = 24 the masked one.  No ``prefix_len``: the
    reference's mask gains a fifth axis with one, in both branches."""
    jcfg, tcfg = _attn_cfg()
    p = _attn_params(jcfg, S)
    rng = np.random.default_rng(S + prefix_len + window)
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    pos = np.arange(S)[None, :]
    jy, (jk, jv) = jlayers.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        positions=jnp.asarray(pos), prefix_len=prefix_len, window=window)
    ty, (tk, tv) = layers.attention(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        tcfg, positions=torch.as_tensor(pos), prefix_len=prefix_len,
        window=window)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("n_kv", [1, 2, 4])
def test_attention_decode_matches_reference(n_kv):
    """One query per row over a ring of 40 slots (no tile divides it),
    rows at different positions; the reference rewrites the cache, the
    port writes the one slot in place — the caches come out equal."""
    jcfg, tcfg = _attn_cfg(n_kv_heads=n_kv)
    p = _attn_params(jcfg, n_kv)
    rng = np.random.default_rng(n_kv)
    Sc = 40
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, Sc, n_kv, 16)).astype(np.float32)
    cv = rng.normal(size=(2, Sc, n_kv, 16)).astype(np.float32)
    idx = np.array([41, 7], np.int32)
    jy, (jk, jv) = jlayers.attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg,
        positions=jnp.asarray(idx[:, None]),
        cache=(jnp.asarray(ck), jnp.asarray(cv)), cache_index=jnp.asarray(idx))
    tck, tcv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    ty, (tk, tv) = layers.attention(
        {k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x),
        tcfg, positions=torch.as_tensor(idx[:, None]), cache=(tck, tcv),
        cache_index=torch.as_tensor(idx))
    assert tk is tck and tv is tcv
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("option", ["kv_quant", "head_pad"])
def test_attention_refuses_unported_options(option):
    """Both options are ported: each one's ``attention_specs`` has the
    reference's keys, shapes and types (``head_pad`` 8 over 4 heads pads
    wq / wo to 8; ``kv_quant`` changes only the cache)."""
    jcfg, tcfg = _attn_cfg(**{option: True if option == "kv_quant" else 8})
    want = jlayers.attention_specs(jcfg)
    got = layers.attention_specs(tcfg)
    assert set(got) == set(want)
    for k, spec in got.items():
        assert (spec.shape, spec.dtype) == (want[k].shape, want[k].dtype), k
    assert got["wq"].shape[1] == (8 if option == "head_pad" else 4)


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("relu", False)])
def test_ffn_matches_reference(act, glu):
    jcfg, tcfg = _attn_cfg(act=act, glu=glu, d_ff=96)
    specs = jlayers.ffn_specs(jcfg)
    p = {k: np.asarray(v) for k, v in
         jlayers.init_tree(specs, jax.random.PRNGKey(4)).items()}
    assert set(p) == set(layers.ffn_specs(tcfg))
    x = np.random.default_rng(4).normal(size=(2, 5, 64)).astype(np.float32)
    _close(layers.ffn({k: torch.as_tensor(v) for k, v in p.items()},
                      torch.as_tensor(x), tcfg),
           jlayers.ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg))
