"""The port's attention-free SSM stacks (``SSMModel``: RWKV6 and Mamba2) on
the CPU, held against ``repro``'s.

Inputs: ``rwkv6_1p6b``'s smoke config (2 layers, d 128, two heads of 64)
and an ``ssm_mamba2`` stack built from ``zamba2_1p2b``'s smoke config by
``dataclasses.replace(family="ssm_mamba2")`` in both packages, in
float32 unless a case says otherwise.  Weights are initialised once in
JAX; the leaves whose init leaves a term dead or trivial get numpy
noise (the norm weights, RWKV6's ``mu``, ``w0``, ``u`` and the LoRA's
zero ``w_lora_b``; Mamba2's ``A_log``, ``dt_bias`` and ``D``), and the
same tree is loaded into the port through ``convert.load_jax_params``.
Token ids and the recurrent states handed in are numpy-made from a
seed.

Tolerance: 1e-5 of the largest |value| of the tensor compared, in
float32.  Both sides compute in float32 and sum in other orders; the
WKV state and the residual stream carry the differences from token to
token.  The bfloat16 cases (one per family) use 4e-2: the frameworks
round to bf16 at other places (XLA fuses the casts of a product chain
and the causal convolution's four-term sum, PyTorch rounds after each
op), a few bf16 ulps (2**-8 each) that the recurrent state and two
layers carry into the logits; observed at most 1.5e-2 (RWKV6) and
2.0e-2 (Mamba2) of the largest |logit| over three seeds.
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
from repro.models import ssm as jssm
from repro.models.config import INPUT_SHAPES as JSHAPES
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import build_model, get_config, ssm
from repro_torch.models.arch import SSMModel
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.convert import load_jax_params, state_from_tree

torch.set_num_threads(1)

REL = 1e-5
BF16_REL = 4e-2
FAMILIES = ["ssm_rwkv6", "ssm_mamba2"]


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _cfgs(family, **kw):
    """(reference config, port config) of ``family``, equal field for
    field: rwkv6_1p6b's smoke config, or zamba2_1p2b's with the family
    replaced."""
    if family == "ssm_mamba2":
        kw = dict(kw, family="ssm_mamba2")
        arch = "zamba2_1p2b"
    else:
        arch = "rwkv6_1p6b"
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def _noise(node, key, rng, scale, offset=None):
    w = node[key]
    base = np.asarray(w, np.float32) if offset is None else offset
    node[key] = (base + scale * rng.normal(size=w.shape)).astype(w.dtype)


def _live(params, rng):
    """Give every term a live, non-trivial value (see the module doc)."""
    for key in ("final_norm",):
        _noise(params, key, rng, 0.1)
    layers_ = params["layers"]
    for key in ("ln1", "ln2"):
        _noise(layers_, key, rng, 0.1)
    mixer = layers_["mixer"]
    if "mu" in mixer:                                   # RWKV6
        _noise(mixer, "mu", rng, 0.2)
        _noise(mixer, "w0", rng, 0.5)
        _noise(mixer, "u", rng, 0.3)
        _noise(mixer, "ln_out", rng, 0.1)
        _noise(mixer, "w_lora_b", rng, 0.1, offset=0.0)
    else:                                               # Mamba2
        _noise(mixer, "A_log", rng, 0.5, offset=0.0)
        _noise(mixer, "dt_bias", rng, 0.5, offset=0.0)
        _noise(mixer, "D", rng, 0.5, offset=1.0)
        _noise(mixer, "norm", rng, 0.1)
    return params


_PAIRS = {}


def _pair(family, seed=0, **kw):
    """(reference model, its numpy tree, the port's model on the CPU with
    the same weights), cached per arguments."""
    key = (family, seed, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        kw.setdefault("dtype", "float32")
        jcfg, tcfg = _cfgs(family, **kw)
        jm = jbuild(jcfg)
        params = _live(jax.tree.map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed))),
                       np.random.default_rng(seed))
        tm = build_model(tcfg, device="cpu")
        load_jax_params(tm, params)
        _PAIRS[key] = (jm, params, tm)
    return _PAIRS[key]


def _tokens(cfg, rng, S, B=2):
    toks = rng.integers(0, cfg.vocab, (B, S))
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.as_tensor(toks)}


def _step(cfg, rng, pos):
    tok = rng.integers(0, cfg.vocab, (2, 1))
    pos = np.asarray(pos, np.int32)
    return ({"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
            {"token": torch.as_tensor(tok), "pos": torch.as_tensor(pos)})


# --- configuration, registry and parameter tree ---------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["rwkv6_1p6b", "rwkv6-1.6b"])
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
    """rwkv6_1p6b at full size: 24 layers, d 2048, 32 heads of 64, ReLU
    FFN of 7168, vocab 65536, bf16, 1.483 B by ``param_count``; the
    port's spec tree (what the model allocates) has the reference's
    names, shapes and types."""
    cfg = get_config("rwkv6_1p6b")
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // ssm.RWKV_HEAD,
            cfg.d_ff, cfg.vocab, cfg.glu, cfg.act, cfg.dtype) == \
        (24, 2048, 32, 7168, 65536, False, "relu", "bfloat16")
    assert round(cfg.param_count() / 1e9, 3) == 1.483
    ns = SimpleNamespace(cfg=cfg, is_mamba=False)
    ns.block_specs = lambda: SSMModel.block_specs(ns)
    got = _spec_shapes(SSMModel.param_specs(ns))
    assert got == _spec_shapes(jbuild(jget("rwkv6_1p6b")).param_specs())
    n = sum(int(np.prod(shape)) for shape, _ in got.values())
    assert n == 1_483_180_032, n       # param_count leaves out mu, w0, u, ln_out


@pytest.mark.parametrize("family", FAMILIES)
def test_state_dict_names_mirror_the_reference_tree(family):
    """In the config's own bf16: every name and shape of the tree, every
    value carried bit for bit (``mu``, ``w0``, ``u``, ``A_log``... stay
    float32)."""
    jcfg, tcfg = _cfgs(family)
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
    if family == "ssm_rwkv6":
        assert own["layers.mixer.mu"].dtype == torch.float32
        assert own["layers.mixer.wr"].dtype == torch.bfloat16
        assert tuple(own["layers.mixer.u"].shape) == (2, 2, 64)
    else:
        assert tuple(own["layers.mixer.w_in"].shape)[0] == tcfg.n_layers


def test_registry_builds_both_families():
    for family in FAMILIES:
        _, tcfg = _cfgs(family)
        model = build_model(tcfg, device="cpu")
        assert isinstance(model, SSMModel)
        assert model.is_mamba == (family == "ssm_mamba2")
        model.init(torch.Generator().manual_seed(0))
        loss, _ = model.loss({"tokens": torch.zeros((1, 4), dtype=torch.long),
                              "labels": torch.ones((1, 4), dtype=torch.long)})
        assert loss.dim() == 0 and torch.isfinite(loss)


# --- the RWKV6 mixer alone ------------------------------------------------------


def _mixer(tree, l=0):
    return {k: v[l] for k, v in tree["layers"]["mixer"].items()}


def test_wkv_scan_matches_reference_from_a_live_state():
    """``_rwkv_wkv_scan`` alone: 12 tokens from a non-zero state, the
    outputs and the final state."""
    rng = np.random.default_rng(1)
    B, L, H, N = 2, 12, 3, 16
    r, k, v = (rng.normal(size=(B, L, H, N)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, size=(B, L, H, N)).astype(np.float32)
    u = rng.normal(size=(H, N)).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    jy, js = jssm._rwkv_wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    ty, ts = ssm._rwkv_wkv_scan(*map(torch.as_tensor, (r, k, v, w, u, s0)))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("L", [1, 9])
def test_rwkv6_forward_matches_reference_from_a_live_state(L):
    """``rwkv6_forward`` alone on layer 0's weights, from a non-zero
    (wkv, shift) state: the output and both new state leaves (the shift
    is the last token's input).  L = 1 is the decode."""
    jm, params, tm = _pair("ssm_rwkv6")
    cfg = tm.cfg
    rng = np.random.default_rng(2)
    H = cfg.d_model // ssm.RWKV_HEAD
    x = rng.normal(size=(2, L, cfg.d_model)).astype(np.float32)
    wkv = rng.normal(size=(2, H, 64, 64)).astype(np.float32)
    shift = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    jy, (jw, js) = jssm.rwkv6_forward(
        jax.tree.map(jnp.asarray, _mixer(params)), jnp.asarray(x), cfg,
        (jnp.asarray(wkv), jnp.asarray(shift)))
    ty, (tw, ts) = ssm.rwkv6_forward(
        {k: torch.as_tensor(v) for k, v in _mixer(params).items()},
        torch.as_tensor(x), cfg, (torch.as_tensor(wkv),
                                  torch.as_tensor(shift)))
    _close(ty, jy)
    _close(tw, jw)
    assert torch.equal(ts, torch.as_tensor(x[:, -1:]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# --- prefill and decode against the reference ----------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_and_decode_steps_match_reference(family):
    """Prefill 2 x 32 tokens, then 3 decode steps: the logits of the
    prefill and of each step, and every state leaf after each."""
    jm, params, tm = _pair(family)
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    jb, tb = _tokens(cfg, rng, 32)
    jl, jc = jax.jit(jm.prefill)(params, jb)
    tl, tc = make_prefill_step(tm)(tb)
    _close(tl, jl)
    for got, want in zip(tc, jc):
        _close(got, want)
    jstep = jax.jit(jm.decode_step)
    for i in range(3):
        jd, td = _step(cfg, rng, [32 + i, 32 + i])
        jl, jc = jstep(params, jc, jd)
        tl, tc = tm.decode_step(tc, td)
        _close(tl, jl)
        assert len(tc) == len(jc) == 2
        for got, want in zip(tc, jc):
            assert tuple(got.shape) == tuple(want.shape)
            assert str(got.dtype).replace("torch.", "") == str(want.dtype)
            _close(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_bfloat16_prefill_and_decode_match_reference(family):
    """The config's own bf16, at BF16_REL: prefill logits and two decode
    steps."""
    jm, params, tm = _pair(family, seed=1, dtype="bfloat16")
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    jb, tb = _tokens(cfg, rng, 32)
    jl, jc = jm.prefill(params, jb)
    tl, tc = tm.prefill(tb)
    _close(tl, jl, BF16_REL)
    for i in range(2):
        jd, td = _step(cfg, rng, [32 + i, 32 + i])
        jl, jc = jm.decode_step(params, jc, jd)
        tl, tc = tm.decode_step(tc, td)
        _close(tl, jl, BF16_REL)


@pytest.mark.parametrize("family", FAMILIES)
def test_state_relay_matches_full_forward(family):
    """The relay property, as ``tests/test_relay_equivalence.py``'s
    ``test_ssm_state_relay_matches_full_forward``: prefill(P) then
    decode(token P) gives prefill(P + 1)'s last logits, in the port; and
    the port's decode logits equal the reference's."""
    jm, params, tm = _pair(family, seed=3)
    cfg = tm.cfg
    rng = np.random.default_rng(6)
    P = 16
    toks = rng.integers(0, cfg.vocab, (2, P + 1))
    full, _ = tm.prefill({"tokens": torch.as_tensor(toks)})
    _, state = tm.prefill({"tokens": torch.as_tensor(toks[:, :P])})
    step, _ = tm.decode_step(state, {"token": torch.as_tensor(toks[:, P:]),
                                     "pos": torch.full((2,), P)})
    _close(step, full)
    _, jstate = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :P])})
    jstep, _ = jm.decode_step(params, jstate,
                              {"token": jnp.asarray(toks[:, P:]),
                               "pos": jnp.full((2,), P, jnp.int32)})
    _close(step, jstep)


# --- specs, state and steps ------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_cache_specs_and_init_cache_match_reference(family):
    """Shapes and types as the reference's ``cache_specs`` (independent
    of the sequence length); ``init_cache`` zeros of them; the prefill's
    state has the same shapes and types."""
    jcfg, tcfg = _cfgs(family)
    tm = build_model(tcfg, device="cpu")
    for S in (0, 100):
        jsds, _ = jbuild(jcfg).cache_specs(3, S)
        want = [(tuple(s.shape), str(s.dtype)) for s in jsds]
        specs = tm.cache_specs(3, S)
        assert [(s, str(d).replace("torch.", "")) for s, d in specs] == want
        cache = tm.init_cache(3, S)
        assert [(tuple(t.shape), t.dtype) for t in cache] == list(specs)
        assert all(not t.any() for t in cache)
    _, state = tm.prefill({"tokens": torch.zeros((3, 8), dtype=torch.long)})
    assert [(tuple(t.shape), t.dtype) for t in state] == \
        list(tm.cache_specs(3, 8))


@pytest.mark.parametrize("family", FAMILIES)
def test_batch_specs_match_reference(family):
    jcfg, tcfg = _cfgs(family)
    jm, tm = jbuild(jcfg), build_model(tcfg, device="cpu")
    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        want = {k: (tuple(s.shape), str(s.dtype))
                for k, s in jm.batch_specs(JSHAPES[name]).items()}
        got = {k: (s, str(d).replace("torch.", ""))
               for k, (s, d) in tm.batch_specs(INPUT_SHAPES[name]).items()}
        assert got == want, name


@pytest.mark.parametrize("family", FAMILIES)
def test_eager_serve_step_equals_decode_step(family):
    """``make_serve_step`` on the CPU (eager) is ``decode_step``: equal
    logits and states, bit for bit, from one prefill; neither touches
    the state it was handed."""
    _, _, tm = _pair(family)
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, 500, (2, 16)))
    _, state = make_prefill_step(tm)({"tokens": toks})
    keep = [t.clone() for t in state]
    step = make_serve_step(tm)
    a = b = state
    for i in range(2):
        batch = {"token": toks[:, i:i + 1], "pos": torch.tensor([16 + i] * 2)}
        la, a = step(a, batch)
        lb, b = tm.decode_step(b, batch)
        assert torch.equal(la, lb)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(state, keep))
