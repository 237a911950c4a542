"""The port's HSTU model on the CPU, held against ``repro.models.hstu``.

Weights are initialised once in JAX and loaded into the port through the
bridge (``repro_torch.models.convert``): ``jax.random`` and
``torch.Generator`` give different numbers from one seed.  Inputs are
numpy-made.  Configs: the smoke config and a 3-layer variant, both with
RoPE on.

Tolerance: 1e-4 relative to the largest |value| of the tensor compared
(and 1e-5 absolute).  Both sides compute in float32, but XLA and PyTorch
sum the projections and the attention in different orders, and the
hidden state grows layer by layer, so an absolute bound would have to
track the magnitude; observed differences are ~1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.executors import _gather_psi
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro_torch import resolve_device
from repro_torch.models import build_model, get_config
from repro_torch.models.convert import load_jax_params, state_from_tree
from repro_torch.models.layers import ParamSpec

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

REL = 1e-4


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=max(rel * scale, 1e-5),
                               rtol=0)


def _pair(n_layers=None):
    jcfg = jget("hstu-gr", smoke=True)
    tcfg = get_config("hstu-gr", smoke=True)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    assert jcfg.rope_theta and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=[None, 3], ids=["smoke", "3-layer"])
def pair(request):
    return _pair(request.param)


def _tokens(seed, B=2, P=96, n_incr=16, n_items=24, vocab=512):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, P)), rng.integers(0, vocab, (B, n_incr)),
            rng.integers(0, vocab, (B, n_items)))


def test_prefill_psi_matches(pair):
    jm, params, tm = pair
    pre, _, _ = _tokens(0)
    jl, (jk, jv) = jm.prefill(params, {"tokens": jnp.asarray(pre)})
    tl, (tk, tv) = tm.prefill(torch.as_tensor(pre))
    assert tk.shape == tuple(jk.shape) == (tm.cfg.n_layers, 2, 96,
                                           tm.cfg.n_heads, tm.cfg.head_dim)
    _close(tk, jk)
    _close(tv, jv)
    _close(tl, jl)


def test_rank_with_cache_and_full_rank_match(pair):
    jm, params, tm = pair
    pre, incr, items = _tokens(1)
    _, jkv = jm.prefill(params, {"tokens": jnp.asarray(pre)})
    _, tkv = tm.prefill(torch.as_tensor(pre))
    js = jm.rank_with_cache(params, jkv, jnp.asarray(incr), jnp.asarray(items))
    ts = tm.rank_with_cache(tkv, torch.as_tensor(incr), torch.as_tensor(items))
    assert ts.shape == (2, 24, 1)
    _close(ts, js)
    jf = jm.full_rank(params, *map(jnp.asarray, (pre, incr, items)))
    tf = tm.full_rank(*map(torch.as_tensor, (pre, incr, items)))
    _close(tf, jf)


def test_rank_with_cache_none_matches(pair):
    """No prefix at all: the rank mask alone, positions from 0."""
    jm, params, tm = pair
    _, incr, items = _tokens(2)
    js = jm.rank_with_cache(params, None, jnp.asarray(incr), jnp.asarray(items))
    ts = tm.rank_with_cache(None, torch.as_tensor(incr), torch.as_tensor(items))
    _close(ts, js)


def _pool_from_psi(kv, page_tokens, n_pages, lens):
    """Pack per-row psi (L, B, P, H, D) into one pool of distinct K and V
    pages with a (B, L, 2, n_pages) table, tails zeroed past each row's
    token count — the live paged window's layout."""
    k, v = (np.asarray(a) for a in kv)
    L, B, P, H, D = k.shape
    n_pool = B * L * 2 * n_pages
    pool = np.zeros((n_pool + 1, page_tokens, H, D), np.float32)
    tables = np.full((B, L, 2, n_pages), n_pool, np.int32)
    pid = 0
    for b, ln in enumerate(lens):
        for layer in range(L):
            for j, src in enumerate((k, v)):
                for p in range(-(-ln // page_tokens)):
                    lo, hi = p * page_tokens, min((p + 1) * page_tokens, ln)
                    pool[pid, :hi - lo] = src[layer, b, lo:hi]
                    tables[b, layer, j, p] = pid
                    pid += 1
    return pool, tables


@pytest.mark.parametrize("page_tokens", [64, 32])
def test_rank_with_pages_matches_reference_gather(pair, page_tokens):
    """The paged path against the reference's live paged path:
    ``rank_with_cache(_gather_psi(pool, tables))``."""
    jm, params, tm = pair
    pre, incr, items = _tokens(3, P=128)
    lens = [128, 70]
    _, kv = tm.prefill(torch.as_tensor(pre))
    n_pages = 128 // page_tokens
    pool, tables = _pool_from_psi(kv, page_tokens, n_pages, lens)
    kvj = _gather_psi(jnp, jnp.asarray(pool), jnp.asarray(tables))
    js = jm.rank_with_cache(params, kvj, jnp.asarray(incr),
                            jnp.asarray(items))
    ts = tm.rank_with_pages(torch.from_numpy(pool), torch.from_numpy(tables),
                            torch.tensor(lens, dtype=torch.int32),
                            torch.as_tensor(incr), torch.as_tensor(items))
    _close(ts, js)


def test_relay_equals_full_inference_eps():
    """The quickstart's contract (|relay - full| < 1e-4) in torch."""
    tm = build_model(get_config("hstu-gr", smoke=True), device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = torch.as_tensor(rng.integers(0, 500, (1, 128)))
    incr = torch.as_tensor(rng.integers(0, 500, (1, 16)))
    items = torch.as_tensor(rng.integers(0, 500, (1, 32)))
    _, psi = tm.prefill(prefix)
    relay = tm.rank_with_cache(psi, incr, items)
    full = tm.full_rank(prefix, incr, items)
    assert relay.shape == (1, 32, 1)
    assert (relay - full).abs().max().item() < 1e-4


def test_init_follows_the_reference_rule():
    """``init`` draws from a torch.Generator with ParamSpec's fan-in
    rule: std = scale / sqrt(shape[-2]) (stacked layers included), ones
    for norms; the same seed gives the same weights."""
    cfg = get_config("hstu-gr", smoke=True)
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert torch.equal(a.layers["ln"], torch.ones(cfg.n_layers, cfg.d_model))
    assert torch.equal(a.final_norm, torch.ones(cfg.d_model))
    for name, fan_in in (("tok", cfg.vocab_padded), ("unembed", cfg.d_model),
                         ("layers.uvqk", cfg.n_heads),
                         ("layers.wo", cfg.head_dim),
                         ("task_tower.w2", 4 * cfg.d_model)):
        std = a.state_dict()[name].std().item()
        assert std == pytest.approx(fan_in ** -0.5, rel=0.1), name
    spec = ParamSpec((3, 5), (None, None), init="value", value=2.0)
    assert torch.equal(spec.initialise(torch.Generator()),
                       torch.full((3, 5), 2.0))


def test_bridge_names_and_sizes_match_reference():
    jm, params, tm = _pair()
    state = state_from_tree(jax.tree.map(np.asarray, params))
    assert set(state) == set(tm.state_dict())
    assert tm.kv_bytes(2048) == jm.kv_bytes(2048)
    bad = dict(jax.tree.map(np.asarray, params))
    bad.pop("unembed")
    with pytest.raises(KeyError):
        load_jax_params(tm, bad)


def test_registry_ports_only_hstu():
    """The ids and families still to port (RWKV6, enc-dec) raise, naming
    their ROADMAP item; hstu-gr's config is the reference's."""
    from repro_torch.models.config import ModelConfig
    for arch in ("rwkv6_1p6b", "rwkv6-1.6b", "seamless_m4t_large_v2",
                 "seamless-m4t-large-v2"):
        with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
            get_config(arch)
    for family in ("ssm_rwkv6", "ssm_mamba2", "encdec"):
        with pytest.raises(NotImplementedError, match="Queue 1, item 9"):
            build_model(ModelConfig(name="x", family=family, n_layers=1,
                                    d_model=8, vocab=16, n_heads=1),
                        device="cpu")
    full = get_config("hstu-gr")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim,
            full.vocab_padded, full.dtype) == (8, 256, 4, 64, 100096,
                                               "float32")


def test_model_sets_full_f32_and_refuses_missing_cuda():
    build_model(get_config("hstu-gr", smoke=True), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(get_config("hstu-gr", smoke=True))


@pytest.mark.parametrize("shape,pos", [((2, 7, 3, 8), np.arange(7)[None]),
                                       ((1, 5, 2, 4), 2048 + np.arange(5)[None])])
def test_layers_match_reference(shape, pos):
    """rms_norm keeps the f32 upcast; apply_rope rotates interleaved
    pairs (not halves), at small and large positions."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    bf = torch.from_numpy(x).to(torch.bfloat16)
    assert tl.rms_norm(bf, torch.from_numpy(w)).dtype == torch.bfloat16
