"""The port at bfloat16 on the CPU, held against the JAX package.

The Pallas kernels take float32 or bfloat16 and widen each tile to
float32 on load; the port's kernels do the same on the card.  Here, on
the CPU (the plain twins), the bf16 paths that reach them:

* the HSTU relay of a bf16 ``hstu-gr`` (``dataclasses.replace(cfg,
  dtype="bfloat16")``, the reference's ``ModelConfig`` allows it): the
  smoke model and a 3-layer variant against the reference's at bf16,
  with the weights carried by ``models/convert.py`` — ``prefill``'s
  logits and psi, ``rank_with_cache``, ``full_rank``, ``rank_with_pages``
  and ``rank_with_segments`` against the reference's rank over the
  gathered pages, and ``decode_step``.  Tolerance: 2**-5 of the largest
  |value| (measured 0.006-0.014 here: both sides round to bf16 at every
  projection, in other orders and at other places, so the two differ by
  a few bf16 ulps of the largest value, 2**-7 each);
* ``serve.main`` in the five modes the card's serve phases run, the
  same stream giving the reference's hits by kind;
* psi's host hop: bf16 crosses as its ``uint16`` bits, bit for bit,
  through slicing into pages, the device pool, a spill
  (``materialize``) and the executor's reload;
* zamba2's smoke prefill and one training step with x, B and C handed
  to the SSD twins in bf16, equal bit for bit to the route that hands
  each kernel float32 copies of them (the twins widen as the kernels
  do).
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
from repro_torch.core.cache import kv_nbytes
from repro_torch.core.paging import (BF16_BITS, DevicePagePool, PageLayout,
                                     PagedPsi, from_host, host_dtype,
                                     slice_into_pages, to_host, torch_dtype)
from repro_torch.kernels import ssd_chunk as sk
from repro_torch.models import build_model, get_config
from repro_torch.models.convert import load_jax_params

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

REL = 2 ** -5
BF16 = dict(dtype="bfloat16")


def _np(t):
    """A bf16 tensor (or jax array) as float32 numpy (exact)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.fixture(scope="module", params=[None, 3], ids=["smoke", "3-layer"])
def pair(request):
    jcfg = dataclasses.replace(jget("hstu-gr", smoke=True), **BF16)
    tcfg = dataclasses.replace(get_config("hstu-gr", smoke=True), **BF16)
    if request.param:
        jcfg = dataclasses.replace(jcfg, n_layers=request.param)
        tcfg = dataclasses.replace(tcfg, n_layers=request.param)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    assert tm.layers["uvqk"].dtype == torch.bfloat16
    return jm, params, tm


def _tokens(seed, B=2, P=96, n_incr=16, n_items=24, vocab=512):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, P)), rng.integers(0, vocab, (B, n_incr)),
            rng.integers(0, vocab, (B, n_items)))


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


def test_prefill_logits_and_psi_match_reference(pair):
    jm, params, tm = pair
    pre, _, _ = _tokens(0)
    jl, (jk, jv) = jm.prefill(params, {"tokens": jnp.asarray(pre)})
    tl, (tk, tv) = tm.prefill({"tokens": torch.as_tensor(pre)})
    assert tk.dtype == tv.dtype == tl.dtype == torch.bfloat16
    for got, want in ((tl, jl), (tk, jk), (tv, jv)):
        assert _rel(got, want) <= REL


@pytest.mark.parametrize("entry", ["rank_with_cache", "full_rank",
                                   "decode_step"])
def test_rank_and_decode_match_reference(pair, entry):
    """Each side on its own psi; ``decode_step`` on the reference's psi
    (one token at position P against P cached tokens)."""
    jm, params, tm = pair
    pre, incr, items = _tokens(2)
    jpre, jincr, jitems = map(jnp.asarray, (pre, incr, items))
    tpre, tincr, titems = map(torch.as_tensor, (pre, incr, items))
    if entry == "full_rank":
        got = tm.full_rank(tpre, tincr, titems)
        want = jm.full_rank(params, jpre, jincr, jitems)
    else:
        _, jkv = jm.prefill(params, {"tokens": jpre})
        if entry == "rank_with_cache":
            _, tkv = tm.prefill({"tokens": tpre})
            got = tm.rank_with_cache(tkv, tincr, titems)
            want = jm.rank_with_cache(params, jkv, jincr, jitems)
        else:
            tkv = tuple(torch.from_numpy(_np(a)).bfloat16() for a in jkv)
            tok, pos = incr[:, :1], np.full((2,), pre.shape[1])
            got, _ = tm.decode_step(tkv, {"token": torch.as_tensor(tok),
                                          "pos": torch.as_tensor(pos)})
            want, _ = jm.decode_step(params, jkv, {"token": jnp.asarray(tok),
                                                   "pos": jnp.asarray(pos)})
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= REL


def _pool(kv, pt, n_pages, lens):
    """Per-row bf16 psi (L, B, P, H, D) packed into one bf16 pool of
    distinct K and V pages and a (B, L, 2, n_pages) table, tails zero
    past each row's length, the null page last."""
    k, v = (t.float().numpy() for t in kv)
    L, B, P, H, D = k.shape
    n_pool = B * L * 2 * n_pages
    pool = np.zeros((n_pool + 1, pt, H, D), np.float32)
    tables = np.full((B, L, 2, n_pages), n_pool, np.int32)
    pid = 0
    for b, ln in enumerate(lens):
        for layer in range(L):
            for j, src in enumerate((k, v)):
                for p in range(-(-ln // pt)):
                    lo, hi = p * pt, min((p + 1) * pt, ln)
                    pool[pid, :hi - lo] = src[layer, b, lo:hi]
                    tables[b, layer, j, p] = pid
                    pid += 1
    return pool, tables


@pytest.mark.parametrize("entry", ["rank_with_pages", "rank_with_segments"])
@pytest.mark.parametrize("pt", [32, 64])
def test_paged_and_segment_ranks_match_reference_gather(pair, entry, pt):
    """The port's bf16 psi packed into a bf16 pool: ``rank_with_pages``
    and ``rank_with_segments`` (one span at [0, len) a row) against the
    reference's live paged path, ``rank_with_cache`` over
    ``_gather_psi``; on the CPU the segment twin equals the paged one
    bit for bit."""
    jm, params, tm = pair
    pre, incr, items = _tokens(3, P=128)
    lens = [128, 70]
    _, kv = tm.prefill({"tokens": torch.as_tensor(pre)})
    n_pages = 128 // pt
    pool, tables = _pool(kv, pt, n_pages, lens)
    jkv = _gather_psi(jnp, jnp.asarray(pool, jnp.bfloat16),
                      jnp.asarray(tables))
    want = jm.rank_with_cache(params, jkv, jnp.asarray(incr),
                              jnp.asarray(items))
    tpool = torch.from_numpy(pool).bfloat16()
    plens = torch.tensor(lens, dtype=torch.int32)
    args = (torch.as_tensor(incr), torch.as_tensor(items))
    paged = tm.rank_with_pages(tpool, torch.from_numpy(tables), plens, *args)
    if entry == "rank_with_pages":
        got = paged
    else:
        ppos = (torch.arange(n_pages, dtype=torch.int32) * pt).expand(
            2, n_pages).contiguous()
        pval = (plens[:, None] - ppos).clamp(0, pt).int()
        got = tm.rank_with_segments(tpool, torch.from_numpy(tables), ppos,
                                    pval, *args)
        assert torch.equal(got, paged)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= REL


def test_relay_equals_full_rank_bitwise():
    """The relay contract at bf16: ranking over pre-inferred psi gives
    the full inference's scores; on the CPU bit for bit (the same
    operations on the same values)."""
    cfg = dataclasses.replace(get_config("hstu-gr", smoke=True), **BF16)
    tm = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix, incr, items = (torch.as_tensor(rng.integers(0, 500, (1, n)))
                           for n in (128, 16, 32))
    _, psi = tm.prefill({"tokens": prefix})
    relay = tm.rank_with_cache(psi, incr, items)
    assert relay.dtype == torch.bfloat16 and relay.shape == (1, 32, 1)
    assert torch.equal(relay, tm.full_rank(prefix, incr, items))


# --- serve: the five modes of the card's serve phases, at bf16 --------------------

SERVE_MODES = {
    "live": [],
    "batched": ["--batched"],
    "batched-paged": ["--batched", "--page-tokens", "16"],
    "batched-device-pool": ["--batched", "--device-pool", "--page-tokens",
                            "16"],
    "batched-segments": ["--segments", "--batched", "--page-tokens", "16"],
}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_serve_modes_at_bf16_match_reference(mode, monkeypatch, capsys):
    """A bf16 ``hstu-gr`` served on the CPU in each mode runs to its end
    and gives the reference's hits by kind on the same stream."""
    import warnings

    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    def bf16(get):
        return lambda arch, smoke=False: dataclasses.replace(
            get(arch, smoke=smoke), **BF16) if smoke else get(arch,
                                                              smoke=smoke)

    monkeypatch.setattr(serve, "get_config", bf16(get_config))
    monkeypatch.setattr(jserve, "get_config", bf16(jget))
    flags = ["--requests", "12", *SERVE_MODES[mode]]
    hits = serve.main(["--device", "cpu", *flags])
    assert sum(hits.values()) == 12 and hits.get("hbm_hit", 0) >= 1
    out = capsys.readouterr().out
    if "--device-pool" in flags:
        assert '"launch_reships": 0' in out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert jserve.main(flags) == hits


# --- psi's host hop: bf16 as uint16 bits --------------------------------------------


def _bf16_values(*shape, seed=0):
    """bf16 values with every class of bit pattern: normals of both
    signs, +-0, +-inf, NaN and subnormals."""
    g = torch.Generator().manual_seed(seed)
    t = torch.randn(shape, generator=g).bfloat16()
    flat = t.view(-1)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                            float("nan"), 1e-40, -3e-39]).bfloat16()
    flat[:special.numel()] = special
    return t


def _bits(t):
    return t.view(torch.int16)


def test_host_hop_round_trip_is_bitwise():
    """``to_host`` carries bf16 as uint16 and ``from_host`` views it back
    bit for bit; float32 passes as it is; the dtype maps invert; a bf16
    value is 2 bytes on either side of the hop."""
    t = _bf16_values(3, 5, 4, 8)
    h = to_host(t)
    assert h.dtype == BF16_BITS and h.shape == tuple(t.shape)
    back = from_host(h)
    assert back.dtype == torch.bfloat16
    assert torch.equal(_bits(back), _bits(t))
    f = torch.randn(4, 3)
    assert to_host(f).dtype == np.float32 and torch.equal(from_host(to_host(f)), f)
    for dt in (torch.bfloat16, torch.float32):
        assert torch_dtype(host_dtype(dt)) == dt
    assert kv_nbytes((t, t)) == kv_nbytes((h, h)) == 2 * 2 * t.numel()
    cfg = dataclasses.replace(get_config("hstu-gr", smoke=True), **BF16)
    layout = PageLayout.from_model_config(cfg, 16)
    assert layout.token_bytes == cfg.n_heads * cfg.head_dim * 2


@pytest.mark.parametrize("pt", [16, 64])
def test_paged_window_and_spill_keep_bf16_bits(pt):
    """psi (L, 1, P, H, D) sliced into a host pool of uint16 pages, landed
    in a ``DevicePagePool`` (on the CPU: the same code path as the card's)
    and materialized back (a DRAM spill): every step holds psi's bits,
    the pages past P hold +0 and the executor's reload of the spilled
    copy is psi in bf16."""
    from repro_torch.core.executors import LiveExecutor
    L, P, H, D = 2, 100, 4, 8
    k, v = _bf16_values(L, 1, P, H, D, seed=1), _bf16_values(L, 1, P, H, D,
                                                             seed=2)
    n = -(-P // pt)
    table = np.arange(2 * L * n, dtype=np.int32).reshape(2 * L, n)
    buf = np.zeros((2 * L * n + 1, pt, H, D), host_dtype(torch.bfloat16))
    slice_into_pages(buf, table, (k, v), pt)
    pool = DevicePagePool(2 * L * n, pt * H * D * 2, device="cpu")
    pool.scatter(range(2 * L * n), buf)
    assert pool.device_buffer.dtype == torch.bfloat16
    assert torch.equal(_bits(pool.device_buffer), _bits(from_host(buf)))
    layout = PageLayout(page_tokens=pt, slabs=2 * L, token_bytes=H * D * 2)
    mk, mv = PagedPsi(table, P, layout, buf).materialize()
    assert mk.dtype == BF16_BITS and mk.shape == (L, 1, n * pt, H, D)
    for got, want in ((mk, k), (mv, v)):
        assert torch.equal(_bits(from_host(got[:, :, :P])), _bits(want))
        assert not got[:, :, P:].any()
    ex = LiveExecutor.__new__(LiveExecutor)
    ex.device = torch.device("cpu")
    rk, rv = ex._psi((mk, mv))
    assert rk.dtype == torch.bfloat16
    assert torch.equal(_bits(rk[:, :, :P]), _bits(k))


# --- zamba2: x, B and C reach the SSD kernels in bf16 -----------------------------


def _f32_copy_route(monkeypatch):
    """Hand each SSD kernel float32 copies of x, B and C (the route
    before the bf16 load path)."""
    intra, state = sk.ssd_chunk_intra, sk.ssd_chunk_state
    monkeypatch.setattr(sk, "ssd_chunk_intra",
                        lambda C, B, x, cum, dt, out_dtype=None: intra(
                            C.float(), B.float(), x.float(), cum, dt,
                            out_dtype))
    monkeypatch.setattr(sk, "ssd_chunk_state",
                        lambda B, x, cum, dt: state(B.float(), x.float(),
                                                    cum, dt))


def _spy(monkeypatch):
    """The types x, B and C reach the SSD twins in."""
    seen = []
    for name in ("ssd_chunk_intra_ref", "ssd_chunk_state_ref"):
        plain = getattr(sk, name)
        n_mat = 3 if "intra" in name else 2

        def spy(*a, _plain=plain, _n=n_mat, **k):
            seen.append(tuple(t.dtype for t in a[:_n]))
            return _plain(*a, **k)
        monkeypatch.setattr(sk, name, spy)
    return seen


def test_zamba2_bf16_ssd_route_equals_float32_copies(monkeypatch):
    """zamba2's smoke config (bf16): the prefill's logits and every cache
    tensor, then one training step's loss and every gradient, with x, B
    and C reaching the SSD twins in bf16, equal bit for bit to the route
    that hands each kernel float32 copies."""
    from repro_torch.launch.steps import make_prefill_step
    cfg = get_config("zamba2_1p2b", smoke=True)
    assert cfg.dtype == "bfloat16"
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.shared_attn.lora_b.normal_(
            generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 257)))
    prefill = make_prefill_step(model)

    def run():
        logits, cache = prefill({"tokens": toks[:, :256]})
        model.zero_grad(set_to_none=True)
        model.requires_grad_(True)
        loss, _ = model.loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
        loss.backward()
        model.requires_grad_(False)
        leaves = [logits, *torch.utils._pytree.tree_leaves(cache), loss]
        return leaves, {n: p.grad for n, p in model.named_parameters()}

    with monkeypatch.context() as m:
        seen = _spy(m)
        new, grads = run()
        assert seen and all(t == torch.bfloat16 for d in seen for t in d)
    with monkeypatch.context() as m:
        _f32_copy_route(m)
        seen = _spy(m)
        old, want = run()
        assert seen and all(t == torch.float32 for d in seen for t in d)
    for a, b in zip(new, old):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for name, g in grads.items():
        assert g is not None and torch.equal(g, want[name]), name
