"""The port's relay slice on the CPU: executors, paging, batching, serve.

* Executor level: ``repro``'s and ``repro_torch``'s ``LiveExecutor`` /
  ``BatchedLiveExecutor``, with bridged weights over ONE
  ``UserBehaviorStore``, give the same psi and scores for the same metas
  through ``pre_infer``, ``rank_cached`` (dense and paged), ``rank_full``,
  ``rank_group`` and ``pre_infer_group``.  Tolerance: 1e-4 relative to the
  largest |score| (f32 on both sides, different summation orders in XLA
  and PyTorch; batched-vs-per-request is not bitwise even inside the
  reference, ROADMAP Queue 3 item 1).
* ``DevicePagePool`` on the CPU is byte-equal to the host pool after an
  interleaving of every window operation, as ``tests/test_device_pool.py``
  requires of the reference.
* Sim parity: one arrival stream through both packages' ``ClusterSim``
  gives identical ``runtime.records`` — the numpy-only copies are
  faithful.
* ``repro_torch.launch.serve.main`` serves in every live mode on the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core.cache import PagedHBMStore as JPagedStore
from repro.data.synthetic import UserBehaviorStore, WorkloadConfig
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.serving.batching import PendingRank as JPending
from repro.serving.batching import pad_psi as jpad_psi
from repro_torch.core.cache import PagedHBMStore, kv_nbytes
from repro_torch.core.paging import DevicePagePool, PageLayout, to_host
from repro_torch.launch import serve
from repro_torch.models import build_model, get_config
from repro_torch.models.convert import load_jax_params
from repro_torch.serving.batching import PendingRank, pad_psi, stack_psi

# the suite runs several worker processes on a few cores: one intra-op
# thread each keeps torch from oversubscribing them
torch.set_num_threads(1)

REL = 1e-4
N_INCR, N_ITEMS = 8, 16


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=REL * scale, rtol=0)


@pytest.fixture(scope="module")
def live():
    jcfg = jget("hstu_gr", smoke=True)
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("hstu_gr", smoke=True), device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    store = UserBehaviorStore(WorkloadConfig(
        vocab=jcfg.vocab, n_items=N_ITEMS, incr_len=N_INCR, max_len=512))
    metas = [jcore.UserMeta(user_id=uid,
                            prefix_len=int(store.long_term(uid).shape[0]),
                            incr_len=N_INCR, n_items=N_ITEMS)
             for uid in (201, 202)]
    return jm, params, tm, store, metas


def _executors(live, name, **kw):
    jm, params, tm, store, _ = live
    extra = {}
    if name == "batched":
        extra = dict(batching=jcore.BatchingConfig(max_batch=4))
        textra = dict(batching=tcore.BatchingConfig(max_batch=4))
    else:
        textra = {}
    jex = jcore.get_executor(name)(jm, params, store, **extra, **kw)
    tex = tcore.get_executor(name)(tm, store, **textra, **kw)
    return jex, tex


@pytest.mark.parametrize("name", ["live", "batched"])
def test_pre_infer_rank_cached_and_rank_full_match(live, name):
    jex, tex = _executors(live, name)
    for meta in live[4]:
        jpsi, jn, _ = jex.pre_infer(meta)
        tpsi, tn, _ = tex.pre_infer(meta)
        assert tn == jn
        for a, b in zip(tpsi, jpsi):
            _close(a, b)
        js, _ = jex.rank_cached(meta, jpsi)
        ts, _ = tex.rank_cached(meta, tpsi)
        _close(ts, js)
        jf, _ = jex.rank_full(meta)
        tf, _ = tex.rank_full(meta)
        _close(tf, jf)


def _paged(ex, store_cls, psi, meta):
    layout = ex.page_layout
    hbm = store_cls(64 * layout.entry_bytes(512), layout)
    hbm.insert(meta.user_id, psi, kv_nbytes(psi), 0.0,
               prefix_len=meta.prefix_len)
    return hbm, hbm.acquire_value(hbm.entries[meta.user_id])


@pytest.mark.parametrize("name", ["live", "batched"])
def test_rank_cached_paged_matches(live, name):
    """Paged psi: the reference gathers the pool (``_gather_psi``) inside
    its jit; the port hands pool + (B, L, 2, np) tables to the paged
    kernel's plain version, with ``PagedPsi.n_tokens`` as the resident
    length."""
    jex, tex = _executors(live, name, page_tokens=32)
    for meta in live[4]:
        jpsi, _, _ = jex.pre_infer(meta)
        tpsi, _, _ = tex.pre_infer(meta)
        _, jpaged = _paged(jex, JPagedStore, jpsi, meta)
        thbm, tpaged = _paged(tex, PagedHBMStore, tpsi, meta)
        assert tpaged.n_tokens == jpaged.n_tokens
        js, _ = jex.rank_cached(meta, jpaged)
        ts, _ = tex.rank_cached(meta, tpaged)
        _close(ts, js)
        # paged == dense in the port itself
        td, _ = tex.rank_cached(meta, tpsi)
        _close(ts, td.numpy())
        assert thbm.pool.h2d["launch_reships"] == 1   # host pool re-ships


@pytest.mark.parametrize("kind", ["cached", "full", "paged"])
def test_rank_group_matches(live, kind):
    jm, params, tm, store, metas = live
    jex, tex = _executors(live, "batched",
                          page_tokens=32 if kind == "paged" else 0)
    jgroup, tgroup = [], []
    for meta in metas:
        jpsi = tpsi = None
        if kind != "full":
            jpsi, _, _ = jex.pre_infer(meta)
            tpsi, _, _ = tex.pre_infer(meta)
            if kind == "paged":
                _, jpsi = _paged(jex, JPagedStore, jpsi, meta)
                _, tpsi = _paged(tex, PagedHBMStore, tpsi, meta)
        jgroup.append(JPending(user_id=meta.user_id, psi=jpsi,
                               prefix_len=meta.prefix_len, meta=meta))
        tgroup.append(PendingRank(user_id=meta.user_id, psi=tpsi,
                                  prefix_len=meta.prefix_len, meta=meta))
    js, _ = jex.rank_group(jgroup)
    ts, _ = tex.rank_group(tgroup)
    assert len(ts) == len(js) == len(metas)
    for a, b in zip(ts, js):
        _close(a, b)


def test_batched_rank_executor_matches(live):
    """The raw group executor (caller-held tokens, psi padded to the
    group's bucket and stacked) against the reference's jitted one."""
    from repro.serving.batching import BatchedRankExecutor as JRanker
    from repro_torch.serving.batching import BatchedRankExecutor
    jm, params, tm, store, metas = live
    jex, tex = _executors(live, "live")
    jbatch, tbatch = [], []
    for meta in metas:
        jpsi, _, _ = jex.pre_infer(meta)
        tpsi, _, _ = tex.pre_infer(meta)
        toks = dict(incr=store.short_term(meta.user_id),
                    items=store.candidates(meta.user_id))
        jbatch.append(JPending(meta.user_id, jpsi, meta.prefix_len, **toks))
        tbatch.append(PendingRank(meta.user_id, tpsi, meta.prefix_len,
                                  **toks))
    for a, b in zip(BatchedRankExecutor(tm).run(tbatch),
                    JRanker(jm, params).run(jbatch)):
        _close(a, b)


def test_pre_infer_group_matches_and_members_own_their_psi(live):
    jm, params, tm, store, metas = live
    jex, tex = _executors(live, "batched")
    # two members on one 64-token prefill grid -> a batch of 2
    same = [metas[0], dataclasses.replace(metas[0], user_id=999)]
    jouts, _ = jex.pre_infer_group(same)
    touts, _ = tex.pre_infer_group(same)
    for (tpsi, tn), (jpsi, jn) in zip(touts, jouts):
        assert tn == jn
        for a, b in zip(tpsi, jpsi):
            _close(a, b)
            # a contiguous copy of its own: the byte ledger equals the
            # memory the member pins (no view into the batched psi)
            assert a.is_contiguous()
            assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
        assert kv_nbytes(tpsi) == tn


def test_kv_nbytes_accepts_torch_and_psi_reaches_host_once():
    psi = (torch.zeros(2, 1, 5, 3, 4), torch.zeros(2, 1, 5, 3, 4))
    assert kv_nbytes(psi) == 2 * 2 * 5 * 3 * 4 * 4
    assert kv_nbytes(torch.zeros(3, dtype=torch.bfloat16)) == 6
    assert kv_nbytes((np.zeros((2, 3), np.float32), "stub")) == 24
    t = torch.arange(6.0).reshape(2, 3)
    assert isinstance(to_host(t), np.ndarray)
    assert to_host(t).tobytes() == t.numpy().tobytes()
    # the paged store sizes its buffer and slices pages from torch psi
    layout = PageLayout(page_tokens=4, slabs=4, token_bytes=3 * 4 * 4)
    hbm = PagedHBMStore(40 * layout.page_bytes, layout)
    k = torch.randn(2, 1, 6, 3, 4)
    v = torch.randn(2, 1, 6, 3, 4)
    hbm.insert(7, (k, v), kv_nbytes((k, v)), 0.0, prefix_len=6)
    dk, dv = hbm.entries[7].value.materialize()
    assert dk[:, :, :6].tobytes() == k.numpy().tobytes()
    assert dv[:, :, :6].tobytes() == v.numpy().tobytes()
    assert not dk[:, :, 6:].any()


def test_pad_and_stack_psi_match_reference():
    rng = np.random.default_rng(4)
    a = (rng.normal(size=(2, 1, 5, 2, 3)).astype(np.float32),
         rng.normal(size=(2, 1, 5, 2, 3)).astype(np.float32))
    b = tuple(x[:, :, :3] for x in a)
    want = jpad_psi(np, a, 8)
    got = pad_psi(tuple(map(torch.from_numpy, a)), 8)
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()
    k, v = stack_psi([tuple(map(torch.from_numpy, p)) for p in (a, b)], 8)
    assert k.shape == v.shape == (2, 2, 8, 2, 3)
    assert torch.equal(k[:, 1:2, :3], torch.from_numpy(b[0]))
    assert not k[:, 1, 3:].any()


# --- device pool on the CPU == host pool --------------------------------------

N_LAYERS, H, D, PT = 2, 2, 3, 8
LAYOUT = PageLayout(page_tokens=PT, slabs=2 * N_LAYERS, token_bytes=H * D * 4)
POOL_PAGES = 40
OPS = [("insert", 2), ("consume", 2), ("back", 2), ("insert", 0),
       ("insert", 1), ("insert", 2), ("pin", 1), ("extract", 1),
       ("insert", 3), ("insert", 4), ("release", 1), ("insert", 5),
       ("pop", 0), ("insert", 0)]


def _tokens_of(uid):
    return 2 * PT * (1 + uid % 3) - 3


def _kv(uid, tokens):
    rng = np.random.default_rng(uid * 1009 + tokens)
    shape = (N_LAYERS, 1, tokens, H, D)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def _apply(s, op, uid, now, pinned):
    tokens = _tokens_of(uid)
    if op == "insert":
        v = _kv(uid, tokens)
        if isinstance(s, JPagedStore):
            v = tuple(a.numpy() for a in v)
        s.insert(uid, v, kv_nbytes(v), now, prefix_len=tokens)
    elif op == "consume":
        s.consume(uid)
    elif op == "back":
        e = s.entries.get(uid)
        if e is not None and e.consumed:
            e.dram_backed = True
    elif op == "extract":
        s.extract(uid)
    elif op == "pop":
        s.pop(uid)
    elif op == "pin":
        e = s.resident(uid)
        if e is not None:
            pinned.append(s.acquire_value(e))
    elif op == "release" and pinned:
        s.release_value(pinned.pop(0))


def test_device_pool_on_cpu_is_byte_equal_to_host_pool():
    host = PagedHBMStore(POOL_PAGES * LAYOUT.page_bytes, LAYOUT)
    dev = PagedHBMStore(POOL_PAGES * LAYOUT.page_bytes, LAYOUT,
                        device_pool=True)
    ref = JPagedStore(POOL_PAGES * LAYOUT.page_bytes,
                      jcore.PageLayout(page_tokens=PT, slabs=2 * N_LAYERS,
                                       token_bytes=H * D * 4))
    assert isinstance(dev.pool, DevicePagePool)
    with pytest.raises(RuntimeError, match="no device"):
        dev.pool.ensure_device(np.zeros((2, PT, H, D), np.float32))
    dev.pool.device = torch.device("cpu")   # what the executor binds
    pins = {id(s): [] for s in (host, dev, ref)}
    for i, (op, uid) in enumerate(OPS):
        for s in (host, dev, ref):
            _apply(s, op, uid, float(i), pins[id(s)])
        pool = dev.pool
        buf = pool.device_buffer.numpy()
        assert not buf[pool.n_pages].any(), "null page must stay zero"
        for e in dev.entries.values():
            if e.page_table is None:
                continue
            pps = LAYOUT.pages_per_slab(e.tokens_resident) \
                if e.tokens_resident else 0
            pages = e.page_table[:, :pps].reshape(-1)
            assert buf[pages].tobytes() == dev.buffer[pages].tobytes()
        assert host.stats == dev.stats == ref.stats
        assert sorted(host.entries) == sorted(ref.entries)
        assert pool.stats["pages_allocated"] == \
            pool.pages_live + pool.stats["pages_freed"]
        assert pool.h2d["launch_reships"] == 0
        assert pool.h2d["bytes_scattered"] == \
            pool.h2d["pages_scattered"] * pool.page_bytes
    assert dev.stats["partial_evictions"] >= 1
    assert dev.stats["resumed_reloads"] >= 1
    assert dev.pool.h2d["scatters"] > 0
    assert host.buffer.tobytes() == ref.buffer.tobytes()


def test_executor_binds_the_device_pool(live):
    _, tex = _executors(live, "batched", page_tokens=32, device_pool=True)
    pool = DevicePagePool(4, tex.page_layout.page_bytes)
    buf = np.ones((5, 32, 2, 32), np.float32)
    assert tex.insert_pages(pool, [1, 3], buf) == 2 * pool.page_bytes
    assert pool.device == tex.device
    got = pool.device_buffer
    assert got[[1, 3]].eq(1).all() and not got[[0, 2, 4]].any()


# --- sim parity: the copies are faithful ----------------------------------------


def _arrivals(core, n=60, seed=0):
    rng = np.random.default_rng(seed)
    pool = [100 + i for i in range(4)]
    out = []
    for i in range(n):
        t = 1.0 * (i + 1)
        if rng.random() > 0.8:
            meta = core.UserMeta(user_id=int(rng.integers(0, 50)),
                                 prefix_len=64)
        else:
            meta = core.UserMeta(user_id=pool[int(rng.integers(0, 4))],
                                 prefix_len=4096)
        out.append((t, meta))
    return out


def _records(core, sim_mod, models, cluster):
    cost = core.GRCostModel(models.get_config("hstu_gr"))
    cfg = core.relay_config(
        trigger=core.TriggerConfig(n_instances=5, r2=0.4, kv_p99_len=4096,
                                   q_m=0.1),
        cluster=core.ClusterConfig(**cluster))
    sim = sim_mod.ClusterSim(cfg, cost)
    summary = sim.run(iter(_arrivals(core)))
    return sim.runtime.records, summary


@pytest.mark.parametrize("cluster", [
    dict(hbm_cache_bytes=1.5e8, dram_budget_bytes=500e9),
    dict(hbm_cache_bytes=1.5e8, dram_budget_bytes=500e9, max_batch=4,
         page_tokens=64, hosts=2)], ids=["relay", "batched-paged-2hosts"])
def test_sim_records_identical(cluster):
    import repro.models as jmodels
    import repro.serving.simulator as jsim
    import repro_torch.models as tmodels
    import repro_torch.serving.simulator as tsim
    jrecs, jsum = _records(jcore, jsim, jmodels, cluster)
    trecs, tsum = _records(tcore, tsim, tmodels, cluster)
    assert len(trecs) == len(jrecs) == 60
    for a, b in zip(trecs, jrecs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert json.dumps(tsum, sort_keys=True, default=str) == \
        json.dumps(jsum, sort_keys=True, default=str)
    assert [h.value for h in tcore.HitKind] == [h.value for h in jcore.HitKind]


# --- the live service -----------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--batched"],
                                   ["--batched", "--page-tokens", "64"],
                                   ["--batched", "--device-pool"]],
                         ids=["live", "batched", "paged", "device-pool"])
def test_serve_main_modes_on_cpu(flags, capsys):
    hits = serve.main(["--device", "cpu", "--requests", "12", *flags])
    assert hits.get("hbm_hit", 0) >= 1
    assert sum(hits.values()) == 12
    if "--device-pool" in flags:
        out = capsys.readouterr().out
        assert '"launch_reships": 0' in out
        assert '"device_resident": true' in out


def test_serve_flags():
    args = serve.parse_args([])
    assert args.smoke is True and args.device == "cuda"
    assert serve.parse_args(["--no-smoke"]).smoke is False
    assert serve.parse_args(["--device-pool"]).page_tokens == 64
