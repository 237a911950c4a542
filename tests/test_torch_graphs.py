"""The port's CUDA-graph machinery and live benchmarks, on the CPU.

* ``core/graphs.py``: the launch tally a capture takes (snapshot,
  restore, add per replay) on every kernel counter, as plain Python;
  ``Graph.replay`` copies inputs, refuses other references and adds its
  tally once per replay (a stand-in graph object replays nothing).
* The executors and the decode step run eagerly on the CPU, and asking
  for graphs there raises.
* ``repro_torch.benchmarks.calibrate --device cpu --quick`` (with and
  without ``--h2d``) writes a table with the reference's keys —
  checked against the reference's own ``benchmarks.calibrate`` run
  under JAX on the CPU — that the port's ``GRCostModel.with_calibration``
  loads and that reprices only the batched simulator trace.
* ``repro_torch.benchmarks.microbench`` carries the reference's rows.

The CUDA side (replay == eager, captures that fail, pools) is in
``tests/test_torch_cuda.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import graphs
from repro_torch.core.graphs import (COUNTERS, Graph, GraphRunner,
                                     add_tally, read_counters, tallied,
                                     write_counters)

torch.set_num_threads(1)


@pytest.fixture
def counters():
    """Every kernel counter at a distinct value, restored after."""
    saved = read_counters()
    write_counters({n: 10 * (i + 1) for i, n in enumerate(COUNTERS)})
    yield
    write_counters(saved)


def _bump(**launches):
    for name, n in launches.items():
        m, a = COUNTERS[name]
        setattr(m, a, getattr(m, a) + n)


def test_counters_cover_every_kernel_wrapper():
    from repro_torch.kernels import (decode_attn, hstu_attn,
                                     paged_prefix_attn, prefix_rank_attn,
                                     ssd_chunk)
    assert set(COUNTERS) == {
        "hstu_attn", "prefix_rank_attn", "paged_prefix_rank_attn",
        "segment_rank_attn", "ssd_chunk_intra", "ssd_chunk_state",
        "decode_attn"}
    pairs = {(m, a) for m, a in COUNTERS.values()}
    assert pairs == {(hstu_attn, "launches"), (prefix_rank_attn, "launches"),
                     (paged_prefix_attn, "launches"),
                     (paged_prefix_attn, "launches_segment"),
                     (ssd_chunk, "launches_intra"),
                     (ssd_chunk, "launches_state"),
                     (decode_attn, "launches")}


@pytest.mark.parametrize("launches", [
    {"hstu_attn": 8, "prefix_rank_attn": 8},
    {"paged_prefix_rank_attn": 8},
    {"hstu_attn": 2, "segment_rank_attn": 8},
    {"decode_attn": 6},
    {"ssd_chunk_intra": 38, "ssd_chunk_state": 38},
    {}], ids=["full-rank", "paged", "segment", "decode", "ssd", "none"])
def test_capture_tally_restores_and_replays_add_it(counters, launches):
    before = read_counters()
    out, tally = tallied(lambda: _bump(**launches) or "outputs")
    assert out == "outputs"
    assert tally == launches
    assert read_counters() == before        # a capture ran nothing
    for k in (1, 3):
        add_tally(tally, k)
    assert read_counters() == {n: before[n] + 4 * launches.get(n, 0)
                               for n in before}


def test_a_failing_capture_restores_the_counters(counters):
    before = read_counters()

    def fails():
        _bump(hstu_attn=3)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        tallied(fails)
    assert read_counters() == before


class _Replays:
    """Stands in for a torch.cuda.CUDAGraph: doubles the static input
    into the static output, as a captured ``fn`` would."""

    def __init__(self, x, out):
        self.x, self.out, self.n = x, out, 0

    def replay(self):
        self.n += 1
        self.out.copy_(2 * self.x)


def test_graph_replay_copies_inputs_checks_refs_and_counts(counters):
    x, out, pool = torch.zeros(4), torch.zeros(4), torch.zeros(8)
    fake = _Replays(x, out)
    g = Graph(("rank", 2, 64), fake, (x,), (pool,), out,
              {"prefix_rank_attn": 8})
    assert g.batch == 2
    before = read_counters()
    for k in range(3):
        got = g.replay((torch.full((4,), float(k)),), refs=(pool,))
        assert got is out and torch.equal(out, torch.full((4,), 2.0 * k))
    assert fake.n == g.replays == 3
    assert read_counters()["prefix_rank_attn"] == \
        before["prefix_rank_attn"] + 3 * 8
    # the static input itself is not copied onto itself
    g.replay((x,), refs=(pool,))
    # another pool tensor, another shape, another count of inputs: raise
    for bad in (dict(args=(x,), refs=(torch.zeros(8),)),
                dict(args=(x,), refs=(pool[:4],)),
                dict(args=(torch.zeros(5),), refs=(pool,)),
                dict(args=(x, x), refs=(pool,))):
        with pytest.raises(ValueError):
            g.replay(**bad)
    assert g.replays == 4


def test_graphs_need_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA"):
        GraphRunner("cpu")
    assert graphs.resolve_runner(None, "cpu") is None
    assert graphs.resolve_runner(False, "cpu") is None
    with pytest.raises(ValueError):
        graphs.resolve_runner(True, "cpu")


@pytest.fixture(scope="module")
def smoke_model():
    from repro_torch.models import build_model, get_config
    return build_model(get_config("hstu_gr", smoke=True), device="cpu").init(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", ["live", "batched"])
def test_executors_run_eagerly_on_the_cpu(smoke_model, name):
    from repro_torch.core import UserMeta, get_executor
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
    store = UserBehaviorStore(WorkloadConfig(
        vocab=smoke_model.cfg.vocab, n_items=16, incr_len=8, max_len=512))
    cls = get_executor(name)
    ex = cls(smoke_model, store)
    assert ex.graphs is None
    meta = UserMeta(user_id=3, prefix_len=100, incr_len=8, n_items=16)
    psi, _, _ = ex.pre_infer(meta)
    before = read_counters()
    scores, _ = ex.rank_cached(meta, psi)
    assert scores.shape == (1, 16, smoke_model.cfg.n_tasks)
    assert read_counters() == before        # the CPU runs the twins
    assert cls(smoke_model, store, graphs=False).graphs is None
    with pytest.raises(ValueError, match="CUDA"):
        cls(smoke_model, store, graphs=True)


def test_serve_step_is_eager_on_the_cpu():
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import build_model, get_config
    model = build_model(get_config("zamba2_1p2b", smoke=True), device="cpu")
    step = make_serve_step(model)
    assert not hasattr(step, "runner")
    with pytest.raises(ValueError, match="CUDA"):
        make_serve_step(model, graphs=True)


def test_serve_step_drives_an_hstu_cache_on_the_cpu(smoke_model):
    """``make_serve_step`` takes HSTU's (K, V) psi as well as the
    hybrid's cache: eager on the CPU, ``decode_step``'s logits, the cache
    handed back as it came."""
    from repro_torch.launch.steps import make_serve_step
    rng = np.random.default_rng(0)
    _, psi = smoke_model.prefill(
        {"tokens": torch.as_tensor(rng.integers(0, 500, (2, 40)))})
    before = [t.clone() for t in psi]
    batch = {"token": torch.as_tensor(rng.integers(0, 500, (2, 1))),
             "pos": torch.tensor([40, 40])}
    logits, cache = make_serve_step(smoke_model)(psi, batch)
    assert cache is psi and all(torch.equal(a, b) for a, b in zip(psi, before))
    assert logits.shape == (2, 1, smoke_model.cfg.vocab_padded)
    assert torch.equal(logits, smoke_model.decode_step(psi, batch)[0])


def test_stack_psi_into_a_static_buffer_equals_a_fresh_stack():
    from repro_torch.serving.batching import stack_psi
    rng = np.random.default_rng(0)
    psis = [tuple(torch.as_tensor(rng.standard_normal((2, 1, n, 2, 4)),
                                  dtype=torch.float32) for _ in range(2))
            for n in (64, 17, 128)]
    want = stack_psi(psis, 128)
    out = tuple(torch.full((2, 3, 128, 2, 4), 7.0) for _ in range(2))
    got = stack_psi(psis, 128, out=out)
    assert got is out
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        stack_psi(psis[:2], 128, out=out)


# --- the live benchmarks ---------------------------------------------------------


def _keys(tree):
    if not isinstance(tree, dict):
        return None
    return {k: _keys(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference_tables():
    """The reference's own calibration at the quick shapes, under JAX on
    the CPU."""
    from benchmarks.calibrate import measure, measure_h2d
    cal, _ = measure([64], [1, 2], repeats=1)
    h2d, _ = measure_h2d([256], [1, 8], repeats=1)
    return cal, h2d


@pytest.mark.parametrize("h2d", [False, True], ids=["rank", "h2d"])
def test_calibrate_quick_has_the_reference_schema(tmp_path, reference_tables,
                                                  h2d):
    from repro_torch.benchmarks import calibrate
    from repro_torch.core.costmodel import GRCostModel, load_batch_calibration
    from repro_torch.models import get_config
    out = tmp_path / "cal.json"
    cal = calibrate.main(["--device", "cpu", "--quick", "--out", str(out)]
                         + (["--h2d"] if h2d else []))
    ref, ref_h2d = reference_tables
    if h2d:
        ref = dict(ref, h2d=ref_h2d)
    assert set(cal) == set(ref)
    assert _keys(cal["buckets"]) == _keys(ref["buckets"])
    assert set(ref["meta"]) <= set(cal["meta"])
    assert cal["meta"]["graphs"] is False
    assert cal["meta"]["device"]["platform"] == "cpu"
    if h2d:
        assert _keys(cal["h2d"]) == _keys(ref["h2d"])
        assert cal["h2d"]["page_bytes"] == ref["h2d"]["page_bytes"]
        assert cal["h2d"]["scatter_bw"] > 0 and cal["h2d"]["reship_bw"] > 0
    assert json.loads(out.read_text()) == cal
    loaded = load_batch_calibration(str(out))
    cost = GRCostModel(get_config("hstu_gr")).with_calibration(str(out))
    assert cost.batch_calibration == loaded
    f = cal["buckets"]["64"]["2"]
    assert cost.batched_rank_ms([10.0, 10.0], bucket=64) == \
        pytest.approx(10.0 * (1 + f))
    assert cost.batched_rank_ms([10.0], bucket=64) == pytest.approx(10.0)


def test_calibrated_sim_changes_batched_trace_only(tmp_path):
    """As the reference's tests/test_topology.py holds for its table: a
    measured table reprices group launches only — a spaced (uncontended)
    trace is unchanged, a contended burst is priced by the table."""
    from repro_torch.benchmarks import calibrate
    from repro_torch.core import (ClusterConfig, GRCostModel, TriggerConfig,
                                  UserMeta, relay_config)
    from repro_torch.models import get_config
    from repro_torch.serving.simulator import ClusterSim
    cal = calibrate.main(["--device", "cpu", "--quick", "--out",
                          str(tmp_path / "cal.json")])
    base_cost = GRCostModel(get_config("hstu_gr"))
    # the measured factor, made to differ from the fixed 0.2 so that the
    # contended trace must move
    cal["buckets"] = {"4096": {"2": cal["default"] + 0.5,
                               "8": cal["default"] + 0.5}}
    cost = base_cost.with_calibration(cal)
    cfg = relay_config(
        trigger=TriggerConfig(n_instances=5, r2=0.4, q_m=200.0,
                              kv_p99_len=4096),
        cluster=ClusterConfig(m_slots=1, max_batch=8, hbm_cache_bytes=16e9))

    def trace(c, arrivals):
        sim = ClusterSim(cfg, c)
        sim.run(list(arrivals))
        return [(r.user_id, r.t_done, r.rank_ms) for r in sim.records]

    spaced = [(1.0 * i, UserMeta(user_id=i, prefix_len=4096))
              for i in range(10)]
    assert trace(base_cost, spaced) == trace(cost, spaced)
    burst = [(0.001 * i, UserMeta(user_id=i, prefix_len=4096))
             for i in range(40)]
    t_base = max(t for _, t, _ in trace(base_cost, burst))
    t_cal = max(t for _, t, _ in trace(cost, burst))
    assert t_cal > t_base, "a dearer measured factor must slow the burst"


def test_microbench_rows_carry_the_reference_names():
    from benchmarks.microbench import live_engine_ops as ref_ops
    from repro_torch.benchmarks import microbench
    rows = microbench.live_engine_ops("cpu")
    assert [r[0] for r in rows] == [r[0] for r in ref_ops()]
    assert all(r[1] > 0 for r in rows)
    kernel = microbench.kernel_rows("cpu")
    assert [r[0] for r in kernel] == ["micro/hstu_attn_256",
                                      "micro/prefix_rank_attn_256"]
    # on the CPU the wrapper runs its twin: the two agree exactly
    assert all("max |kernel - plain| 0.00e+00 (cpu)" in r[2] for r in kernel)
