# Port of benchmarks/figures.py: module paths renamed repro -> repro_torch,
# benchmarks -> repro_torch.benchmarks; fig11a_max_seq_len,
# fig11d_slo_throughput and bench_relay_summary take ``cost`` (default the
# capacity harness's COST, which gives the reference's output).
"""Benchmark harness: one function per paper figure/table.

Each function returns CSV rows ``(name, us_per_call, derived)`` where
``us_per_call`` is the headline latency (P99, in microseconds) or the
per-op cost, and ``derived`` is the paper-comparable headline (ratio,
max length, QPS...).  Cluster-scale numbers come from the discrete-event
simulator driven by the calibrated cost model (see EXPERIMENTS.md
§Calibration); all RelayGR state machines are the real implementations.

Paper targets being reproduced:
  Fig.11a  max supported sequence length (up to 1.5x baseline w/ DRAM)
  Fig.11b  ~2x concurrency at fixed P99
  Fig.11c  component breakdown: pre grows with L; load/rank stay low
  Fig.11d  SLO-compliant throughput (up to 3.6x w/ DRAM)
  Fig.12   remote fetch 100s of times local access
  Fig.13a-d scaling with sequence length; retrieval slack (~5x conc.)
  Fig.14a-d candidates / utilization / dim / depth extensions
  Table 1  psi = 32 MiB at 2K tokens (8L, 256d, fp32)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Tuple

import numpy as np

from repro_torch.benchmarks.capacity import (COST, HSTU, N_INST, SIM_S,
                                             SLO_MS, find_knee, fixed_stream,
                                             meets_slo, mode_config,
                                             run_point)
from repro_torch.core.costmodel import GRCostModel, HardwareModel
from repro_torch.core.runtime import (ClusterConfig, PipelineConfig,
                                      RelayConfig, relay_config)
from repro_torch.core.trigger import TriggerConfig
from repro_torch.core.types import UserMeta
from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
from repro_torch.models import get_config
from repro_torch.serving.simulator import run_sim

# the sweep machinery now lives in repro_torch.benchmarks.capacity (the
# capacity harness shares it); these names are re-exports kept for the
# historical figure functions below
_fixed_stream = fixed_stream
_run = run_point


def _cfg(mode: str, L: int, cost=None) -> RelayConfig:
    """Per-mode deployment config — see ``capacity.mode_config`` for
    the mode glossary (this wrapper keeps the historical signature)."""
    return mode_config(mode, L)


def _meets_slo(s) -> bool:
    return meets_slo(s, SLO_MS)


def _meets_rank_budget(s) -> bool:
    """Ranking-stage criterion (Fig.13d style): the rank stage —
    queueing + load + rank-on-cache — stays within its own budget."""
    return s.get("n", 0) > 0 and s["rank_p99_ms"] <= 50.0


def _meets_ext_budget(s) -> bool:
    """Extension-study criterion (Fig.14c/d): relaxed rank budget so the
    scaled-up baselines stay measurable (the paper reports throughput
    curves, not SLO feasibility, for these sweeps)."""
    return s.get("n", 0) > 0 and s["rank_p99_ms"] <= 80.0


def _max_qps(mode, L, *, cost=None, lo=5, hi=None, pipeline=None,
             criterion=_meets_slo, n_items=512, refresh=None,
             dur=SIM_S, coarse=False) -> float:
    """Largest offered QPS meeting the SLO criterion (the shared
    geometric-expansion knee-finder, ``capacity.find_knee``: the upper
    probe doubles until the criterion fails, so there is no hard search
    cap to silently clip future throughput gains — ``hi`` merely seeds
    the first probe).

    Under the pipeline-SLO criterion the value is goodput (SLO-compliant
    completions/s); under stage-budget criteria it is raw completed
    throughput (the paper's Fig.13d/14 y-axes).  ``coarse`` widens the
    bisection tolerance (used by --quick CI smoke runs)."""
    key = "goodput_qps" if criterion is _meets_slo else "throughput_qps"

    def measure(q):
        return _run(mode, L, q, cost=cost, pipeline=pipeline,
                    n_items=n_items, refresh=refresh, dur=dur)

    return find_knee(measure, criterion, lo=lo, hi=hi, key=key,
                     coarse=coarse).best


# ---------------------------------------------------------------------------
# Fig. 11 — effectiveness
# ---------------------------------------------------------------------------

LENS_11A = [1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384]


def fig11a_max_seq_len(cost=None) -> List[Tuple]:
    rows = []
    maxlen = {}
    for mode in ("baseline", "relay", "relay_dram"):
        ok = 0
        for L in LENS_11A:
            s = _run(mode, L, qps=60, cost=cost)
            if _meets_slo(s):
                ok = L
            rows.append((f"fig11a/{mode}/L{L}", s["p99_ms"] * 1e3,
                         f"success={s['success_rate']:.4f}"))
        maxlen[mode] = ok
    base = max(maxlen["baseline"], 1)
    rows.append(("fig11a/max_len_ratio_relay", maxlen["relay"],
                 f"{maxlen['relay'] / base:.2f}x"))
    rows.append(("fig11a/max_len_ratio_relay_dram", maxlen["relay_dram"],
                 f"{maxlen['relay_dram'] / base:.2f}x (paper: up to 1.5x)"))
    return rows


def fig11b_tail_vs_concurrency() -> List[Tuple]:
    rows, L = [], 2048
    max_c = {}
    for mode in ("baseline", "relay", "relay_dram"):
        ok = 0
        for qps in (25, 50, 100, 150, 200, 300, 400):
            s = _run(mode, L, qps)
            if _meets_slo(s):
                ok = qps
            rows.append((f"fig11b/{mode}/qps{qps}", s["p99_ms"] * 1e3,
                         f"goodput={s['goodput_qps']:.0f}"))
        max_c[mode] = ok
    rows.append(("fig11b/concurrency_gain", max_c["relay"],
                 f"{max_c['relay'] / max(max_c['baseline'], 1):.1f}x "
                 "(paper: ~2x)"))
    return rows


def fig11c_breakdown() -> List[Tuple]:
    rows = []
    for L in (1024, 2048, 4096, 8192):
        pre = COST.pre_infer_ms(L)
        load = COST.dram_load_ms(L)
        rank = COST.rank_on_cache_ms(L, 64, 512)
        full = COST.full_rank_ms(L, 64, 512)
        rows.append((f"fig11c/L{L}", pre * 1e3,
                     f"pre={pre:.1f}ms load={load:.1f}ms rank={rank:.1f}ms "
                     f"baseline_full={full:.1f}ms"))
    return rows


def fig11d_slo_throughput(cost=None) -> List[Tuple]:
    rows, L = [], 2048
    qps = {m: _max_qps(m, L, cost=cost)
           for m in ("baseline", "relay", "relay_dram")}
    for m, v in qps.items():
        rows.append((f"fig11d/{m}", 1e6 / max(v, 1e-9), f"{v:.0f} qps"))
    base = max(qps["baseline"], 1e-9)
    rows.append(("fig11d/throughput_gain_relay", qps["relay"],
                 f"{qps['relay'] / base:.2f}x"))
    rows.append(("fig11d/throughput_gain_relay_dram", qps["relay_dram"],
                 f"{qps['relay_dram'] / base:.2f}x (paper: up to 3.6x)"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 12 — affinity is necessary
# ---------------------------------------------------------------------------


def fig12_local_vs_remote() -> List[Tuple]:
    rows = []
    for L in (1024, 2048, 4096, 8192, 16384):
        local_ms = COST.kv_bytes(L) / COST.hw.hbm_bw * 1e3
        remote_ms = COST.remote_fetch_ms(L)
        rows.append((f"fig12/L{L}", remote_ms * 1e3,
                     f"remote/local={remote_ms / local_ms:.0f}x "
                     "(paper: 100s of x)"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 13 — scaled sequences
# ---------------------------------------------------------------------------


def fig13a_throughput_vs_len() -> List[Tuple]:
    rows = []
    collapse_len = None
    for L in (2048, 4096, 6144, 8192, 12288):
        for mode, refresh in (("baseline", 0.0), ("relay", 0.0),
                              ("relay_dram", 0.95)):
            q = _max_qps(mode, L)
            rows.append((f"fig13a/{mode}/L{L}", 1e6 / max(q, 1e-9),
                         f"{q:.0f} qps"))
            if mode == "baseline" and L >= 6144 and q < 10 \
                    and collapse_len is None:
                collapse_len = L
    rows.append(("fig13a/baseline_collapse",
                 collapse_len or 0,
                 "baseline <10qps beyond ~6K (paper: a few qps)"))
    return rows


def fig13b_components_long() -> List[Tuple]:
    rows = []
    for L in (4096, 8192, 15360):
        load = COST.dram_load_ms(L)
        rank = COST.rank_on_cache_ms(L, 64, 512)
        rows.append((f"fig13b/L{L}", load * 1e3,
                     f"load={load:.1f}ms rank={rank:.1f}ms "
                     "(paper@15K: load<20 rank<10)"))
    return rows


def fig13c_load_under_concurrency() -> List[Tuple]:
    rows = []
    for L in (4096, 8192):
        for qps in (50, 150):
            s = _run("relay_dram", L, qps, refresh=0.9)
            rows.append((f"fig13c/L{L}/qps{qps}", s["load_p99_ms"] * 1e3,
                         f"dram_hit={s['dram_hit']:.2f} "
                         f"full_baseline={COST.full_rank_ms(L, 64, 512):.0f}ms"))
    return rows


def fig13d_retrieval_slack() -> List[Tuple]:
    """Criterion: ranking-stage P99 <= 50 ms budget (the paper varies
    the retrieval budget independently of the pipeline SLO)."""
    rows, L = [], 3072
    conc = {}
    for ret_ms in (20, 60, 100):
        pp = PipelineConfig(retrieval_ms=ret_ms)
        conc[ret_ms] = _max_qps("relay", L, pipeline=pp,
                                criterion=_meets_ext_budget)
        rows.append((f"fig13d/relay/slack{ret_ms}ms", ret_ms * 1e3,
                     f"{conc[ret_ms]:.0f} qps"))
    base = _max_qps("baseline", L, criterion=_meets_ext_budget,
                    pipeline=PipelineConfig(retrieval_ms=100))
    rows.append(("fig13d/baseline/slack100ms", 100e3, f"{base:.0f} qps"))
    rows.append(("fig13d/slack_gain", conc[100],
                 f"{conc[100] / max(base, 1):.1f}x (paper: ~5x @100ms)"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 14 — extensions
# ---------------------------------------------------------------------------


def fig14a_candidates() -> List[Tuple]:
    rows, L = [], 4096
    for items in (128, 512, 1024, 2048):
        r = COST.rank_on_cache_ms(L, 64, items)
        f = COST.full_rank_ms(L, 64, items)
        rows.append((f"fig14a/items{items}", r * 1e3,
                     f"rank_cached={r:.1f}ms full={f:.1f}ms "
                     "(paper: <10ms @2048)"))
    return rows


def fig14b_utilization() -> List[Tuple]:
    rows, L = [], 2048
    for mode, refresh in (("relay", 0.0), ("relay_dram", 0.95)):
        for qps in (50, 150, 250):
            s = _run(mode, L, qps, refresh=refresh)
            rows.append((f"fig14b/{mode}/qps{qps}",
                         s["special_util"] * 1e6,
                         f"util={s['special_util']:.2f} "
                         f"p99={s['p99_ms']:.0f}ms"))
    return rows


def _scaled_cost(dim=None, layers=None) -> GRCostModel:
    cfg = HSTU
    kw = {}
    hw = HardwareModel()
    if dim:
        kw.update(d_model=dim, d_ff=4 * dim,
                  n_heads=max(dim // 64, 1), head_dim=64)
        # sustained FLOP/s grows with GEMM width (cube utilization):
        # calibrated ^0.75 scaling, documented in EXPERIMENTS.md
        hw = HardwareModel(eff_flops=2e12 * (dim / 256) ** 0.75)
    if layers:
        kw.update(n_layers=layers)
    return GRCostModel(dataclasses.replace(cfg, **kw), hw)


def fig14c_dimension_scaling() -> List[Tuple]:
    rows, L = [], 2048
    per_dim = {}
    for dim in (256, 512, 1024):
        cost = _scaled_cost(dim=dim)
        q = {m: _max_qps(m, L, cost=cost, n_items=128,
                         criterion=_meets_ext_budget)
             for m in ("baseline", "relay", "relay_dram")}
        per_dim[dim] = q
        rows.append((f"fig14c/dim{dim}", 1e6 / max(q["relay"], 1e-9),
                     f"base={q['baseline']:.0f} relay={q['relay']:.0f} "
                     f"dram={q['relay_dram']:.0f} qps"))
    q = per_dim[1024]
    rows.append(("fig14c/gain@1024", q["relay"],
                 f"relay={q['relay'] / max(q['baseline'], 1):.1f}x "
                 f"dram={q['relay_dram'] / max(q['baseline'], 1):.1f}x "
                 "(paper: >=2x, ~3x)"))
    return rows


def fig14d_depth_scaling() -> List[Tuple]:
    rows, L = [], 2048
    per = {}
    for layers in (8, 16):
        cost = _scaled_cost(layers=layers)
        q = {m: _max_qps(m, L, cost=cost, criterion=_meets_ext_budget,
                         refresh=0.95 if m == "relay_dram" else None)
             for m in ("baseline", "relay", "relay_dram")}
        per[layers] = q
        rows.append((f"fig14d/layers{layers}",
                     1e6 / max(q["relay"], 1e-9),
                     f"base={q['baseline']:.0f} relay={q['relay']:.0f} "
                     f"dram={q['relay_dram']:.0f} qps"))
    g16 = per[16]["relay_dram"] / max(per[16]["baseline"], 1)
    drop = 1 - per[16]["relay_dram"] / max(per[8]["relay_dram"], 1e-9)
    rows.append(("fig14d/gain@16L", per[16]["relay_dram"],
                 f"{g16:.1f}x vs baseline (paper: >=4x); "
                 f"100%-hit depth-doubling drop={drop:.0%} (paper: ~14%)"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 15 + Table 1 — generality & cache footprint
# ---------------------------------------------------------------------------


def fig15_generality() -> List[Tuple]:
    """Fig.15a: GR model variants on 910C; Fig.15b: NPU types with the
    Type-1 model.  Absolute numbers differ by up to an order of
    magnitude (as in the paper); the relay gain stays > 1 everywhere.
    Each point uses a request profile its hardware can serve at all
    (the paper likewise tunes per-deployment defaults)."""
    rows = []
    variants = {
        "type1_hstu": (_scaled_cost(), 2048, 512),
        "type2_hstu_rev": (GRCostModel(
            dataclasses.replace(HSTU, n_heads=8, head_dim=32)), 2048, 512),
        "type3_longer_rankmixer": (_scaled_cost(dim=512), 2048, 128),
    }
    for vname, (cost, L, items) in variants.items():
        q = {m: _max_qps(m, L, cost=cost, n_items=items,
                         criterion=_meets_ext_budget)
             for m in ("baseline", "relay")}
        gain = q["relay"] / max(q["baseline"], 1)
        rows.append((f"fig15a/{vname}/910c", 1e6 / max(q['relay'], 1e-9),
                     f"relay_gain={gain:.1f}x (>1 for all models)"))
    npus = {"ascend310": (HardwareModel(eff_flops=0.4e12), 1024, 64),
            "ascend910c": (HardwareModel(), 2048, 512)}
    for nname, (hw, L, items) in npus.items():
        c = GRCostModel(HSTU, hw)
        q = {m: _max_qps(m, L, cost=c, n_items=items,
                         criterion=_meets_ext_budget)
             for m in ("baseline", "relay")}
        gain = q["relay"] / max(q["baseline"], 1)
        rows.append((f"fig15b/type1/{nname}", 1e6 / max(q['relay'], 1e-9),
                     f"relay_gain={gain:.1f}x (>1 on both NPUs)"))
    return rows


def table1_kv_footprint() -> List[Tuple]:
    b = COST.kv_bytes(2048)
    return [("table1/kv_2k_8L_256d_fp32", b,
             f"{b / 2**20:.0f} MiB (paper: 32 MB)")]


# ---------------------------------------------------------------------------
# machine-readable perf headline (BENCH_relay.json)
# ---------------------------------------------------------------------------


def bench_relay_summary(quick: bool = False, cost=None) -> Dict:
    """Per-mode perf headline for the repo's perf trajectory: P99,
    SLO-compliant throughput and hit rates at a fixed reference point
    (L=2048, 60 offered QPS), plus the bisected max SLO-compliant QPS
    when not in quick mode.  Written by ``benchmarks/run.py`` to
    ``BENCH_relay.json`` so successive PRs can diff serving performance.
    ``cost`` prices every run (default: the capacity harness's ``COST``).
    """
    L, qps = 2048, 60
    # workload provenance: the regression gate refuses to diff headlines
    # produced under mismatched workloads (seed / draw population /
    # arrival process), so a knob change can't masquerade as a perf win
    out: Dict[str, Dict] = {"meta": {
        "L": L, "offered_qps": qps, "slo_ms": SLO_MS, "sim_s": SIM_S,
        "seed": 0, "horizon": 10**9, "arrival": "poisson",
        "workload": "uniform"}}
    for mode in ("baseline", "relay", "relay_dram", "relay_batched",
                 "relay_paged", "relay_devpool", "relay_segments",
                 "relay_multihost", "relay_disagg", "relay_cold",
                 "relay_tenants"):
        s = _run(mode, L, qps, cost=cost)
        entry = {
            "p50_ms": round(s["p50_ms"], 3),
            "p99_ms": round(s["p99_ms"], 3),
            "rank_p99_ms": round(s["rank_p99_ms"], 3),
            "success_rate": round(s["success_rate"], 4),
            "goodput_qps": round(s["goodput_qps"], 1),
            "hbm_hit": round(s["hbm_hit"], 4),
            "dram_hit": round(s["dram_hit"], 4),
            "cold_hit": round(s.get("cold_hit", 0.0), 4),
            "miss": round(s["miss"], 4),
            "reused_frac": round(s["reused_frac"], 4),
        }
        # quick (CI smoke) still reports slo_qps — shorter sims and a
        # coarser bisection keep it cheap while preserving the fields
        # the workflow gate checks
        entry["slo_qps"] = round(
            _max_qps(mode, L, cost=cost, dur=4.0 if quick else SIM_S,
                     coarse=quick), 1)
        out[mode] = entry
    # tail-user probe: the cold tier only differentiates once admission
    # rate-limits (below the pool ceiling every admitted request
    # pre-infers and trivially hits HBM), so the headline includes the
    # reuse fraction PAST the knee — at 1.15x relay_segments' measured
    # slo_qps under the rapid-refresh workload — where rate-limited
    # returning users must be served out of the memory hierarchy.  The
    # regression gate requires relay_cold to beat relay_segments here:
    # hbm + dram + cold reuse, the tail users the DRAM-less modes
    # re-rank from scratch.
    q_tail = round(1.15 * out["relay_segments"]["slo_qps"], 1)
    for mode in ("relay_segments", "relay_cold"):
        s = _run(mode, L, q_tail, cost=cost, refresh=0.5,
                 dur=4.0 if quick else SIM_S)
        out[mode]["tail_qps"] = q_tail
        out[mode]["tail_reuse_frac"] = round(
            s["hbm_hit"] + s["dram_hit"] + s.get("cold_hit", 0.0), 4)
        out[mode]["tail_cold_hit"] = round(s.get("cold_hit", 0.0), 4)
    return out


ALL_FIGURES = [
    fig11a_max_seq_len, fig11b_tail_vs_concurrency, fig11c_breakdown,
    fig11d_slo_throughput, fig12_local_vs_remote, fig13a_throughput_vs_len,
    fig13b_components_long, fig13c_load_under_concurrency,
    fig13d_retrieval_slack, fig14a_candidates, fig14b_utilization,
    fig14c_dimension_scaling, fig14d_depth_scaling, fig15_generality,
    table1_kv_footprint,
]
