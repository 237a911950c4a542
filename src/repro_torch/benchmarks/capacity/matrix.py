# Copied from benchmarks/capacity/matrix.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Declarative capacity matrix: {mode × sequence length × workload ×
offered QPS} → per-cell latency distributions + per-cell knee.

benchalot-style: a ``MatrixSpec`` (buildable from a plain dict / JSON
file) declares the axes; ``run_matrix`` executes every cell through the
discrete-event ``ClusterSim`` (the real relay state machines under the
calibrated cost model), finds each cell's SLO knee with the shared
geometric-expansion knee-finder, and measures a latency–throughput
curve at knee-anchored offered-QPS fractions.

The mode configurations (``mode_config``) and the single-point runner
(``run_point``) are the machinery formerly buried in
``benchmarks/figures.py`` (``_cfg`` / ``_run``); figures re-exports
them, so the paper-figure harness and the capacity harness can never
drift apart.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.costmodel import GRCostModel
from repro_torch.core.runtime import ClusterConfig, RelayConfig, relay_config
from repro_torch.core.trigger import TriggerConfig
from repro_torch.models import get_config
from repro_torch.serving.simulator import ClusterSim

from .knee import KneeResult, find_knee
from .workload import WorkloadSpec, fixed_stream

HSTU = get_config("hstu_gr")
COST = GRCostModel(HSTU)

N_INST = 5          # 4 active + 1 idle opposite-pool instance
SIM_S = 12.0
SLO_MS = 135.0

#: every serving mode the harness understands (the BENCH_relay set)
ALL_MODES = ("baseline", "relay", "relay_dram", "relay_batched",
             "relay_paged", "relay_devpool", "relay_segments",
             "relay_multihost", "relay_disagg", "relay_cold",
             "relay_tenants")


def mode_config(mode: str, L: int, *, hosts: Optional[int] = None,
                prefill_hosts: Optional[int] = None) -> RelayConfig:
    """mode: baseline | relay | relay_dram | relay_batched | relay_paged
    | relay_devpool | relay_segments | relay_multihost | relay_disagg
    | relay_cold | relay_tenants

    ``relay_batched`` is the ``relay`` deployment with continuous
    micro-batching switched on (same trigger/cache -> equal hit rates);
    the throughput delta is pure batching.  ``relay_paged`` is
    ``relay_batched`` over the paged HBM window (64-token pages): same
    trigger and byte budget, psi block-granular — hit rates must match
    ``relay_batched`` with slo_qps within tolerance (page-rounded load
    times are the only modelled difference at page-aligned L).
    ``relay_devpool`` is ``relay_paged`` with the device-resident page
    pool: inserts/reloads scatter only fresh pages and rank launches
    pass the pool by reference instead of re-shipping it.  In the
    simulator the pool data plane is byte-free, so the trace — hit
    rates, latency, slo_qps — must be IDENTICAL to ``relay_paged``
    (the h2d win is a live-serving property, gated by the CI smoke's
    ``launch_reships == 0`` assert and measured by
    ``benchmarks/calibrate.py --h2d``); the row exists so the sim
    config path stays exercised and regression-gated.
    ``relay_segments`` is ``relay_paged`` with beyond-prefix reuse
    (RcLLM): the stream attaches per-user candidate-independent
    ``seg_lens``, the side path caches those interior segments
    alongside the prefix as page-aligned spans, and a cache hit ranks
    only the truly fresh incr tokens — the reused-token fraction per
    hit must EXCEED ``relay_paged`` at equal-or-better slo_qps.
    ``relay_multihost`` is ``relay_batched`` striped over two hosts
    (owner-map -> per-host ring routing, per-host DRAM tiers): affinity
    hit rates must stay within 2% of the single-host deployment — the
    two-level rendezvous changes WHERE producer and consumer meet, not
    whether they do.  ``relay_disagg`` is ``relay_multihost`` with the
    pre-infer side path disaggregated onto dedicated prefill hosts:
    psi ships cross-host to its owner over the NIC fabric, so hit
    rates must stay within 2% of ``relay_multihost`` (the shipment
    lands inside the retrieval slack at the reference point) while the
    ranking hosts' slots are freed of prefill compute.  The prefill
    tier is provisioned with headroom (two hosts x 20 slots: the point
    of disaggregation is that the side path never contends, so pre
    groups stay shallow and the NIC hop still beats the retrieval
    slack at the admission ceiling) and two NIC links, so neither
    compute nor the fabric caps admission below the colocated
    600/s pool ceiling (Eq. 3b).  ``relay_cold`` is ``relay_segments``
    with the full memory hierarchy under it: a bounded DRAM expander
    (4 GB, ~120 psi — small enough that skewed traffic overflows it)
    plus a 500 GB host-local cold tier (SSD / remote psi store) that
    absorbs DRAM evictions as demotions and revives cold-resident
    users through an async cold->DRAM->HBM promotion priced on the
    cold bandwidth class — tail users that every DRAM-only mode
    re-prefills come back as cache hits.  ``relay_tenants`` is
    ``relay_batched`` serving TWO tenants off the one fleet: every
    memory tier is split into per-tenant byte quotas (a tenant can
    only evict its own entries), admission layers per-tenant token
    buckets under the instance/pool split, and ``run_point`` stamps
    each request's tenant as ``user_id % 2`` — a pure function of the
    id, so the arrival trace is identical to ``relay_batched``'s and
    any hit-rate delta is the partition itself.

    ``hosts`` / ``prefill_hosts`` override the mode's default topology
    (the capacity matrix's hosts axis); ``None`` keeps the default.
    """
    if mode not in ALL_MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {ALL_MODES}")
    relay = mode != "baseline"
    r2 = 0.8 if relay else 0.2   # 4 active instances either way
    hbm_cache = 4e9
    batched = mode in ("relay_batched", "relay_paged", "relay_devpool",
                       "relay_segments", "relay_multihost",
                       "relay_disagg", "relay_cold", "relay_tenants")
    paged = mode in ("relay_paged", "relay_devpool", "relay_segments",
                     "relay_cold")
    multihost = mode in ("relay_multihost", "relay_disagg")
    if hosts is None:
        hosts = 2 if multihost else 1
    if prefill_hosts is None:
        prefill_hosts = 2 if mode == "relay_disagg" else 0
    return relay_config(
        trigger=TriggerConfig(n_instances=N_INST, r2=r2,
                              kv_p99_len=max(L, 1024),
                              hbm_bytes=hbm_cache / 0.5, r1=0.5,
                              t_life_s=0.5),
        cluster=ClusterConfig(
            relay_enabled=relay,
            dram_budget_bytes=(500e9 if mode == "relay_dram"
                               else 4e9 if mode == "relay_cold" else 0.0),
            cold_budget_bytes=500e9 if mode == "relay_cold" else 0.0,
            hbm_cache_bytes=hbm_cache,
            max_batch=8 if batched else 0,
            batch_wait_ms=2.0,
            hosts=hosts,
            prefill_hosts=prefill_hosts,
            prefill_m_slots=20 if prefill_hosts else 0,
            page_tokens=64 if paged else 0,
            device_pool=mode == "relay_devpool",
            segments=mode in ("relay_segments", "relay_cold"),
            tenants=2 if mode == "relay_tenants" else 1),
    )


# ---------------------------------------------------------------------------
# single-point runners
# ---------------------------------------------------------------------------


def _distribution(sim: ClusterSim, summary: Dict) -> Dict:
    """Extend a runtime summary with the full latency distribution the
    capacity curves commit (the runtime's summary stops at p50/p99)."""
    recs = sim.records
    if not recs:
        return dict(summary)
    e2e = np.array([r.e2e_ms for r in recs])
    out = dict(summary)
    out.update(
        mean_ms=float(e2e.mean()),
        p90_ms=float(np.percentile(e2e, 90)),
        p95_ms=float(np.percentile(e2e, 95)),
        max_ms=float(e2e.max()))
    return out


def run_point(mode, L, qps, *, cost=None, dur=SIM_S, seed=0, refresh=None,
              pipeline=None, n_items=512, workload: Optional[WorkloadSpec]
              = None, hosts=None, prefill_hosts=None,
              distribution: bool = False) -> Dict:
    """Run ONE (mode, L, workload, offered-qps) operating point through
    the cluster simulator and return its summary (formerly
    ``figures._run``).  ``workload=None`` keeps the legacy uniform
    ``fixed_stream``; ``distribution=True`` adds the extended
    percentiles the capacity curves commit."""
    cost = cost or COST
    refresh = (0.5 if mode in ("relay_dram", "relay_cold") else 0.0) \
        if refresh is None else refresh
    cfg = mode_config(mode, L, hosts=hosts, prefill_hosts=prefill_hosts)
    if pipeline is not None:
        cfg = dataclasses.replace(cfg, pipeline=pipeline)
    if workload is None:
        arr = fixed_stream(L, qps, dur, refresh=refresh, seed=seed,
                           dim=cost.cfg.d_model, n_items=n_items)
    else:
        arr = workload.stream(L, qps, dur, seed=seed,
                              dim=cost.cfg.d_model, n_items=n_items)
    if cfg.cluster.segments:
        # attach per-user candidate-independent seg_lens from the
        # dedicated hash RNG — the arrival/popularity draws above are
        # untouched, so relay_segments sees the exact trace relay_paged
        # sees, plus segment annotations
        from repro_torch.data.synthetic import segment_lens
        arr = ((t, dataclasses.replace(
            m, seg_lens=segment_lens(m.user_id, m.incr_len)))
            for t, m in arr)
    if cfg.cluster.tenants > 1:
        # stamp each request's tenant as a pure function of the user id
        # (no RNG draw): relay_tenants replays the exact trace the
        # untenanted modes see, so any metric delta is the partition
        n_t = int(cfg.cluster.tenants)
        arr = ((t, dataclasses.replace(m, tenant=m.user_id % n_t))
               for t, m in arr)
    sim = ClusterSim(cfg, cost)
    s = sim.run(arr)
    return _distribution(sim, s) if distribution else s


def meets_slo(s: Dict, slo_ms: float = SLO_MS) -> bool:
    """Pipeline-SLO criterion: P99 within the end-to-end SLO and
    (essentially) every request completed."""
    return s.get("n", 0) > 0 and s["p99_ms"] <= slo_ms \
        and s["success_rate"] >= 0.999


# ---------------------------------------------------------------------------
# the matrix
# ---------------------------------------------------------------------------


DEFAULT_WORKLOADS = (
    WorkloadSpec(skew=0.0, arrival="poisson"),     # legacy reference
    WorkloadSpec(skew=1.1, arrival="poisson"),     # head-skewed traffic
    WorkloadSpec(skew=1.1, arrival="mmpp"),        # skewed AND bursty
)


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """Declarative capacity matrix (see capacity/README.md for the JSON
    schema).  Cells are the cartesian product of ``modes`` ×
    ``lengths`` × ``workloads`` × ``hosts_axis``; the offered-QPS axis
    of each cell is knee-anchored (``curve_fractions`` × the cell's
    measured knee), so every mode's curve brackets ITS OWN saturation
    point instead of sharing one global sweep."""
    modes: Tuple[str, ...] = ("baseline", "relay", "relay_batched",
                              "relay_disagg", "relay_cold")
    lengths: Tuple[int, ...] = (2048, 4096)
    workloads: Tuple[WorkloadSpec, ...] = DEFAULT_WORKLOADS
    curve_fractions: Tuple[float, ...] = (0.5, 0.75, 0.9, 1.0, 1.15)
    hosts_axis: Tuple[Optional[int], ...] = (None,)   # None -> mode default
    duration_s: float = SIM_S
    slo_ms: float = SLO_MS
    seed: int = 0
    quick: bool = False

    @classmethod
    def quick_spec(cls) -> "MatrixSpec":
        """The CI smoke matrix: 3 cells, short sims, coarse knees."""
        return cls(modes=("baseline", "relay_batched", "relay_disagg"),
                   lengths=(2048,),
                   workloads=(WorkloadSpec(skew=1.1, arrival="poisson"),),
                   curve_fractions=(0.7, 1.0),
                   duration_s=4.0, quick=True)

    def to_dict(self) -> Dict:
        return {"modes": list(self.modes),
                "lengths": list(self.lengths),
                "workloads": [w.to_dict() for w in self.workloads],
                "curve_fractions": list(self.curve_fractions),
                "hosts_axis": list(self.hosts_axis),
                "duration_s": self.duration_s,
                "slo_ms": self.slo_ms,
                "seed": self.seed,
                "quick": self.quick}

    @classmethod
    def from_dict(cls, d: Dict) -> "MatrixSpec":
        kw: Dict = {}
        for f in ("duration_s", "slo_ms", "seed", "quick"):
            if f in d:
                kw[f] = d[f]
        if "modes" in d:
            kw["modes"] = tuple(d["modes"])
        if "lengths" in d:
            kw["lengths"] = tuple(int(x) for x in d["lengths"])
        if "workloads" in d:
            kw["workloads"] = tuple(WorkloadSpec.from_dict(w)
                                    for w in d["workloads"])
        if "curve_fractions" in d:
            kw["curve_fractions"] = tuple(float(x)
                                          for x in d["curve_fractions"])
        if "hosts_axis" in d:
            kw["hosts_axis"] = tuple(None if x is None else int(x)
                                     for x in d["hosts_axis"])
        return cls(**kw)

    def cell_keys(self) -> List[Tuple]:
        return list(itertools.product(self.modes, self.lengths,
                                      self.workloads, self.hosts_axis))


def cell_name(mode: str, L: int, wl: WorkloadSpec,
              hosts: Optional[int] = None) -> str:
    name = f"{mode}/L{L}/{wl.name}"
    return name if hosts is None else f"{name}/hosts{hosts}"


CURVE_FIELDS = ("offered_qps", "n", "p50_ms", "p90_ms", "p95_ms", "p99_ms",
                "mean_ms", "max_ms", "rank_p99_ms", "pre_p99_ms",
                "load_p99_ms", "throughput_qps", "goodput_qps",
                "success_rate", "hbm_hit", "dram_hit", "cold_hit", "miss",
                "special_util", "reused_frac")


def _curve_row(qps: float, s: Dict) -> Dict:
    row = {"offered_qps": round(float(qps), 2)}
    for f in CURVE_FIELDS[1:]:
        v = s.get(f)
        if v is not None:
            row[f] = round(float(v), 4)
    return row


def run_cell(mode: str, L: int, wl: WorkloadSpec, *,
             hosts: Optional[int] = None, fractions=(0.5, 0.75, 0.9,
                                                     1.0, 1.15),
             dur: float = SIM_S, slo_ms: float = SLO_MS, seed: int = 0,
             cost: Optional[GRCostModel] = None, coarse: bool = False
             ) -> Dict:
    """One matrix cell: knee search (geometric expansion + bisection)
    followed by the latency–throughput curve at knee-anchored offered
    QPS.  Returns the committed cell record."""
    def measure(q: float) -> Dict:
        return run_point(mode, L, q, workload=wl, dur=dur, seed=seed,
                         cost=cost, hosts=hosts)

    res: KneeResult = find_knee(
        measure, lambda s: meets_slo(s, slo_ms), coarse=coarse)
    knee = res.knee_qps
    curve = []
    for frac in fractions:
        q = max(frac * knee, 1.0)
        s = run_point(mode, L, q, workload=wl, dur=dur, seed=seed,
                      cost=cost, hosts=hosts, distribution=True)
        curve.append(_curve_row(q, s))
    return {
        "mode": mode, "L": L, "workload": wl.to_dict(),
        "workload_name": wl.name,
        "head_share_top100": round(wl.head_share(100), 4),
        "tail_share_top100": round(wl.tail_share(100), 4),
        "hosts": hosts,
        "knee_qps": round(knee, 1),
        "knee_goodput_qps": round(res.best, 1),
        "knee_capped": res.capped,
        "knee_probes": len(res.probes),
        "curve": curve,
    }


def run_matrix(spec: MatrixSpec, *, cost: Optional[GRCostModel] = None,
               progress: Optional[Callable[[str], None]] = None
               ) -> Dict[str, Dict]:
    """Execute every cell of the matrix; returns ``{cell_name: record}``
    ordered by the spec's axes."""
    cells: Dict[str, Dict] = {}
    keys = spec.cell_keys()
    for i, (mode, L, wl, hosts) in enumerate(keys):
        name = cell_name(mode, L, wl, hosts)
        if progress is not None:
            progress(f"[{i + 1}/{len(keys)}] {name}")
        cells[name] = run_cell(
            mode, L, wl, hosts=hosts, fractions=spec.curve_fractions,
            dur=spec.duration_s, slo_ms=spec.slo_ms, seed=spec.seed,
            cost=cost, coarse=spec.quick)
        if progress is not None:
            c = cells[name]
            progress(f"    knee={c['knee_qps']:.0f} qps "
                     f"(goodput {c['knee_goodput_qps']:.0f}/s, "
                     f"{c['knee_probes']} probes)")
    return cells


# ---------------------------------------------------------------------------
# two-tenant burst isolation (the relay_tenants acceptance cell)
# ---------------------------------------------------------------------------

#: tenant B's mean offered load during the isolation bench's MMPP
#: burst — sized well inside the fleet's headroom so the bench measures
#: the PARTITION (quotas + per-tenant buckets), not raw compute
#: contention, which no cache policy can hide
ISO_BURST_QPS = 10.0


def run_tenant_point(qps_a: float, *, burst_qps: float = 0.0,
                     L: int = 2048, dur: float = SIM_S, seed: int = 0,
                     cost: Optional[GRCostModel] = None) -> Dict:
    """One two-tenant operating point: tenant A (skewed Poisson) at
    ``qps_a`` next to tenant B (skewed MMPP burst) at mean
    ``burst_qps`` (0 = solo A), through the ``relay_tenants``
    deployment.  Returns tenant A's ``tenant_summary`` slice — the
    isolation bench compares that slice solo vs under B's burst.

    The config is IDENTICAL in both runs (two-tenant quotas either
    way); only B's traffic changes, and ``multi_tenant_stream`` seeds
    each tenant's RNG independently, so A's arrival/popularity draws
    are bit-identical with or without the burst."""
    from repro_torch.data.synthetic import multi_tenant_stream
    cost = cost or COST
    cfg = mode_config("relay_tenants", L)
    mixes = [dict(L=L, qps=qps_a, skew=1.1, arrival="poisson",
                  dim=cost.cfg.d_model, n_items=512)]
    if burst_qps > 0:
        mixes.append(dict(L=L, qps=burst_qps, skew=1.1, arrival="mmpp",
                          dim=cost.cfg.d_model, n_items=512))
    sim = ClusterSim(cfg, cost)
    sim.run(multi_tenant_stream(mixes, dur, seed=seed))
    s = sim.runtime.tenant_summary().get(0, {"n": 0})
    if s.get("n"):
        s["goodput_qps"] = s["n"] * s["success_rate"] / dur
    return s


def isolation_cell(*, burst_qps: float = ISO_BURST_QPS, L: int = 2048,
                   dur: float = SIM_S, slo_ms: float = SLO_MS,
                   seed: int = 0, cost: Optional[GRCostModel] = None,
                   coarse: bool = False) -> Dict:
    """The committed burst-isolation record (``BENCH_capacity.json``'s
    ``isolation`` block): tenant A's SLO knee and hit rate, measured
    solo and again while tenant B runs an MMPP burst on the same
    fleet.  The regression gate requires the burst to move neither —
    per-tenant byte quotas keep B out of A's cache, and the per-tenant
    admission bucket keeps B's surge out of A's pool-token share."""
    def knee_of(burst: float) -> KneeResult:
        return find_knee(
            lambda q: run_tenant_point(q, burst_qps=burst, L=L, dur=dur,
                                       seed=seed, cost=cost),
            lambda s: meets_slo(s, slo_ms), coarse=coarse)

    solo_knee = knee_of(0.0)
    burst_knee = knee_of(burst_qps)
    # hit-rate comparison at one fixed operating point safely below the
    # solo knee (knee noise must not move the reference load)
    q_ref = max(0.75 * solo_knee.knee_qps, 1.0)
    solo = run_tenant_point(q_ref, burst_qps=0.0, L=L, dur=dur,
                            seed=seed, cost=cost)
    burst = run_tenant_point(q_ref, burst_qps=burst_qps, L=L, dur=dur,
                             seed=seed, cost=cost)

    def slice_rec(knee: KneeResult, s: Dict) -> Dict:
        return {"knee_qps": round(knee.knee_qps, 1),
                "n": int(s.get("n", 0)),
                "hit_rate": round(s.get("hit_rate", 0.0), 4),
                "hbm_hit": round(s.get("hbm_hit", 0.0), 4),
                "miss": round(s.get("miss", 0.0), 4),
                "p99_ms": round(s.get("p99_ms", 0.0), 3)}

    return {
        "mode": "relay_tenants", "L": L, "tenants": 2,
        "tenant_a": {"skew": 1.1, "arrival": "poisson"},
        "tenant_b": {"skew": 1.1, "arrival": "mmpp",
                     "qps": burst_qps},
        "ref_qps": round(q_ref, 1),
        "solo": slice_rec(solo_knee, solo),
        "burst": slice_rec(burst_knee, burst),
        "hit_delta": round(burst.get("hit_rate", 0.0)
                           - solo.get("hit_rate", 0.0), 4),
        "knee_ratio": round(burst_knee.knee_qps
                            / max(solo_knee.knee_qps, 1e-9), 4),
    }
