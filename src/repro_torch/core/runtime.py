# Copied from src/repro/core/runtime.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""RelayRuntime: the canonical event-driven relay-race state machine.

The paper's contribution is ONE request lifecycle

    trigger admission -> affinity routing -> pre-infer -> HBM window
    -> expander reload -> rank

and this module is its single implementation.  Historically the repo
carried it twice (a functional composition in ``core.service`` and a
discrete-event copy in ``serving.simulator``); both are now thin
adapters over this runtime, parameterized by

  * a ``Clock`` (``WallClock`` live / ``VirtualClock`` simulated),
  * an ``Executor`` (``LiveExecutor`` real JAX compute / ``SimExecutor``
    cost-model latencies — ``repro_torch.core.executors`` registry),
  * named policies for trigger / router / expander
    (``repro_torch.core.policies`` registry).

Resource contention is explicit and mode-independent: each instance has
M model slots (NPU concurrency, FIFO) and a bounded-concurrency H2D
channel (PCIe) shared by embedding uploads and DRAM->HBM reloads.
Out-of-order arrivals are handled by the per-user single-flight queue:
if ranking wins the race against its own pre-infer signal, the ranking
job parks until psi lands in HBM (at most one reload / compute per user
per burst).

Disaggregated prefill (``ClusterConfig.prefill_hosts > 0``) carves
dedicated side-path hosts out of the topology: admitted pre-infer
signals run on a prefill engine and the produced psi is SHIPPED
cross-host to its owning rank instance over per-host NIC links
(``GRCostModel.psi_transfer_ms`` — the same unified pricing rebalance
migrations use, with concurrent transfers contending for link
bandwidth).  A rank request racing its own shipment is served as a
miss (never parked on the network); the near-miss is counted in
``stats()["shipping"]["late_miss"]``.

Latency accounting invariant (tested in tests/test_runtime_parity.py):
for every completed request,

    RankResult.latency_ms == sum(RankResult.components.values())
                          == (t_done - t_rank_arrival) * 1e3

with components ``queue`` (slot/PCIe wait), ``pre`` (parked on the
user's own in-flight psi), ``load`` (DRAM->HBM copy) and ``rank``
(ranking compute) — the paper's Fig. 11c breakdown as critical-path
attribution.

Configuration is one composable ``RelayConfig`` (``relay_config(...)``)
collapsing the former ``ServiceConfig`` / ``SimConfig`` /
``PipelineConfig`` trio; the old names remain as deprecation shims.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.serving.batching import BatchAggregator, BatchingConfig, \
    PendingRank, prefill_grid
from repro_torch.serving.metrics import SLOTracker

from .cache import HBMCacheStore, make_hbm_store
from .clock import Clock, VirtualClock, WallClock
from .coldstore import ColdStore, ColdStoreConfig
from .costmodel import GRCostModel
from .executors import Executor, get_executor
from .expander import DRAMExpander, ExpanderConfig
from .paging import DevicePagePool, PageLayout
from .policies import make_expander, make_router, make_trigger
from .topology import (ClusterTopology, Host, make_prefill_hosts,
                       stripe_hosts)
from .trigger import TriggerConfig
from .types import HitKind, RankResult, Request, UserMeta, reuse_spans


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end recommendation pipeline timing (paper Fig. 2)."""
    retrieval_ms: float = 40.0
    preprocess_ms: float = 25.0
    trigger_signal_ms: float = 3.0       # retrieval-side-path delay
    pipeline_slo_ms: float = 135.0       # end-to-end P99 SLO
    rank_budget_ms: float = 50.0         # ranking-stage budget


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Instance pool + memory tiers + policy selection."""
    n_normal: int = 0                    # 0 -> trigger.n_instances - n_special
    hbm_cache_bytes: float = 16e9        # r1 * HBM per instance
    dram_budget_bytes: float = 500e9     # expander tier (0 disables)
    m_slots: int = 5                     # NPU model slots per instance
    pcie_concurrency: int = 4            # H2D channel width per instance
    max_batch: int = 0                   # >0 -> continuous micro-batching
    batch_wait_ms: float = 2.0           # aggregator flush deadline
    page_tokens: int = 0                 # >0 -> paged HBM window (pool pages)
    # device-resident page pool (requires page_tokens > 0): page data
    # lives in a device array mutated in place — inserts and reload
    # completions scatter only the fresh pages (donated update) and
    # rank_with_pages launches pass the pool by reference, so
    # per-launch host->device traffic is 0 instead of O(pool bytes).
    # Scores are bit-identical to the host-buffer pool either way
    # (tests/test_device_pool.py); the h2d ledger in ``stats()``
    # accounts the traffic.
    device_pool: bool = False
    # beyond-prefix segment reuse (RcLLM): the side path computes and
    # caches the prefix PLUS candidate-independent interior segments
    # (``UserMeta.seg_lens``) as a span-aware paged entry; ranking then
    # reuses every cached span and computes only the truly fresh
    # tokens.  Requires page_tokens > 0 (spans live in the page pool).
    # Disabled (the default) every trace is bit-identical to the
    # prefix-only path.
    segments: bool = False
    hosts: int = 1                       # servers the pools stripe over
    # >0 -> hierarchical cold tier (MTServe-style): one host-local SSD /
    # remote-store ColdStore per rank host under the DRAM expanders.
    # DRAM LRU evictions DEMOTE to cold (asynchronously, priced on the
    # host's cold link) instead of dropping, and a trigger-admitted
    # request for a cold-resident user starts an async cold->DRAM
    # PROMOTION on the pre path so the rank stage sees a DRAM hit / a
    # cheap partial reload instead of full re-inference.  0 (default)
    # disables the tier — bit-identical to the two-tier runtime.
    cold_budget_bytes: float = 0.0
    # cold-link congestion gate: when a host's cold link backlog (time
    # until the queue drains) exceeds this, new demotions are dropped
    # and new promotions skip straight to prefill compute — disk I/O
    # that would land hopelessly late must not be queued at all, or a
    # saturated SSD turns into an unbounded promise backlog
    cold_backlog_ms: float = 50.0
    # multi-tenant serving: partition the whole HBM->DRAM->cold
    # hierarchy into per-tenant byte/page quotas (equal shares) and give
    # the trigger per-tenant admission buckets + SLO classes.  tenants=1
    # (the default) builds NONE of this — bit-identical to the
    # single-workload runtime (tests/test_runtime_parity.py).
    tenants: int = 1
    rebalance: str = "handoff"           # churn policy: handoff | none
    # >0 -> disaggregated prefill: dedicate N hosts (one pooled prefill
    # engine each) to the pre-infer side path; produced psi is SHIPPED
    # cross-host to the owning rank host at insert time
    prefill_hosts: int = 0
    # NPU slots per prefill engine (0 -> m_slots).  The prefill tier is
    # provisioned independently of the rank tier: its engines carry the
    # WHOLE pool's side-path compute, so Eq. 3a's per-instance
    # admission rate scales with the engine's true slot count
    prefill_m_slots: int = 0
    # None -> serialize cross-host transfers on per-host NIC links iff
    # prefill_hosts > 0 (True/False force it); False reproduces the
    # legacy latency-only handoff pricing bit-for-bit
    nic_serialize: Optional[bool] = None
    relay_enabled: bool = True           # False -> baseline (no side path)
    long_seq_threshold: int = 0          # 0 -> trigger's risk test routes
    trigger_policy: str = "sequence-aware"
    router_policy: str = "affinity"
    expander_policy: str = "dram"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RelayConfig:
    """The one composable config for every relay-race deployment."""
    trigger: TriggerConfig = TriggerConfig()
    pipeline: PipelineConfig = PipelineConfig()
    cluster: ClusterConfig = ClusterConfig()


def relay_config(trigger: Optional[TriggerConfig] = None,
                 pipeline: Optional[PipelineConfig] = None,
                 cluster: Optional[ClusterConfig] = None,
                 **overrides) -> RelayConfig:
    """Build a ``RelayConfig``; extra keyword args are routed to every
    sub-config that declares the field, so callers can write
    ``relay_config(trigger=..., relay_enabled=False, hbm_cache_bytes=2e9)``.
    A field declared by several sub-configs (``m_slots`` lives on both
    the trigger — Eq. 3 capacity math — and the cluster — actual NPU
    slots) is set on all of them, keeping admission consistent with the
    instances it models.
    """
    parts = {"trigger": trigger or TriggerConfig(),
             "pipeline": pipeline or PipelineConfig(),
             "cluster": cluster or ClusterConfig()}
    for key, val in overrides.items():
        hit = False
        for slot in ("cluster", "pipeline", "trigger"):
            fields = {f.name for f in dataclasses.fields(parts[slot])}
            if key in fields:
                parts[slot] = dataclasses.replace(parts[slot], **{key: val})
                hit = True
        if not hit:
            raise TypeError(f"relay_config() got unknown field {key!r}")
    return RelayConfig(**parts)


def as_relay_config(cfg) -> RelayConfig:
    """Accept a RelayConfig or any legacy shim exposing ``to_relay()``."""
    if isinstance(cfg, RelayConfig):
        return cfg
    to_relay = getattr(cfg, "to_relay", None)
    if to_relay is not None:
        return to_relay()
    raise TypeError(f"expected RelayConfig (or a legacy ServiceConfig/"
                    f"SimConfig shim), got {type(cfg).__name__}")


def _reused_tokens(entry) -> int:
    """Cached tokens a hit actually reuses: the sum of the entry's span
    lengths (true valid tokens, not the page-padded total) for a
    segmented entry, the prefix length otherwise."""
    if entry is None:
        return 0
    if entry.spans:
        return int(sum(ln for _, ln in entry.spans))
    return int(entry.prefix_len)


# ---------------------------------------------------------------------------
# per-request trace record
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Record:
    """Per-request trace: one row per completed ranking request."""
    user_id: int
    t_arrival: float
    prefix_len: int = 0
    t_rank_arrival: float = 0.0
    t_done: float = 0.0
    rank_stage_ms: float = 0.0
    pre_ms: float = 0.0        # parked on the user's own in-flight psi
    load_ms: float = 0.0       # DRAM -> HBM reload on the critical path
    rank_ms: float = 0.0       # ranking compute
    queue_ms: float = 0.0      # slot / PCIe queueing
    hit: str = "miss"
    # beyond-prefix reuse accounting: cached tokens this rank actually
    # reused (prefix + interior segments on a hit; 0 on a miss) and the
    # request's total context (prefix + incr) — summary() reduces the
    # pair to the fleet-wide reused-token fraction
    reused_tokens: int = 0
    ctx_tokens: int = 0
    tenant: int = 0

    @property
    def e2e_ms(self) -> float:
        return (self.t_done - self.t_arrival) * 1e3


# ---------------------------------------------------------------------------
# ranking instance
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class InstanceConfig:
    name: str
    hbm_cache_bytes: float = 16e9       # r1 * HBM
    dram: ExpanderConfig = dataclasses.field(default_factory=ExpanderConfig)
    special: bool = True
    m_slots: int = 5
    pcie_concurrency: int = 4
    expander_policy: str = "dram"
    page_layout: Optional[PageLayout] = None   # paged HBM window geometry
    segments: bool = False              # span-aware (beyond-prefix) entries
    device_pool: bool = False           # device-resident page pool
    role: str = "rank"                  # "rank" | "prefill" (side path only)
    # multi-tenant byte partitions (tenant id -> share); None builds the
    # untenanted stores
    tenant_quota: Optional[Dict[int, int]] = None        # HBM window
    dram_tenant_quota: Optional[Dict[int, int]] = None   # private expander


class InstanceRuntime:
    """One accelerator-backed ranking instance (normal or special).

    Holds the memory tiers (HBM window + expander), the executor, and —
    when driven by a ``RelayRuntime`` event loop — the slot/PCIe
    resource state.  The *transition kernels* below are the single
    source of truth for how psi moves through the tiers; both the
    synchronous stage API (``handle_pre_infer`` / ``handle_rank``) and
    the event loop compose them.
    """

    def __init__(self, cfg: InstanceConfig, executor: Executor,
                 expander=None):
        self.cfg = cfg
        self.name = cfg.name
        self.special = cfg.special
        self.role = cfg.role
        self.segments = cfg.segments
        self.executor = executor
        # a live executor declares the page geometry of ITS model; the
        # cluster-level layout (from the cost model) covers sim mode.
        # A prefill engine holds no window at all (psi ships out on
        # completion), so it skips the paged-pool machinery.
        layout = (None if cfg.role == "prefill" else
                  getattr(executor, "page_layout", None) or cfg.page_layout)
        # device-resident pool: opted in by the deployment config OR by
        # a live executor built with device_pool=True (the executor owns
        # the device, so its choice wins when the config is silent)
        device = bool(cfg.device_pool
                      or getattr(executor, "device_pool", False))
        self.hbm = make_hbm_store(int(cfg.hbm_cache_bytes), layout,
                                  device_pool=device and layout is not None,
                                  tenant_quota=cfg.tenant_quota)
        if (isinstance(getattr(self.hbm, "pool", None), DevicePagePool)
                and hasattr(executor, "insert_pages")):
            # route the window's page-data movement (insert / resume /
            # free) through the executor's device-pool hooks
            self.hbm.device_hooks = executor
        if hasattr(self.hbm, "materialize_on_evict"):
            # no DRAM tier -> evictees are discarded, never spilled:
            # skip the dense gather on the eviction path
            self.hbm.materialize_on_evict = cfg.dram.dram_budget_bytes > 0
        # DRAM is host memory: a multi-host runtime passes the server's
        # shared expander; standalone instances (and the hosts=1
        # deployment, where affinity makes per-instance and per-host
        # tiers equivalent) own a private one
        self.expander = expander if expander is not None \
            else make_expander(cfg.expander_policy, cfg.dram,
                               tenant_quota=cfg.dram_tenant_quota)
        # continuous micro-batching: opted into by the executor carrying
        # a BatchingConfig + rank_group (the `batched` live executor or
        # a batching-enabled SimExecutor mirror)
        bcfg = getattr(executor, "batching", None)
        self.batcher: Optional[BatchAggregator] = (
            BatchAggregator(bcfg)
            if bcfg is not None and hasattr(executor, "rank_group")
            else None)
        # batched pre-inference (the side path): admitted prefills group
        # by the 64-token prefill grid and run as ONE jitted prefill
        self.pre_batcher: Optional[BatchAggregator] = (
            BatchAggregator(bcfg, key=lambda p:
                            ("pre", prefill_grid(p.prefix_len)))
            if bcfg is not None and hasattr(executor, "pre_infer_group")
            else None)
        self.stats = {"pre_infers": 0, "ranks": 0, "hbm_hits": 0,
                      "dram_hits": 0, "cold_hits": 0, "fallbacks": 0,
                      "spills": 0, "rejected_inserts": 0}
        # event-mode resource state (owned by the driving RelayRuntime)
        self.loop: Optional["RelayRuntime"] = None
        self.free_slots = cfg.m_slots
        self.queue: deque = deque()
        self.pcie_free = cfg.pcie_concurrency
        self.pcie_queue: deque = deque()
        self.inflight_pre: set = set()
        self.user_waiters: Dict[int, List[dict]] = defaultdict(list)
        self.busy_ms = 0.0

    # --- transition kernels (shared by both drive modes) --------------------

    def complete_pre(self, meta: UserMeta, psi: Any, nbytes: int,
                     now: float) -> None:
        """psi landed: insert into the HBM sliding window; evictees that
        already served their lifecycle spill to the DRAM reuse tier.
        ``psi is None`` marks a deduped pre-infer (psi already fully
        resident): renew the entry's lifecycle in place."""
        if psi is None:
            self.hbm.touch(meta.user_id, now)
            return
        # span-aware entries: the side path cached the prefix PLUS the
        # candidate-independent interior segments — record their layout
        # so the paged window pads each span to whole pages and ranking
        # knows the true reused-token count
        spans = reuse_spans(meta) if self.segments else None
        evicted = self.hbm.insert(meta.user_id, psi, nbytes, now,
                                  prefix_len=meta.prefix_len, spans=spans,
                                  tenant=meta.tenant)
        if meta.user_id not in self.hbm:
            # oversized psi rejected by the window (surfaced via
            # hbm.stats["rejected_inserts"]): the runtime must treat
            # this user as a miss — parked rankers wake, re-probe HBM,
            # and take the full-inference fallback
            self.stats["rejected_inserts"] += 1
        for e in evicted:
            if e.consumed:  # sliding-window exit -> DRAM reuse tier
                if self.expander.spill(e):
                    self.stats["spills"] += 1

    def cache_action(self, user_id: int, now: float):
        """Pseudo-pre-infer: the cache-check step in front of ranking."""
        return self.expander.pseudo_pre_infer(user_id, self.hbm, now)

    def resolve_wait(self, user_id: int):
        """Synchronous follower resolution: the leader's op completed
        within this drive step, so re-probe HBM exactly once."""
        self.expander.finish(user_id)
        e = self.hbm.lookup(user_id)
        return ("hbm", e) if e is not None else ("miss", None)

    def apply_reload(self, user_id: int, now: float):
        """Leader finished the H2D copy: promote DRAM entry into HBM."""
        self.expander.complete_reload(user_id, self.hbm, now)
        e = self.hbm.lookup(user_id)
        return ("hbm", e) if e is not None else ("miss", None)

    def classify_rank(self, user_id: int, action: str, entry,
                      load_ms: float) -> Tuple[HitKind, Any]:
        """THE hit classification + accounting for the rank step, shared
        by the unbatched (``exec_rank``) and batched (``_batch_rank``)
        paths so their traces can never desynchronize.  Returns
        (hit kind, psi to rank with — None means full-inference
        fallback) and consumes the HBM entry on a hit."""
        self.stats["ranks"] += 1
        if action == "hbm" and entry is not None:
            self.hbm.consume(user_id)
            if entry.cold_sourced:
                # this lifecycle was revived out of the cold tier — the
                # rank it unblocks is a cold hit; the flag then clears
                # so later (warm) lifecycles classify normally
                entry.cold_sourced = False
                hit = HitKind.COLD_HIT
                self.stats["cold_hits"] += 1
            else:
                hit = HitKind.DRAM_HIT if load_ms > 0 else HitKind.HBM_HIT
                self.stats["dram_hits" if load_ms > 0 else "hbm_hits"] += 1
            # paged store: pins the entry's pages until the launch
            # releases them, so a deferred batched group can never read
            # a page the sliding window recycled under it
            return hit, self.hbm.acquire_value(entry)
        # I1: never a remote fetch — local miss falls back to full
        # inference, preserving correctness at the cost of latency.
        self.stats["fallbacks"] += 1
        return HitKind.MISS_FALLBACK, None

    def exec_rank(self, req: Request, action: str, entry, comp: Dict[str, float],
                  now: float) -> RankResult:
        """Execute ranking for the resolved cache action and classify the
        hit.  ``comp`` carries the already-accumulated critical-path
        components; ``latency_ms`` is always their sum (invariant)."""
        meta = req.user
        hit, psi = self.classify_rank(meta.user_id, action, entry,
                                      comp.get("load", 0.0))
        if psi is not None:
            scores, rank_ms = self.executor.rank_cached(meta, psi)
            self.hbm.release_value(psi)
        else:
            scores, rank_ms = self.executor.rank_full(meta)
        comp["rank"] = rank_ms
        self.busy_ms += rank_ms
        return RankResult(
            req_id=req.req_id, user_id=meta.user_id, hit=hit, scores=scores,
            latency_ms=sum(comp.values()), components=comp,
            instance=self.name)

    # --- synchronous stage API (manual drive: tests, ablations) --------------

    def handle_pre_infer(self, req: Request, now: float) -> Dict[str, float]:
        meta = req.user
        self.stats["pre_infers"] += 1
        psi, nbytes, pre_ms = self.executor.pre_infer(meta)
        self.busy_ms += pre_ms
        self.complete_pre(meta, psi, nbytes, now)
        return {"pre": pre_ms}

    def handle_rank(self, req: Request, now: float) -> RankResult:
        meta = req.user
        comp: Dict[str, float] = {"pre": 0.0, "load": 0.0, "rank": 0.0,
                                  "queue": 0.0}
        action, entry = self.cache_action(meta.user_id, now)
        single_flight_open = action in ("reload", "miss")
        if action == "wait":
            action, entry = self.resolve_wait(meta.user_id)
        if action == "reload":
            comp["load"] = self.executor.reload_ms(
                meta, tokens=entry.reload_tokens)
            action, entry = self.apply_reload(meta.user_id, now)
        result = self.exec_rank(req, action, entry, comp, now)
        if single_flight_open:
            self.expander.finish(meta.user_id)
        return result

    # --- event-mode resource machinery ---------------------------------------

    def enqueue(self, job: dict, now: float) -> None:
        job.setdefault("t_enqueue", now)
        self.queue.append(job)
        self._maybe_start(now)

    def _maybe_start(self, now: float) -> None:
        while self.free_slots > 0 and self.queue:
            job = self.queue.popleft()
            self.free_slots -= 1
            self.loop.schedule(now, "job_start", inst=self, job=job)

    def release_slot(self, now: float) -> None:
        self.free_slots += 1
        self._maybe_start(now)
        if self.loop is None or self.free_slots <= 0 or self.queue:
            return
        if self.batcher is not None and self.batcher.pending:
            # work-conserving batching: an idle slot never waits out the
            # flush deadline while ranked work sits in the aggregator
            self.loop.schedule(now, "batch_drain", inst=self)
        elif self.pre_batcher is not None and self.pre_batcher.pending:
            # same discipline for the side path (ranked work first:
            # pre-inference is off the critical path)
            self.loop.schedule(now, "pre_drain", inst=self)

    def pcie_acquire(self, now: float, cb: Callable) -> None:
        if self.pcie_free > 0:
            self.pcie_free -= 1
            cb(now)
        else:
            self.pcie_queue.append(cb)

    def pcie_release(self, now: float) -> None:
        if self.pcie_queue:
            cb = self.pcie_queue.popleft()
            cb(now)
        else:
            self.pcie_free += 1


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------


class RelayRuntime:
    """Event-driven engine for the relay-race lifecycle.

    Drive it either way:

      * ``run(arrivals)`` — enqueue a whole timed arrival stream and
        drain to completion (cluster simulation, benchmarks);
      * ``submit(meta, now)`` — inject one arrival and drain its event
        cascade synchronously, returning its ``RankResult`` (live
        serving; with a ``LiveExecutor`` the executor latencies are
        measured on real hardware and advance the logical timeline).

    Both paths run the identical handlers; only the clock and executor
    differ.  ``tests/test_runtime_parity.py`` asserts trace equality.
    """

    def __init__(self, cfg, cost: GRCostModel,
                 executor_factory: Optional[Callable[[str], Executor]] = None,
                 clock: Optional[Clock] = None):
        self.cfg = as_relay_config(cfg)
        self.cost = cost
        self.clock: Clock = clock if clock is not None else VirtualClock()
        cl = self.cfg.cluster
        # multi-tenant serving: tenants > 1 partitions every memory tier
        # into equal byte shares and layers per-tenant admission buckets
        # / SLO classes under the trigger.  The cluster knob is the
        # source of truth — sync the trigger config so one
        # ``relay_config(tenants=N)`` (or a bare ClusterConfig) is
        # enough.  tenants=1 leaves every config and store untouched.
        self.tenants = max(int(getattr(cl, "tenants", 1)), 1)
        if self.tenants != max(int(self.cfg.trigger.tenants), 1):
            self.cfg = dataclasses.replace(
                self.cfg, trigger=dataclasses.replace(
                    self.cfg.trigger, tenants=self.tenants))
        # disaggregated prefill: dedicated side-path hosts + psi shipped
        # cross-host to the owner — the shipping delay is priced into
        # the trigger's slack test (a late psi is a useless psi)
        self.disagg = cl.prefill_hosts > 0
        if cl.segments and cl.page_tokens <= 0:
            # spans live in the page pool (each span pads to whole
            # pages); a dense window has no span-addressable storage
            raise ValueError("ClusterConfig.segments requires a paged "
                             "HBM window (page_tokens > 0)")
        if cl.device_pool and cl.page_tokens <= 0:
            raise ValueError("ClusterConfig.device_pool requires a paged "
                             "HBM window (page_tokens > 0)")
        self.trigger = make_trigger(
            cl.trigger_policy, self.cfg.trigger, cost,
            ship_ms=((lambda m: cost.psi_transfer_ms(m.prefix_len,
                                                     cross_host=True))
                     if self.disagg else None))
        if cl.segments:
            # admission scores TOTAL reusable tokens (prefix + interior
            # segments), not just the prefix — the side path computes
            # and caches every span, so the slack deadline prices all
            # of them
            self.trigger.segments = True
        # risk test used for rank-stage routing; ablations may decouple
        # it from the admission trigger (e.g. admit-all + true-risk routes)
        self.route_trigger = self.trigger
        ns = self.cfg.trigger.n_special
        nn = max(cl.n_normal or (self.cfg.trigger.n_instances - ns), 1)
        self.special = [f"special-{i}" for i in range(ns)]
        self.normal = [f"normal-{i}" for i in range(nn)]
        # two-level fleet: the pools stripe over cl.hosts servers; the
        # owner map decides the owning host, the per-host ring the
        # instance.  hosts=1 degenerates to the historical flat router.
        # Prefill hosts join the topology with role="prefill": they run
        # the side path only and never own keys.
        fleet = stripe_hosts(self.special, self.normal, cl.hosts)
        fleet += make_prefill_hosts(cl.prefill_hosts)
        self.prefill = [p for h in fleet for p in h.prefill]
        self.topology = ClusterTopology(fleet)
        self.router = make_router(cl.router_policy, self.special, self.normal,
                                  seed=cl.seed, topology=self.topology)
        if executor_factory is not None:
            factory = executor_factory
        else:
            batching = (BatchingConfig(max_batch=cl.max_batch,
                                       max_wait_ms=cl.batch_wait_ms)
                        if cl.max_batch > 0 else None)
            factory = (lambda name, batching=batching:
                       get_executor("sim")(cost, batching=batching,
                                           page_tokens=cl.page_tokens,
                                           segments=cl.segments))
        self._factory = factory
        self._layout = (PageLayout.from_model_config(cost.cfg,
                                                     cl.page_tokens)
                        if cl.page_tokens > 0 else None)
        # DRAM is server memory: with several hosts, one shared expander
        # per host.  hosts=1 keeps the historical per-instance tier —
        # equivalent under affinity (each user is pinned to one
        # instance) and bit-compatible with single-process traces.
        self.host_expanders: Dict[str, DRAMExpander] = {}
        if cl.hosts > 1:
            for hname, h in self.topology.hosts.items():
                if h.role == "prefill":
                    continue      # no psi ever rests on a prefill host
                self.host_expanders[hname] = make_expander(
                    cl.expander_policy, ExpanderConfig(
                        dram_budget_bytes=cl.dram_budget_bytes,
                        max_reload_concurrency=cl.pcie_concurrency),
                    tenant_quota=self._tenant_quota_map(
                        cl.dram_budget_bytes))
        # hierarchical cold tier (MTServe-style, ROADMAP "Hierarchical
        # cache below DRAM"): one host-local SSD / remote-store
        # ColdStore per rank host.  DRAM LRU evictees demote into it
        # asynchronously (priced on the host's cold link, which
        # contends like the NIC) and a trigger-admitted visit from a
        # cold-resident user promotes the copy back up off the critical
        # path.  cold_budget_bytes=0 builds none of this — the
        # two-tier runtime stays bit-identical.
        self.cold_enabled = cl.cold_budget_bytes > 0
        self.cold_stores: Dict[str, ColdStore] = {}
        # a departed host's store: its entries re-home LAZILY (on next
        # touch), never eagerly at host_leave
        self._orphan_cold: Dict[str, ColdStore] = {}
        self.cold_links: Dict[str, Dict[str, float]] = {}
        # conservation holds at ALL event boundaries, not just after a
        # drain:  demotions == demote_landed + demote_dropped +
        # demote_inflight.  The inflight term covers the write window
        # between _demote (the copy left DRAM) and _on_demote_done (it
        # became cold-resident or was dropped) — without it a stats()
        # probe inside that window, e.g. while the DRAM source is being
        # handed off by concurrent churn, sees the family transiently
        # violated (tests/test_coldstore.py locks the interleaving).
        self.cold = {"demotions": 0, "demote_inflight": 0,
                     "demote_landed": 0,
                     "demote_dropped": 0, "demote_throttled": 0,
                     "promotions": 0, "promote_dropped": 0,
                     "promote_throttled": 0, "lazy_handoffs": 0,
                     "late_miss": 0, "ms": 0.0}
        self._promote_inflight: Dict[int, int] = {}
        self._promote_raced: set = set()
        if self.cold_enabled:
            for hname, h in self.topology.hosts.items():
                if h.role != "prefill":
                    self.cold_stores[hname] = ColdStore(
                        ColdStoreConfig(budget_bytes=cl.cold_budget_bytes),
                        tenant_quota=self._tenant_quota_map(
                            cl.cold_budget_bytes))
            # cold-aware admission: a cold-resident user's side path is
            # a promotion + reload, not a prefill — the trigger's slack
            # test prices THAT instead of the full pre-infer estimate
            self.trigger.cold_estimator = self._cold_pre_estimate
        self.instances: Dict[str, InstanceRuntime] = {}
        for host in self.topology.hosts.values():
            for name in host.instances:
                self.instances[name] = self._make_instance(
                    name, name.startswith("special"), host.name,
                    role=host.role)
        self.migration = {"entries": 0, "cross_host": 0, "intra_host": 0,
                          "ms": 0.0, "dropped": 0}
        if self.disagg:
            # Eq. 3a for the dedicated tier: each prefill engine admits
            # at q_m x ITS slot count (it carries the pool's whole side
            # path), bounded by the pool-wide cap; survival (Eqs. 1-2)
            # is still enforced per owner window by the pool bucket
            rate = self.cfg.trigger.q_m * (cl.prefill_m_slots
                                           or cl.m_slots)
            for name in self.prefill:
                self.trigger.instance_rates[name] = min(
                    rate, self.trigger.q_max)
        # cross-host psi shipping (disaggregated prefill) + the per-host
        # NIC link model both paths share.  nic_serialize=None -> links
        # contend exactly when the deployment is disaggregated; the
        # legacy latency-only pricing stays bit-identical otherwise.
        self.shipping = {"shipped": 0, "landed": 0, "deduped": 0,
                         "late_miss": 0, "dropped": 0, "forwarded": 0,
                         "coalesced": 0, "transfers": 0,
                         "bytes": 0, "ms": 0.0}
        self._ship_inflight: Dict[int, int] = {}
        self._ship_raced: set = set()
        self.nic_serialize = (self.disagg if cl.nic_serialize is None
                              else bool(cl.nic_serialize))
        self.nics: Dict[str, Dict[str, float]] = {}
        # monotone churn counters: departed names are never reused, so a
        # join can't silently overwrite a still-live instance
        self._next_special = ns
        self._next_normal = nn
        self.events: list = []
        self.records: List[Record] = []
        self._seq = itertools.count()
        self._req_ids = itertools.count()
        self.slo = SLOTracker(slo_ms=self.cfg.pipeline.pipeline_slo_ms)
        self.now = 0.0

    # --- lifecycle transitions shared with the manual stage API ---------------

    def open_lifecycle(self, meta: UserMeta, now: float
                       ) -> Tuple[Optional[Request], str]:
        """Stage 1 (retrieval side path): affinity binding + trigger
        admission.  Returns (pre-infer signal or None, bound target)."""
        signal = Request.pre_infer(next(self._req_ids), meta, now)
        target = self.router.route(signal)
        decision = self.trigger.admit(meta, target, now)
        if not decision.admitted:
            return None, target
        signal.body["target"] = target
        return signal, target

    def bind_rank(self, meta: UserMeta, now: float) -> Tuple[Request, str]:
        """Stage 3 entry: build the ranking request (user-keyed iff the
        sequence is long/at-risk and the relay is on) and route it."""
        cl = self.cfg.cluster
        if not cl.relay_enabled:
            long_seq = False          # baseline: no risk test, no key
        elif cl.long_seq_threshold:
            long_seq = meta.prefix_len >= cl.long_seq_threshold
        else:
            long_seq = self.route_trigger.assess(meta).at_risk
        req = Request.rank(next(self._req_ids), meta, now=now,
                           long_sequence=long_seq)
        return req, self.router.route(req)

    # --- event machinery ----------------------------------------------------

    def schedule(self, t: float, kind: str, **kw) -> None:
        heapq.heappush(self.events, (t, next(self._seq), kind, kw))

    def drain(self) -> None:
        while self.events:
            t, _, kind, kw = heapq.heappop(self.events)
            self.now = t
            self.clock.advance(t)
            getattr(self, f"_on_{kind}")(t, **kw)

    def run(self, arrivals: Iterable[Tuple[float, UserMeta]]
            ) -> Dict[str, float]:
        for t, meta in arrivals:
            self.schedule(t, "arrival", meta=meta)
        self.drain()
        return self.summary()

    def submit(self, meta: UserMeta, now: Optional[float] = None
               ) -> RankResult:
        """Live-mode entry: inject one arrival and run its cascade."""
        t = self.clock.now() if now is None else now
        box: List[RankResult] = []
        self.schedule(t, "arrival", meta=meta, sink=box.append)
        self.drain()
        return box[0]

    def _adopt(self, inst: InstanceRuntime) -> InstanceRuntime:
        # instances hot-swapped in by churn tests/deployments get wired
        # to this loop on first contact
        if inst.loop is not self:
            inst.loop = self
        return inst

    def _tenant_quota_map(self, budget: float) -> Optional[Dict[int, int]]:
        """Equal-share byte partition of ``budget`` over the configured
        tenants; None (build the untenanted store) for tenants=1 or a
        disabled tier."""
        if self.tenants <= 1 or budget <= 0:
            return None
        share = int(budget) // self.tenants
        return {t: share for t in range(self.tenants)}

    def _make_instance(self, name: str, special: bool, host: str,
                       role: str = "rank") -> InstanceRuntime:
        cl = self.cfg.cluster
        # a prefill engine never stores psi: no paged pool, no DRAM
        # tier — everything it produces ships to the owner immediately
        icfg = InstanceConfig(
            name=name, hbm_cache_bytes=cl.hbm_cache_bytes,
            special=special,
            m_slots=((cl.prefill_m_slots or cl.m_slots)
                     if role == "prefill" else cl.m_slots),
            pcie_concurrency=cl.pcie_concurrency,
            expander_policy=cl.expander_policy,
            page_layout=None if role == "prefill" else self._layout,
            segments=cl.segments,
            device_pool=cl.device_pool and role != "prefill", role=role,
            tenant_quota=(None if role == "prefill" else
                          self._tenant_quota_map(cl.hbm_cache_bytes)),
            dram_tenant_quota=(None if role == "prefill" else
                               self._tenant_quota_map(
                                   cl.dram_budget_bytes)))
        icfg.dram.dram_budget_bytes = (0.0 if role == "prefill"
                                       else cl.dram_budget_bytes)
        icfg.dram.max_reload_concurrency = cl.pcie_concurrency
        inst = InstanceRuntime(icfg, self._factory(name),
                               expander=self.host_expanders.get(host))
        inst.loop = self
        if self.cold_enabled and role != "prefill":
            # DRAM LRU evictees demote down to the host's cold store
            # (asynchronously, priced on the host cold link) instead of
            # dropping out of the hierarchy
            inst.expander.demote_sink = self._demote_sink(host)
        return inst

    # --- host membership churn (rebalancing, owner handoff) -------------------

    def host_join(self, n_special: int = 1, n_normal: int = 0,
                  now: Optional[float] = None) -> Host:
        """Add a server with fresh instances, bump the owner-map epoch,
        and (under ``rebalance="handoff"``) migrate every entry whose
        owner changed to its new owner — off the critical path, priced
        at the cross-host remote-fetch penalty."""
        now = self.now if now is None else now
        k = len(self.topology.hosts)
        while f"host-{k}" in self.topology.hosts:
            k += 1
        host = Host(name=f"host-{k}")
        for _ in range(n_special):
            name = f"special-{self._next_special}"
            self._next_special += 1
            host.special.append(name)
            self.special.append(name)
        for _ in range(n_normal):
            name = f"normal-{self._next_normal}"
            self._next_normal += 1
            host.normal.append(name)
            self.normal.append(name)
        if self.host_expanders:
            # per-host DRAM mode: the new server brings its own tier
            cl = self.cfg.cluster
            self.host_expanders[host.name] = make_expander(
                cl.expander_policy, ExpanderConfig(
                    dram_budget_bytes=cl.dram_budget_bytes,
                    max_reload_concurrency=cl.pcie_concurrency),
                tenant_quota=self._tenant_quota_map(cl.dram_budget_bytes))
        self.router.add_host(host)
        if self.cold_enabled:
            # the new server brings an (empty) cold store; entries the
            # join re-homes stay put until their next touch — the
            # rebalance walk below never moves cold copies eagerly
            self.cold_stores[host.name] = ColdStore(
                ColdStoreConfig(
                    budget_bytes=self.cfg.cluster.cold_budget_bytes),
                tenant_quota=self._tenant_quota_map(
                    self.cfg.cluster.cold_budget_bytes))
        for name in host.instances:
            self.instances[name] = self._make_instance(
                name, name in host.special, host.name)
        if self.cfg.cluster.rebalance == "handoff":
            self._rebalance(now)
        return host

    def host_leave(self, name: str, now: Optional[float] = None) -> None:
        """Remove a server.  Queued/parked work re-routes to the new
        owners; resident HBM/DRAM entries are HANDED OFF (never
        silently lost — ``premature_evictions`` stays 0 across churn)
        unless ``rebalance="none"`` models the naive silent-loss
        deployment."""
        now = self.now if now is None else now
        departing = list(self.topology.hosts[name].instances)
        departing_role = self.topology.hosts[name].role
        dep_expander = self.host_expanders.pop(name, None)
        self.router.remove_host(name)
        handoff = self.cfg.cluster.rebalance == "handoff"
        orphans: List[dict] = []
        for iname in departing:
            inst = self.instances.pop(iname)
            if iname in self.special:
                self.special.remove(iname)
            if iname in self.normal:
                self.normal.remove(iname)
            if iname in self.prefill:
                self.prefill.remove(iname)
            while inst.queue:
                orphans.append(inst.queue.popleft())
            for uid, jobs in list(inst.user_waiters.items()):
                for job in jobs:
                    # parked work keeps its accounting clock: the park
                    # interval until re-dispatch is still 'pre' time
                    job["rec"].pre_ms += (now - job.pop("t_park")) * 1e3
                    orphans.append(job)
                inst.user_waiters.pop(uid, None)
            for batcher in (inst.batcher, inst.pre_batcher):
                if batcher is None:
                    continue
                group = batcher.take_oldest()
                while group is not None:
                    orphans.append({"kind": "batch" if batcher is
                                    inst.batcher else "pre_batch",
                                    "group": group})
                    group = batcher.take_oldest()
            if handoff:
                for uid in list(inst.hbm.entries):
                    self._handoff_hbm(inst, uid, now)
                if dep_expander is None:       # per-instance DRAM tiers
                    for uid in list(inst.expander.entries):
                        self._handoff_dram(inst.expander, name, uid, now)
        if handoff and dep_expander is not None:
            for uid in list(dep_expander.entries):
                self._handoff_dram(dep_expander, name, uid, now)
        # Cold entries hand off LAZILY: unlike the HBM/DRAM walks above,
        # a departing host's cold store is parked as an orphan (still
        # addressable as a remote store) and each entry re-homes on its
        # NEXT TOUCH — eager eviction of a multi-TB SSD namespace at
        # host_leave would serialize the whole tier through one NIC.
        # Under rebalance="none" the namespace is simply lost with the
        # host (the naive deployment the handoff policy exists to beat).
        dep_cold = self.cold_stores.pop(name, None)
        if dep_cold is not None and dep_cold.entries and handoff:
            self._orphan_cold[name] = dep_cold
        self.topology.mark_departed(name)
        # re-dispatch orphaned work at its new owner (group members fall
        # back to plain jobs: their dead-host psi snapshots are gone, so
        # the new instance re-resolves the cache action from scratch)
        flat: List[dict] = []
        for job in orphans:
            if job["kind"] == "batch":
                flat.extend(w.payload for w in job["group"])
            elif job["kind"] == "pre_batch":
                flat.extend({"kind": "pre", "meta": w.meta}
                            for w in job["group"])
            else:
                flat.append(job)
        for job in flat:
            if job["kind"] == "pre":
                # side-path work follows its pool: a departing prefill
                # engine re-routes to a surviving one (rank owner only
                # when the prefill pool emptied); rank-host orphans stay
                # with the new owner, whose handed-off tiers serve them
                uid = job["meta"].user_id
                target = (self._pre_target(uid)
                          if departing_role == "prefill"
                          else self.router.route_key(uid))
            else:
                target = self.router.route(job["req"])
            inst = self._adopt(self.instances[target])
            if job["kind"] == "pre":
                inst.inflight_pre.add(job["meta"].user_id)
            inst.enqueue(job, now)

    # --- per-host NIC links (shipments and migrations contend) ----------------

    def _nic(self, host: Optional[str]) -> Dict[str, float]:
        """Link state of one host's NIC (lazily created; a departed
        host's link survives so in-flight drains stay accounted).
        Full duplex: egress (tx) and ingress (rx) serialize
        independently, like real NIC queues."""
        key = host or "<fabric>"
        nic = self.nics.get(key)
        if nic is None:
            nic = {"tx_free": 0.0, "rx_free": 0.0, "transfers": 0,
                   "bytes": 0, "busy_ms": 0.0, "wait_ms": 0.0}
            self.nics[key] = nic
        return nic

    def _link_transfer(self, now: float, src_host: Optional[str],
                       dst_host: Optional[str], nbytes: int,
                       prefix_len: int) -> Tuple[float, float]:
        """One cross-host psi transfer over the shipping fabric.
        Returns (arrival time, wall ms).  With ``nic_serialize`` the
        transfer occupies the sender's egress and then the receiver's
        ingress for its serialization window
        (``GRCostModel.link_occupancy_ms``) — a cut-through tandem, so
        concurrent shipments and rebalance migrations CONTEND for
        per-host link bandwidth; otherwise it degenerates to the
        legacy latency-only ``psi_transfer_ms`` pricing."""
        if not self.nic_serialize:
            ms = self.cost.psi_transfer_ms(prefix_len, cross_host=True)
            return now + ms / 1e3, ms
        nbytes = int(nbytes) or self.cost.kv_bytes(prefix_len)
        occ = self.cost.link_occupancy_ms(nbytes) / 1e3
        start_tx = now
        if src_host is not None:
            tx = self._nic(src_host)
            start_tx = max(now, tx["tx_free"])
            tx["tx_free"] = start_tx + occ
            tx["transfers"] += 1
            tx["bytes"] += nbytes
            tx["busy_ms"] += occ * 1e3
            tx["wait_ms"] += (start_tx - now) * 1e3
        start_rx = start_tx
        if dst_host is not None:
            rx = self._nic(dst_host)
            start_rx = max(start_tx, rx["rx_free"])
            rx["rx_free"] = start_rx + occ
            rx["transfers"] += 1
            rx["bytes"] += nbytes
            rx["busy_ms"] += occ * 1e3
            rx["wait_ms"] += (start_rx - start_tx) * 1e3
        arrival = start_rx + occ + self.cost.hw.net_rtt_ms / 1e3
        return arrival, (arrival - now) * 1e3

    def _handoff_hbm(self, inst: InstanceRuntime, uid: int,
                     now: float) -> None:
        """Migrate one HBM entry to the instance that now owns its key.
        The transfer rides the background shipping fabric (the unified
        ``psi_transfer_ms`` pricing + NIC link contention when the
        owner changed hosts, local H2D otherwise) and lands as a
        scheduled ``handoff_done`` event — a rank arriving inside the
        migration window falls back (I1: correctness first, speedup
        lost), it never fetches remotely on the critical path."""
        target = self.router.route_key(uid)
        if target == inst.name:
            return
        e = inst.hbm.extract(uid)
        if e is None:
            return
        cross = (self.topology.host_of(target)
                 != self.topology.host_of(inst.name))
        if e.value is None and e.page_table is None and e.dram_backed:
            # partially resident paged head: worthless off-instance; the
            # full DRAM copy migrates separately and covers this user
            self.migration["dropped"] += 1
            return
        arrival, ms = self._transfer(now, self.topology.host_of(inst.name),
                                     target, e.nbytes, e.prefix_len or 1,
                                     cross)
        self.migration["entries"] += 1
        self.migration["cross_host" if cross else "intra_host"] += 1
        self.migration["ms"] += ms
        self.schedule(arrival, "handoff_done", target=target,
                      entry=e, tier="hbm")

    def _transfer(self, now: float, src_host: Optional[str], target: str,
                  nbytes: int, prefix_len: int, cross: bool
                  ) -> Tuple[float, float]:
        """Price + schedule one background psi move (migration or
        shipment leg): cross-host moves ride the NIC fabric, intra-host
        moves re-cross the local H2D path."""
        if cross:
            return self._link_transfer(now, src_host,
                                       self.topology.host_of(target),
                                       nbytes, prefix_len)
        ms = self.cost.psi_transfer_ms(prefix_len, cross_host=False)
        return now + ms / 1e3, ms

    def _handoff_dram(self, expander, from_host: Optional[str], uid: int,
                      now: float) -> None:
        """Migrate one DRAM entry to the expander tier of the host that
        now owns its key."""
        target = self.router.route_key(uid)
        tgt_host = self.topology.host_of(target)
        tgt_exp = self.host_expanders.get(tgt_host)
        if tgt_exp is None:
            tgt_exp = self.instances[target].expander
        if tgt_exp is expander:
            return
        d = expander.take(uid)
        if d is None:
            return
        cross = from_host is None or from_host != tgt_host
        arrival, ms = self._transfer(now, from_host, target, d.nbytes,
                                     d.prefix_len or 1, cross)
        self.migration["entries"] += 1
        self.migration["cross_host" if cross else "intra_host"] += 1
        self.migration["ms"] += ms
        self.schedule(arrival, "handoff_done", target=target,
                      entry=d, tier="dram")

    def _rebalance(self, now: float) -> None:
        """After a membership change: walk every resident entry and hand
        off the ones whose owner moved.  Rendezvous hashing guarantees
        only keys won by the joining host (or orphaned by a leave)
        migrate — nothing else reshuffles."""
        for inst in list(self.instances.values()):
            for uid in list(inst.hbm.entries):
                self._handoff_hbm(inst, uid, now)
        seen: set = set()
        for hname, exp in list(self.host_expanders.items()):
            if id(exp) in seen:
                continue
            seen.add(id(exp))
            for uid in list(exp.entries):
                self._handoff_dram(exp, hname, uid, now)
        if not self.host_expanders:
            for inst in list(self.instances.values()):
                for uid in list(inst.expander.entries):
                    if self.router.route_key(uid) != inst.name:
                        self._handoff_dram(inst.expander, None, uid, now)

    def _on_handoff_done(self, t: float, target: str, entry, tier: str
                         ) -> None:
        inst = self.instances.get(target)
        if inst is None:
            # the destination churned away mid-flight: re-route once
            try:
                uid = entry.user_id
                retarget = self.router.route_key(uid)
            except Exception:
                self.migration["dropped"] += 1
                return
            if retarget == target or retarget not in self.instances:
                self.migration["dropped"] += 1
                return
            self.schedule(t, "handoff_done", target=retarget, entry=entry,
                          tier=tier)
            return
        if tier == "dram":
            if not inst.expander.spill(dataclasses.replace(entry)):
                self.migration["dropped"] += 1
            return
        evicted = inst.hbm.insert(entry.user_id, entry.value, entry.nbytes,
                                  t, prefix_len=entry.prefix_len,
                                  spans=entry.spans, tenant=entry.tenant)
        landed = inst.hbm.entries.get(entry.user_id)
        if landed is not None:
            # the entry continues its lifecycle: a consumed psi must not
            # later count as a premature eviction at its new home
            landed.consumed = entry.consumed
        else:
            # the target window rejected the insert (oversized psi or a
            # zombie-pinched pool): the migration did NOT land
            self.migration["dropped"] += 1
        for e in evicted:
            if e.consumed and inst.expander.spill(e):
                inst.stats["spills"] += 1
        self._wake_waiters(t, inst, entry.user_id)

    # --- cold tier (host SSD / remote psi store under DRAM) -------------------

    def _cold_link(self, host: str) -> Dict[str, float]:
        """Link state of one host's cold store (SSD namespace / remote-
        store share).  Unlike the full-duplex NIC this is ONE queue —
        reads and writes serialize against each other — and a departed
        host's link survives so lazy-handoff reads stay accounted."""
        link = self.cold_links.get(host)
        if link is None:
            link = {"free": 0.0, "transfers": 0, "bytes": 0,
                    "busy_ms": 0.0, "wait_ms": 0.0}
            self.cold_links[host] = link
        return link

    def _cold_transfer(self, now: float, host: str, nbytes: int,
                       prefix_len: int) -> Tuple[float, float]:
        """One cold-tier I/O (demotion write or promotion read) on
        ``host``'s cold link.  The uncontended cost is exactly the
        unified entry point ``GRCostModel.psi_transfer_ms(prefix_len,
        link="cold")``; this is its serialized form — the occupancy
        window charges the link so concurrent demotions and promotions
        contend for disk bandwidth, the same relationship
        ``_link_transfer`` has to the NIC pricing.  Returns (arrival
        time, wall ms)."""
        nbytes = int(nbytes) or self.cost.kv_bytes(prefix_len)
        occ = self.cost.link_occupancy_ms(nbytes, link="cold") / 1e3
        link = self._cold_link(host)
        start = max(now, link["free"])
        link["free"] = start + occ
        link["transfers"] += 1
        link["bytes"] += nbytes
        link["busy_ms"] += occ * 1e3
        link["wait_ms"] += (start - now) * 1e3
        arrival = start + occ + self.cost.hw.cold_rtt_ms / 1e3
        return arrival, (arrival - now) * 1e3

    def _demote_sink(self, host: str):
        """The hook wired into a host's DRAM expander: LRU evictees are
        offered here; True means the copy entered the demotion pipeline
        (counted by the expander as a demotion, not an eviction)."""
        def sink(entry, host=host):
            return self._demote(self.now, host, entry)
        return sink

    def _cold_backlog_ok(self, now: float, host: str) -> bool:
        """Congestion gate: False when the host's cold link is backed
        up past ``cold_backlog_ms`` of queued I/O."""
        link = self._cold_link(host)
        return (link["free"] - now) * 1e3 \
            <= self.cfg.cluster.cold_backlog_ms

    def _promote_viable(self, now: float, meta: UserMeta, src_host: str,
                        dst_host: Optional[str], *,
                        burned_ms: float = 0.0) -> bool:
        """Deadline test for a candidate promotion: queued link backlog
        + cold read (+ NIC leg for a foreign/departed source) + the
        DRAM->HBM reload must fit inside what is LEFT of the
        pre-signal -> rank window (``burned_ms`` is the queue time the
        pre job already spent), otherwise the psi lands behind its own
        rank request and the revival was pure wasted I/O."""
        link = self._cold_link(src_host)
        est = max(0.0, link["free"] - now) * 1e3 \
            + self.cost.psi_transfer_ms(meta.prefix_len, link="cold") \
            + self.cost.dram_load_ms(meta.prefix_len)
        if src_host != dst_host:
            est += self.cost.psi_transfer_ms(meta.prefix_len,
                                             cross_host=True)
        pp = self.cfg.pipeline
        return est <= (pp.retrieval_ms + pp.preprocess_ms
                       - pp.trigger_signal_ms - burned_ms)

    def _demote(self, now: float, host: str, entry) -> bool:
        store = self.cold_stores.get(host)
        if store is None or entry.value is None \
                or entry.nbytes > store.cfg.budget_bytes:
            return False
        if not self._cold_backlog_ok(now, host):
            self.cold["demote_throttled"] += 1
            return False
        arrival, ms = self._cold_transfer(now, host, entry.nbytes,
                                          entry.prefix_len or 1)
        self.cold["demotions"] += 1
        self.cold["demote_inflight"] += 1
        self.cold["ms"] += ms
        self.schedule(arrival, "demote_done", host=host, entry=entry)
        return True

    def _on_demote_done(self, t: float, host: str, entry) -> None:
        # the write completed: the copy becomes cold-resident NOW (a
        # promotion probe during the in-flight window missed — the disk
        # copy was not readable yet).  Resolve the inflight term FIRST
        # so the landed/dropped increment below keeps the conservation
        # family exact at this very event boundary.
        self.cold["demote_inflight"] -= 1
        store = self.cold_stores.get(host) or self._orphan_cold.get(host)
        if store is None or not store.insert(entry):
            self.cold["demote_dropped"] += 1
            return
        self.cold["demote_landed"] += 1
        # single cold ownership: a fresher demotion supersedes any stale
        # copy the same user left on another host's store (e.g. before
        # a rebalance moved their key)
        for s in list(self.cold_stores.values()) \
                + list(self._orphan_cold.values()):
            if s is not store:
                s.drop(entry.user_id)

    def _cold_find(self, uid: int, prefer: Optional[str] = None):
        """Locate a user's cold copy without accounting: the preferred
        (destination) host's store first, then the other live stores,
        then orphaned stores of departed hosts.  Returns (src_host,
        store) or None."""
        if prefer is not None:
            store = self.cold_stores.get(prefer)
            if store is not None and store.peek(uid) is not None:
                return prefer, store
        for host, store in self.cold_stores.items():
            if host != prefer and store.peek(uid) is not None:
                return host, store
        for host, store in self._orphan_cold.items():
            if store.peek(uid) is not None:
                return host, store
        return None

    def _cold_pre_estimate(self, meta: UserMeta) -> Optional[float]:
        """Admission-time side-path estimate for a cold-resident user:
        a promotion read + DRAM->HBM reload replaces the full prefill
        compute (plus a NIC leg when the copy sits on a foreign or
        departed host).  None when the user has no cold copy."""
        found = self._cold_find(meta.user_id)
        if found is None:
            return None
        ms = (self.cost.psi_transfer_ms(meta.prefix_len, link="cold")
              + self.cost.dram_load_ms(meta.prefix_len))
        src_host, _ = found
        owner_host = self.topology.host_of(self.router.route_key(
            meta.user_id))
        if src_host != owner_host:
            ms += self.cost.psi_transfer_ms(meta.prefix_len,
                                            cross_host=True)
        return ms

    def _promote_open(self, uid: int) -> None:
        self._promote_inflight[uid] = self._promote_inflight.get(uid, 0) + 1

    def _promote_close(self, uid: int) -> None:
        n = self._promote_inflight.get(uid, 0)
        if n <= 1:
            self._promote_inflight.pop(uid, None)
        else:
            self._promote_inflight[uid] = n - 1

    def _start_promotion(self, t: float, inst: InstanceRuntime,
                         meta: UserMeta, src_host: str, store) -> None:
        """Async cold->DRAM promotion on the pre path (the relay's side
        lane): a cold read on the source host's cold link, plus one NIC
        fabric leg when the copy lives on a foreign or departed host —
        the LAZY handoff moment: the entry re-homes now, on touch, not
        eagerly at host_leave."""
        uid = meta.user_id
        dst_host = self.topology.host_of(inst.name)
        if src_host == dst_host:
            entry = store.take(uid)          # store counts a promotion
            arrival, ms = self._cold_transfer(t, src_host, entry.nbytes,
                                              entry.prefix_len or 1)
        else:
            entry = store.extract(uid)       # extract != evict: handoff
            read_t, ms1 = self._cold_transfer(t, src_host, entry.nbytes,
                                              entry.prefix_len or 1)
            arrival, ms2 = self._link_transfer(read_t, src_host, dst_host,
                                               entry.nbytes,
                                               entry.prefix_len or 1)
            ms = ms1 + ms2
            self.cold["lazy_handoffs"] += 1
            if not store.entries:
                # last lazily handed-off entry left a departed host's
                # namespace: release the orphan
                self._orphan_cold.pop(src_host, None)
        self.cold["promotions"] += 1
        self.cold["ms"] += ms
        self._promote_open(uid)
        self.schedule(arrival, "promote_done", inst=inst, meta=meta,
                      entry=entry)
        # the disk read needs no NPU: give the model slot back for the
        # whole cold-link wait (the pre lifecycle stays open via
        # inflight_pre) — holding it would let a congested cold link
        # starve the instance of compute slots
        inst.release_slot(t)

    def _on_promote_done(self, t: float, inst: InstanceRuntime,
                         meta: UserMeta, entry) -> None:
        uid = meta.user_id
        self._promote_close(uid)
        entry.cold_sourced = True
        if self.instances.get(inst.name) is not inst:
            # the destination churned away mid-promotion: the copy
            # re-homes to the current owner's DRAM tier instead
            inst.inflight_pre.discard(uid)
            try:
                target = self.router.route_key(uid)
            except Exception:
                self.cold["promote_dropped"] += 1
                return
            self.schedule(t, "handoff_done", target=target, entry=entry,
                          tier="dram")
            return
        if not inst.expander.spill(entry):
            # the DRAM tier rejected the promoted copy: the revival is
            # lost and the pre lifecycle closes as a miss (the model
            # slot went back when the promotion started)
            self.cold["promote_dropped"] += 1
            inst.inflight_pre.discard(uid)
            self._wake_waiters(t, inst, uid)
            return
        # continue exactly like the DRAM pre-reload path: stream the
        # copy into the HBM window over PCIe so the rank stage sees a
        # resident (cold-sourced) psi
        d = inst.expander.entries[uid]
        d.reload_tokens = inst.hbm.missing_tokens(uid, d.prefix_len)
        ms = inst.executor.reload_ms(meta, tokens=d.reload_tokens)

        def start(t2, inst=inst, meta=meta, ms=ms):
            self.schedule(t2 + ms / 1e3, "pre_reload_done", inst=inst,
                          meta=meta, ms=ms, slotless=True)
        inst.pcie_acquire(t, start)

    # --- pipeline stage handlers ----------------------------------------------

    def _on_arrival(self, t: float, meta: UserMeta, sink=None) -> None:
        rec = Record(user_id=meta.user_id, t_arrival=t,
                     prefix_len=meta.prefix_len,
                     ctx_tokens=meta.prefix_len + meta.incr_len,
                     tenant=getattr(meta, "tenant", 0))
        pp = self.cfg.pipeline
        if self.cfg.cluster.relay_enabled:
            signal, target = self.open_lifecycle(meta, t)
            if signal is not None:
                self.schedule(t + pp.trigger_signal_ms / 1e3, "pre_signal",
                              meta=meta, target=target)
        t_rank = t + (pp.retrieval_ms + pp.preprocess_ms) / 1e3
        self.schedule(t_rank, "rank_arrival", meta=meta, rec=rec, sink=sink)

    def _on_pre_signal(self, t: float, meta: UserMeta, target: str) -> None:
        uid = meta.user_id
        if self.disagg and target in self.instances \
                and self.instances[target].role == "prefill":
            # psi already host-local at the OWNER (resident window,
            # DRAM copy, or a cold-tier copy a promotion can revive)?
            # Then the colocated side path — lifecycle touch, local
            # reload, or cold promotion — handles it without burning
            # prefill compute or a NIC shipment
            owner = self.router.route_key(uid)
            oinst = self.instances.get(owner)
            if oinst is not None and (
                    oinst.hbm.resident(uid) is not None
                    or uid in oinst.expander.entries
                    or (self.cold_enabled
                        and self._cold_find(uid) is not None)):
                target = owner
        if target not in self.instances:
            # the bound instance churned away between binding and the
            # signal landing: rebind to the current owner
            target = self._pre_target(uid)
        inst = self._adopt(self.instances[target])
        inst.inflight_pre.add(uid)
        if inst.role == "prefill":
            # the owner-side rank path must see the side path as "in
            # flight over the network", not "in flight locally": a rank
            # racing the shipment is served as a miss, never parked
            self._ship_open(uid)
        # t_signal rides along so deadline-aware side-path decisions
        # (the cold promotion's viability test) can subtract the queue
        # time already burned from the pre-signal -> rank window
        inst.enqueue({"kind": "pre", "meta": meta, "t_signal": t}, t)

    def _pre_target(self, uid: int) -> str:
        """Current side-path placement for a user: a prefill engine in
        the disaggregated deployment, the owning rank instance
        otherwise."""
        if self.disagg:
            target = self.router.route_pre(uid)
            if target in self.instances:
                return target
        return self.router.route_key(uid)

    def _ship_open(self, uid: int) -> None:
        self._ship_inflight[uid] = self._ship_inflight.get(uid, 0) + 1

    def _ship_close(self, uid: int) -> None:
        n = self._ship_inflight.get(uid, 0) - 1
        if n <= 0:
            self._ship_inflight.pop(uid, None)
        else:
            self._ship_inflight[uid] = n

    # --- membership-churn events (mid-stream join/leave in simulation) --------

    def _on_host_join(self, t: float, n_special: int = 1,
                      n_normal: int = 0) -> None:
        self.host_join(n_special=n_special, n_normal=n_normal, now=t)

    def _on_host_leave(self, t: float, name: str) -> None:
        self.host_leave(name, now=t)

    def _on_rank_arrival(self, t: float, meta: UserMeta, rec: Record,
                         sink=None) -> None:
        req, target = self.bind_rank(meta, t)
        rec.t_rank_arrival = t
        inst = self._adopt(self.instances[target])
        inst.enqueue({"kind": "rank", "req": req, "rec": rec, "sink": sink}, t)

    # --- job execution ----------------------------------------------------------

    def _on_job_start(self, t: float, inst: InstanceRuntime, job: dict
                      ) -> None:
        if job["kind"] == "pre":
            self._start_pre(t, inst, job["meta"],
                            t_signal=job.get("t_signal"))
            return
        if job["kind"] == "batch":
            self._start_batch(t, inst, job["group"])
            return
        if job["kind"] == "pre_batch":
            self._start_pre_batch(t, inst, job["group"])
            return
        req: Request = job["req"]
        rec: Record = job["rec"]
        meta = req.user
        uid = meta.user_id
        rec.queue_ms += (t - job.pop("t_enqueue")) * 1e3
        if not self.cfg.cluster.relay_enabled:
            self._finish_rank(t, inst, job, "miss", None)
            return
        action, entry = inst.cache_action(uid, t)
        if action == "hbm":
            self._finish_rank(t, inst, job, "hbm", entry)
        elif action == "wait":
            # psi is in flight for this user (a reload led by an
            # earlier rank job — 'wait' implies an open leader): drop
            # our follower increment and park on the single-flight
            # queue; the slot goes back and the leader's completion
            # wakes us into an HBM hit
            inst.expander.finish(uid)
            self._park(t, inst, uid, job)
        elif action == "reload":
            # page-granular: a partially resident entry resumes — only
            # the missing pages ride the H2D channel
            ms = inst.executor.reload_ms(meta, tokens=entry.reload_tokens)

            def start_reload(t2, inst=inst, job=job, ms=ms, t_req=t):
                # PCIe channel wait shows up as queueing, not load
                job["rec"].queue_ms += (t2 - t_req) * 1e3
                self.schedule(t2 + ms / 1e3, "reload_done", inst=inst,
                              job=job, ms=ms)

            inst.pcie_acquire(t, start_reload)
        else:  # miss
            if self._promote_inflight.get(uid):
                # promotion-vs-deadline race: the psi is still on the
                # disk path (cold read / NIC leg) — serve the miss NOW,
                # mirroring the shipping late_miss semantics, rather
                # than stall the rank on an I/O-bound arrival; the
                # promotion still lands for future reuse
                self.cold["late_miss"] += 1
                self._promote_raced.add(uid)
                inst.expander.finish(uid)
                self._finish_rank(t, inst, job, "miss", None)
            elif uid in inst.inflight_pre:
                # out-of-order: rank arrived before its pre-infer finished
                inst.expander.finish(uid)
                self._park(t, inst, uid, job)
            else:
                if self._ship_inflight.get(uid):
                    # shipping-vs-deadline race: the psi is still on the
                    # wire (or in prefill compute) — serve the miss NOW
                    # rather than stall on an NIC-contended arrival; the
                    # shipment still lands for future reuse (no
                    # double-rank: nobody is parked)
                    self.shipping["late_miss"] += 1
                    self._ship_raced.add(uid)
                inst.expander.finish(uid)
                self._finish_rank(t, inst, job, "miss", None)

    def _start_pre(self, t: float, inst: InstanceRuntime, meta: UserMeta,
                   t_signal: Optional[float] = None) -> None:
        uid = meta.user_id
        if inst.role == "prefill":
            owner = self.instances.get(self.router.route_key(uid))
            if owner is not None and owner.hbm.resident(uid) is not None:
                # dedup across the split: psi became resident at the
                # owner while this signal queued — renew its lifecycle
                # there, ship nothing (the refresh costs no NIC bytes)
                inst.inflight_pre.discard(uid)
                self._ship_close(uid)
                self.shipping["deduped"] += 1
                self._adopt(owner).hbm.touch(uid, t)
                inst.release_slot(t)
                return
        # dedup: psi already local (HBM or DRAM) -> pseudo step only.
        # Higher DRAM hit rates therefore reduce pre-inference work and
        # NPU utilization (paper Fig. 14b).
        if inst.hbm.resident(uid) is not None:
            # psi=None marks the in-place lifecycle renewal (touch)
            self.schedule(t, "pre_done", inst=inst, meta=meta,
                          psi=None, nbytes=0)
            return
        d = inst.expander.entries.get(uid)
        if d is not None:
            d.reload_tokens = inst.hbm.missing_tokens(uid, d.prefix_len)
            ms = inst.executor.reload_ms(meta, tokens=d.reload_tokens)

            def start(t2, inst=inst, meta=meta, ms=ms):
                self.schedule(t2 + ms / 1e3, "pre_reload_done",
                              inst=inst, meta=meta, ms=ms)

            inst.pcie_acquire(t, start)
            return
        if self.cold_enabled and inst.role != "prefill":
            dst_host = self.topology.host_of(inst.name)
            found = self._cold_find(uid, prefer=dst_host)
            # serving-path probe accounting (the admission estimator
            # peeks without counting): hit on the store that holds the
            # copy, miss against the destination host's store
            if found is not None:
                found[1].stats["hits"] += 1
            elif dst_host in self.cold_stores:
                self.cold_stores[dst_host].stats["misses"] += 1
            if found is not None:
                burned = 0.0 if t_signal is None else (t - t_signal) * 1e3
                if self._promote_viable(t, meta, found[0],
                                        self.topology.host_of(inst.name),
                                        burned_ms=burned):
                    # cold-resident: an async promotion (cold read ->
                    # DRAM -> PCIe reload) replaces the prefill
                    # compute; the rank either finds the revived psi
                    # or races it and is served as a miss (never
                    # stalls on the disk)
                    self._start_promotion(t, inst, meta, *found)
                    return
                # the read would land after the rank (link backlog +
                # transfer + reload exceed the pre-signal->rank
                # window): a doomed promotion converts a would-be
                # compute hit into a full miss — recompute instead
                self.cold["promote_throttled"] += 1
        if inst.pre_batcher is not None:
            self._batch_pre(t, inst, meta)
            return
        inst.stats["pre_infers"] += 1
        psi, nbytes, ms = inst.executor.pre_infer(meta)
        inst.busy_ms += ms
        self.schedule(t + ms / 1e3, "pre_done", inst=inst, meta=meta,
                      psi=psi, nbytes=nbytes)

    # --- batched pre-inference (the side path, grouped by prefill grid) -------

    def _batch_pre(self, t: float, inst: InstanceRuntime, meta: UserMeta
                   ) -> None:
        """Admitted prefill under batching: park in the pre aggregator
        (keyed by the 64-token prefill grid) and follow the same
        work-conserving discipline as the rank path — an uncontended
        slot launches the group of one immediately, so spaced traces
        stay bit-identical to the unbatched side path; under contention
        admitted users share ONE jitted prefill per grid, lifting the
        admission ceiling the per-user side path imposed."""
        work = PendingRank(user_id=meta.user_id, psi=None,
                           prefix_len=meta.prefix_len, meta=meta)
        group = inst.pre_batcher.add(work, t)
        if group is None and not inst.queue:
            group = inst.pre_batcher.take_for(work)
        if group is not None:
            self._start_pre_batch(t, inst, group)
            self._ensure_pre_flush(t, inst)
        else:
            inst.release_slot(t)
            if inst.pre_batcher.depth_for(work) == 1:
                self.schedule(t + inst.pre_batcher.cfg.max_wait_ms / 1e3,
                              "pre_flush", inst=inst)

    def _ensure_pre_flush(self, t: float, inst: InstanceRuntime) -> None:
        if inst.pre_batcher.pending:
            self.schedule(t + inst.pre_batcher.cfg.max_wait_ms / 1e3,
                          "pre_flush", inst=inst)

    def _on_pre_flush(self, t: float, inst: InstanceRuntime) -> None:
        for group in inst.pre_batcher.expired(t):
            inst.enqueue({"kind": "pre_batch", "group": group}, t)
        self._ensure_pre_flush(t, inst)

    def _on_pre_drain(self, t: float, inst: InstanceRuntime) -> None:
        while inst.free_slots > 0 and not inst.queue:
            group = inst.pre_batcher.take_oldest()
            if group is None:
                return
            inst.enqueue({"kind": "pre_batch", "group": group}, t)

    def _start_pre_batch(self, t: float, inst: InstanceRuntime,
                         group: List[PendingRank]) -> None:
        metas = [w.meta for w in group]
        inst.stats["pre_infers"] += len(metas)
        outs, ms = inst.executor.pre_infer_group(metas)
        inst.busy_ms += ms
        self.schedule(t + ms / 1e3, "pre_group_done", inst=inst,
                      group=group, outs=outs)

    def _on_pre_group_done(self, t: float, inst: InstanceRuntime,
                           group: List[PendingRank], outs) -> None:
        outbound: Dict[Optional[str], list] = {}
        for w, (psi, nbytes) in zip(group, outs):
            inst.inflight_pre.discard(w.user_id)
            if inst.role == "prefill":
                # batched disaggregated prefill: members of the one
                # jitted launch bound for the same rank host coalesce
                # into one NIC transfer (per-destination, below)
                if psi is not None:
                    target = self.router.route_key(w.user_id)
                    outbound.setdefault(
                        self.topology.host_of(target), []).append(
                        (target, w.meta, psi, nbytes))
                else:
                    self._ship_close(w.user_id)
                continue
            if self._ship_inflight.get(w.user_id):
                self._ship_close(w.user_id)
            target = self._misplaced(inst, w.user_id)
            if target is not None:
                self._forward_pre(t, inst, w.meta, psi, nbytes, target)
            else:
                inst.complete_pre(w.meta, psi, nbytes, t)
                self._settle_raced(inst, w.user_id)
        for dst_host, members in outbound.items():
            self._ship_group(t, inst, dst_host, members)
        inst.release_slot(t)
        for w in group:
            self._wake_waiters(t, inst, w.user_id)

    def _park(self, t: float, inst: InstanceRuntime, uid: int, job: dict
              ) -> None:
        job["t_park"] = t
        job.pop("t_enqueue", None)
        inst.user_waiters[uid].append(job)
        inst.release_slot(t)

    def _finish_rank(self, t: float, inst: InstanceRuntime, job: dict,
                     action: str, entry) -> None:
        if inst.batcher is not None:
            self._batch_rank(t, inst, job, action, entry)
            return
        rec: Record = job["rec"]
        comp = {"pre": rec.pre_ms, "load": rec.load_ms, "rank": 0.0,
                "queue": rec.queue_ms}
        result = inst.exec_rank(job["req"], action, entry, comp, t)
        rec.rank_ms = comp["rank"]
        rec.hit = result.hit.value
        if result.hit != HitKind.MISS_FALLBACK:
            rec.reused_tokens = _reused_tokens(entry)
        self.schedule(t + comp["rank"] / 1e3, "rank_done", inst=inst,
                      job=job, result=result)

    # --- continuous micro-batching (batched executor) -------------------------

    def _batch_rank(self, t: float, inst: InstanceRuntime, job: dict,
                    action: str, entry) -> None:
        """Rank step under batching: classify the hit, snapshot psi, park
        the request in the aggregator and give the model slot back — a
        group launch will re-acquire ONE slot for the whole batch."""
        req: Request = job["req"]
        rec: Record = job["rec"]
        meta = req.user
        hit, psi = inst.classify_rank(meta.user_id, action, entry,
                                      rec.load_ms)
        job["hit"] = hit
        if hit != HitKind.MISS_FALLBACK:
            rec.reused_tokens = _reused_tokens(entry)
        work = PendingRank(user_id=meta.user_id, psi=psi,
                           prefix_len=meta.prefix_len, meta=meta,
                           payload=job)
        group = inst.batcher.add(work, t)
        if group is None and not inst.queue:
            # continuous batching: we still hold a model slot and nothing
            # else is waiting for it — delaying for co-batchable arrivals
            # buys nothing, so launch immediately with whatever has
            # accumulated.  Batches deeper than one therefore only form
            # while slots are contended, which is exactly when they pay.
            group = inst.batcher.take_for(work)
        if group is not None:
            # reuse the slot this rank job already holds for the launch
            self._start_batch(t, inst, group)
            self._ensure_flush(t, inst)
        else:
            # contended: give the slot to the queued work and park; the
            # flush deadline bounds how long the group can accumulate
            inst.release_slot(t)
            if inst.batcher.depth_for(work) == 1:
                # one timer per queue head is enough: expired() keys off
                # the oldest member, and every take re-arms via
                # _ensure_flush for whatever it leaves behind
                self.schedule(t + inst.batcher.cfg.max_wait_ms / 1e3,
                              "batch_flush", inst=inst)

    def _launch_batch(self, t: float, inst: InstanceRuntime,
                      group: List[PendingRank]) -> None:
        inst.enqueue({"kind": "batch", "group": group}, t)

    def _ensure_flush(self, t: float, inst: InstanceRuntime) -> None:
        """Re-arm the flush deadline for whatever is still parked (e.g.
        overflow a full-batch take left queued without its own timer)."""
        if inst.batcher.pending:
            self.schedule(t + inst.batcher.cfg.max_wait_ms / 1e3,
                          "batch_flush", inst=inst)

    def _on_batch_flush(self, t: float, inst: InstanceRuntime) -> None:
        for group in inst.batcher.expired(t):
            self._launch_batch(t, inst, group)
        self._ensure_flush(t, inst)

    def _on_batch_drain(self, t: float, inst: InstanceRuntime) -> None:
        # drain as many pending groups as there are idle slots, so no
        # group waits out the flush deadline beside an unused slot
        while inst.free_slots > 0 and not inst.queue:
            group = inst.batcher.take_oldest()
            if group is None:
                return
            self._launch_batch(t, inst, group)

    def _start_batch(self, t: float, inst: InstanceRuntime,
                     group: List[PendingRank]) -> None:
        """Slot acquired: execute the group as one launch.  Aggregator +
        slot wait is per-request queueing; the group wall time is every
        member's rank component (they all ride the same call), keeping
        latency_ms == sum(components) == rank-stage wall time."""
        for w in group:
            w.payload["rec"].queue_ms += (t - w.enqueued_at) * 1e3
        scores, group_ms = inst.executor.rank_group(group)
        for w in group:
            inst.hbm.release_value(w.psi)  # unpin pages held since classify
        inst.busy_ms += group_ms
        results = []
        for w, s in zip(group, scores):
            job = w.payload
            rec: Record = job["rec"]
            comp = {"pre": rec.pre_ms, "load": rec.load_ms,
                    "rank": group_ms, "queue": rec.queue_ms}
            rec.rank_ms = group_ms
            rec.hit = job["hit"].value
            results.append(RankResult(
                req_id=job["req"].req_id, user_id=w.user_id,
                hit=job["hit"], scores=s, latency_ms=sum(comp.values()),
                components=comp, instance=inst.name))
        self.schedule(t + group_ms / 1e3, "batch_done", inst=inst,
                      group=group, results=results)

    def _on_batch_done(self, t: float, inst: InstanceRuntime,
                       group: List[PendingRank],
                       results: List[RankResult]) -> None:
        for w, result in zip(group, results):
            rec: Record = w.payload["rec"]
            e = inst.hbm.consume(result.user_id)
            if e is not None and inst.expander.cfg.dram_budget_bytes > 0:
                if inst.expander.spill(dataclasses.replace(e)):
                    inst.stats["spills"] += 1
                    e.dram_backed = True   # eligible for partial eviction
            rec.t_done = t
            rec.rank_stage_ms = rec.queue_ms + rec.load_ms + rec.rank_ms
            self.records.append(rec)
            self.slo.observe(now=t, e2e_ms=rec.e2e_ms, hit=rec.hit,
                             components=result.components)
            sink = w.payload.get("sink")
            if sink is not None:
                sink(result)
        inst.release_slot(t)

    # --- completions -------------------------------------------------------------

    def _misplaced(self, inst: InstanceRuntime, uid: int) -> Optional[str]:
        """After membership churn, an in-flight producer can complete on
        an instance that no longer owns its user (the pre-infer raced
        the rebalance).  Returns the owning target when the completion
        is misplaced; None on the hot path (no churn has ever happened
        or the placement is still correct)."""
        if self.cfg.cluster.rebalance != "handoff":
            return None
        if self.topology.epoch == 0 and self.instances.get(inst.name) is inst:
            return None
        target = self.router.route_key(uid)
        return None if target == inst.name else target

    def _forward_pre(self, t: float, inst: InstanceRuntime, meta: UserMeta,
                     psi: Any, nbytes: int, target: str) -> None:
        """Hand a freshly computed psi to the user's new owner instead
        of inserting it at the stale producer (prevents double
        ownership during the rebalance window)."""
        cross = (self.topology.host_of(target)
                 != self.topology.host_of(inst.name))
        arrival, ms = self._transfer(t, self.topology.host_of(inst.name),
                                     target, int(nbytes),
                                     meta.prefix_len or 1, cross)
        self.migration["entries"] += 1
        self.migration["cross_host" if cross else "intra_host"] += 1
        self.migration["ms"] += ms
        from .cache import CacheEntry
        spans = (reuse_spans(meta) if self.cfg.cluster.segments else None)
        entry = CacheEntry(meta.user_id, psi, int(nbytes), t,
                           prefix_len=meta.prefix_len, spans=spans,
                           tenant=meta.tenant)
        self.schedule(arrival, "handoff_done", target=target,
                      entry=entry, tier="hbm")

    def _on_pre_done(self, t: float, inst: InstanceRuntime, meta: UserMeta,
                     psi: Any, nbytes: int) -> None:
        uid = meta.user_id
        inst.inflight_pre.discard(uid)
        if inst.role == "prefill":
            # disaggregated side path: the engine never keeps psi — it
            # ships to the owning rank host (the shipment keeps the
            # user's in-flight marker open until it lands or drops)
            if psi is not None:
                self._ship_psi(t, inst, meta, psi, nbytes)
            else:
                self._ship_close(uid)
            inst.release_slot(t)
            return
        if self._ship_inflight.get(uid):
            # churn re-dispatched a disagg pre job onto a rank host:
            # psi completes locally, nothing is in the network anymore
            self._ship_close(uid)
        target = self._misplaced(inst, uid) if psi is not None else None
        if target is not None:
            self._forward_pre(t, inst, meta, psi, nbytes, target)
        else:
            inst.complete_pre(meta, psi, nbytes, t)
            self._settle_raced(inst, uid)
        inst.release_slot(t)
        self._wake_waiters(t, inst, uid)

    # --- cross-host psi shipping (disaggregated prefill) ----------------------

    def _ship_psi(self, t: float, inst: InstanceRuntime, meta: UserMeta,
                  psi: Any, nbytes: int) -> None:
        """Relay a freshly prefilled psi from its producing prefill
        engine to the user's owning rank instance: one cross-host hop
        on the NIC fabric (contending with concurrent shipments and
        rebalance migrations), landing as a ``ship_done`` insert."""
        target = self.router.route_key(meta.user_id)
        nb = int(nbytes) or self.cost.kv_bytes(meta.prefix_len or 1)
        arrival, ms = self._link_transfer(
            t, self.topology.host_of(inst.name),
            self.topology.host_of(target), nb, meta.prefix_len or 1)
        self.shipping["shipped"] += 1
        self.shipping["transfers"] += 1
        self.shipping["bytes"] += nb
        self.shipping["ms"] += ms
        self.schedule(arrival, "ship_done", target=target, meta=meta,
                      psi=psi, nbytes=nbytes)

    def _ship_group(self, t: float, inst: InstanceRuntime,
                    dst_host: Optional[str], members: list) -> None:
        """Coalesced shipment: every member of one batched prefill
        launch bound for the same rank host rides ONE NIC transfer —
        summed payload bytes, one serialization window, one RTT —
        through the same ``psi_transfer_ms``/``_link_transfer`` pricing
        as a solo shipment.  Each member still lands as its own
        ``ship_done`` (its target instance may differ within the
        host), so the late-miss race and churn forwarding are
        untouched."""
        total = 0
        len_sum = 0
        for _, meta, _, nbytes in members:
            total += int(nbytes) or self.cost.kv_bytes(meta.prefix_len or 1)
            len_sum += meta.prefix_len or 1
        arrival, ms = self._link_transfer(
            t, self.topology.host_of(inst.name), dst_host, total, len_sum)
        self.shipping["shipped"] += len(members)
        self.shipping["transfers"] += 1
        self.shipping["coalesced"] += len(members) - 1
        self.shipping["bytes"] += total
        self.shipping["ms"] += ms
        for target, meta, psi, nbytes in members:
            self.schedule(arrival, "ship_done", target=target, meta=meta,
                          psi=psi, nbytes=nbytes)

    def _on_ship_done(self, t: float, target: str, meta: UserMeta,
                      psi: Any, nbytes: int, hops: int = 0) -> None:
        uid = meta.user_id
        inst = self.instances.get(target)
        try:
            owner = self.router.route_key(uid)
        except Exception:
            owner = None
        if inst is None or (owner is not None and owner != target):
            # ownership churned while the psi was on the wire: forward
            # one more fabric hop to the new owner (bounded — continued
            # churn eventually drops the copy, which is safe: the rank
            # path falls back, it never double-owns)
            if hops >= 2 or owner is None or owner not in self.instances:
                self._ship_close(uid)
                self._settle_raced(None, uid)
                self.shipping["dropped"] += 1
                return
            nb = int(nbytes) or self.cost.kv_bytes(meta.prefix_len or 1)
            arrival, ms = self._link_transfer(
                t, self.topology.host_of(target),
                self.topology.host_of(owner), nb, meta.prefix_len or 1)
            self.shipping["forwarded"] += 1
            self.shipping["transfers"] += 1
            self.shipping["ms"] += ms
            self.schedule(arrival, "ship_done", target=owner, meta=meta,
                          psi=psi, nbytes=nbytes, hops=hops + 1)
            return
        self._ship_close(uid)
        self.shipping["landed"] += 1
        inst = self._adopt(inst)
        inst.complete_pre(meta, psi, nbytes, t)
        self._settle_raced(inst, uid)
        self._wake_waiters(t, inst, uid)

    def _settle_raced(self, inst: Optional[InstanceRuntime],
                      uid: int) -> None:
        """The rank this psi was produced for already fell back: the
        lifecycle is over, so a landed copy is consumed-on-arrival — it
        serves FUTURE requests (and exits the window through the spill
        path, never as a premature eviction)."""
        if uid in self._ship_raced and not self._ship_inflight.get(uid):
            self._ship_raced.discard(uid)
            if inst is not None:
                inst.hbm.consume(uid)
        if uid in self._promote_raced \
                and not self._promote_inflight.get(uid):
            # same contract for a promotion the rank outran: the
            # revived copy arrives consumed (and un-marks itself — the
            # lifecycle it was promoted for already missed)
            self._promote_raced.discard(uid)
            if inst is not None:
                e = inst.hbm.consume(uid)
                if e is not None:
                    e.cold_sourced = False

    def _on_pre_reload_done(self, t: float, inst: InstanceRuntime,
                            meta: UserMeta, ms: float,
                            slotless: bool = False) -> None:
        uid = meta.user_id
        inst.inflight_pre.discard(uid)
        if self._ship_inflight.get(uid):
            # churn re-routed a disagg pre job onto its rank owner and
            # a local DRAM reload satisfied it: nothing is on the wire
            # anymore, so the shipment marker must close here too
            self._ship_close(uid)
        inst.pcie_release(t)
        inst.expander.complete_reload(uid, inst.hbm, t)
        self._settle_raced(inst, uid)
        if self._misplaced(inst, uid) is not None:
            # the reload raced a rebalance: the promoted psi belongs to
            # the new owner now — hand it off instead of keeping it
            self._handoff_hbm(inst, uid, t)
        if not slotless:
            # a cold promotion released its model slot at the disk
            # read; only the slot-holding DRAM pre-reload returns one
            inst.release_slot(t)
        self._wake_waiters(t, inst, uid)

    def _on_reload_done(self, t: float, inst: InstanceRuntime, job: dict,
                        ms: float) -> None:
        req: Request = job["req"]
        uid = req.user.user_id
        job["rec"].load_ms = ms
        inst.pcie_release(t)
        action, entry = inst.apply_reload(uid, t)
        inst.expander.finish(uid)
        self._finish_rank(t, inst, job, action, entry)
        self._wake_waiters(t, inst, uid)

    def _wake_waiters(self, t: float, inst: InstanceRuntime, uid: int
                      ) -> None:
        for job in inst.user_waiters.pop(uid, []):
            # the parked interval is the pre-infer contribution to this
            # request's critical path (Fig. 11c attribution)
            job["rec"].pre_ms += (t - job.pop("t_park")) * 1e3
            inst.enqueue(job, t)

    def _on_rank_done(self, t: float, inst: InstanceRuntime, job: dict,
                      result: RankResult) -> None:
        rec: Record = job["rec"]
        e = inst.hbm.consume(result.user_id)
        if e is not None and inst.expander.cfg.dram_budget_bytes > 0:
            # proactive spill copy for short-term cross-request reuse
            if inst.expander.spill(dataclasses.replace(e)):
                inst.stats["spills"] += 1
                e.dram_backed = True       # eligible for partial eviction
        rec.t_done = t
        rec.rank_stage_ms = rec.queue_ms + rec.load_ms + rec.rank_ms
        self.records.append(rec)
        self.slo.observe(now=t, e2e_ms=rec.e2e_ms, hit=rec.hit,
                         components=result.components)
        sink = job.get("sink")
        if sink is not None:
            sink(result)
        inst.release_slot(t)

    # --- metrics -------------------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {"n": 0}
        pp = self.cfg.pipeline
        e2e = np.array([r.e2e_ms for r in self.records])
        rank_stage = np.array([r.rank_stage_ms for r in self.records])
        ok = e2e <= pp.pipeline_slo_ms
        dur = (max(r.t_done for r in self.records)
               - min(r.t_arrival for r in self.records))
        hits = defaultdict(int)
        for r in self.records:
            hits[r.hit] += 1
        n = len(self.records)
        out = {
            "n": n,
            "p50_ms": float(np.percentile(e2e, 50)),
            "p99_ms": float(np.percentile(e2e, 99)),
            "rank_p99_ms": float(np.percentile(rank_stage, 99)),
            "success_rate": float(ok.mean()),
            "throughput_qps": n / max(dur, 1e-9),
            "goodput_qps": int(ok.sum()) / max(dur, 1e-9),
            "hbm_hit": hits[HitKind.HBM_HIT.value] / n,
            "dram_hit": hits[HitKind.DRAM_HIT.value] / n,
            "cold_hit": hits[HitKind.COLD_HIT.value] / n,
            "miss": hits[HitKind.MISS_FALLBACK.value] / n,
            "pre_p99_ms": float(np.percentile(
                [r.pre_ms for r in self.records], 99)),
            "load_p99_ms": float(np.percentile(
                [r.load_ms for r in self.records], 99)),
            "rank_ms_p99": float(np.percentile(
                [r.rank_ms for r in self.records], 99)),
            "special_util": self._util(self.special, dur),
            "normal_util": self._util(self.normal, dur),
            # beyond-prefix reuse: fraction of all context tokens served
            # from cache (prefix-only paths reuse at most the prefix;
            # segment reuse adds the interior spans on every hit)
            "reused_frac": (sum(r.reused_tokens for r in self.records)
                            / max(sum(r.ctx_tokens for r in self.records),
                                  1)),
        }
        if self.prefill:
            # disaggregated deployments report the side-path hosts too:
            # the tentpole claim is that prefill compute leaves the
            # ranking hosts' slots (special_util drops, prefill_util
            # carries the pre-infer load)
            out["prefill_util"] = self._util(self.prefill, dur)
        return out

    def tenant_summary(self) -> Dict[int, Dict[str, float]]:
        """Per-tenant slice of ``summary()``: latency percentiles and
        hit-kind mix over each tenant's own records.  The isolation
        bench compares a tenant's slice across runs (solo vs a
        co-tenant bursting) — its hit rate and knee must not move."""
        by: Dict[int, List[Record]] = defaultdict(list)
        for r in self.records:
            by[r.tenant].append(r)
        out: Dict[int, Dict[str, float]] = {}
        pp = self.cfg.pipeline
        for t, recs in sorted(by.items()):
            n = len(recs)
            e2e = np.array([r.e2e_ms for r in recs])
            ok = e2e <= pp.pipeline_slo_ms
            hits = defaultdict(int)
            for r in recs:
                hits[r.hit] += 1
            miss = hits[HitKind.MISS_FALLBACK.value] / n
            out[t] = {
                "n": n,
                "p50_ms": float(np.percentile(e2e, 50)),
                "p99_ms": float(np.percentile(e2e, 99)),
                "success_rate": float(ok.mean()),
                "hbm_hit": hits[HitKind.HBM_HIT.value] / n,
                "dram_hit": hits[HitKind.DRAM_HIT.value] / n,
                "cold_hit": hits[HitKind.COLD_HIT.value] / n,
                "miss": miss,
                "hit_rate": 1.0 - miss,
            }
        return out

    def _util(self, names, dur) -> float:
        if not names or dur <= 0:
            return 0.0
        busy = sum(self.instances[n].busy_ms for n in names
                   if n in self.instances) / 1e3
        # per-instance slot counts: the prefill tier may be provisioned
        # with a different concurrency than the rank tier
        slots = sum(self.instances[n].cfg.m_slots if n in self.instances
                    else self.cfg.cluster.m_slots for n in names)
        return busy / (dur * slots) if slots else 0.0

    def stats(self) -> Dict[str, Dict]:
        agg = {"trigger": dict(self.trigger.stats),
               "router": dict(self.router.stats),
               "topology": {
                   "epoch": self.topology.epoch,
                   "converged": self.topology.converged(),
                   "hosts": {n: {"special": list(h.special),
                                 "normal": list(h.normal),
                                 "prefill": list(h.prefill),
                                 "role": h.role}
                             for n, h in self.topology.hosts.items()}},
               "migration": dict(self.migration),
               "shipping": {**self.shipping,
                            "inflight": sum(self._ship_inflight.values())},
               "nic": {h: dict(n) for h, n in self.nics.items()},
               # cold tier: the runtime ledger plus every store's
               # unified counter family (inserts/live/evictions/
               # handoffs/promotions); departed hosts' orphaned
               # namespaces report until their last entry re-homes
               "cold": {**self.cold,
                        "inflight": sum(self._promote_inflight.values()),
                        "stores": {
                            **{h: {**s.stats, "live": s.live_count}
                               for h, s in self.cold_stores.items()},
                            **{f"{h} (departed)": {**s.stats,
                                                   "live": s.live_count}
                               for h, s in self._orphan_cold.items()}}},
               "cold_links": {h: dict(l)
                              for h, l in self.cold_links.items()},
               "slo": self.slo.summary(now=self.now)}
        # host->device traffic ledger, summed over the paged windows:
        # scatter-on-insert bytes vs whole-pool launch re-ships.  On
        # the device-pool path ``launch_reships`` MUST read 0 and
        # ``bytes_scattered`` equals the freshly inserted page bytes
        # (the acceptance surface of the device-resident pool).
        h2d = {"bytes_scattered": 0, "pages_scattered": 0, "scatters": 0,
               "launch_reships": 0, "reshipped_bytes": 0}
        device_resident = False
        inst = {}
        for name, i in self.instances.items():
            # every tier reports the same counter core (inserts / live /
            # evictions / handoffs + tier extras) so this renders as
            # one coherent hierarchy table
            inst[name] = {**i.stats,
                          "hbm": {**i.hbm.stats,
                                  "live": i.hbm.live_count},
                          "dram": {**i.expander.stats,
                                   "live": len(i.expander.entries)}}
            if i.batcher is not None:
                inst[name]["batch"] = dict(i.batcher.stats)
            pool = getattr(i.hbm, "pool", None)
            if pool is not None:
                inst[name]["hbm"]["h2d"] = dict(pool.h2d)
                for k in h2d:
                    h2d[k] += pool.h2d[k]
                device_resident |= isinstance(pool, DevicePagePool)
        agg["h2d"] = {**h2d, "device_resident": device_resident}
        agg["instances"] = inst
        if self.tenants > 1:
            agg["tenants"] = self._tenant_rollup()
        return agg

    def _tenant_rollup(self) -> Dict[str, Dict]:
        """Fleet-wide per-tenant ledgers: the trigger's admission
        counters plus every tier's tenant_stats summed over stores.
        ``cross_tenant_evictions`` totals the partition-invariant
        violations across ALL tiers — 0 by construction."""
        def merge(dst: Dict[int, Dict[str, int]], src) -> None:
            if not src:
                return
            for t, d in src.items():
                row = dst.setdefault(int(t), {})
                for k, v in d.items():
                    row[k] = row.get(k, 0) + v

        hbm: Dict[int, Dict[str, int]] = {}
        dram: Dict[int, Dict[str, int]] = {}
        cold: Dict[int, Dict[str, int]] = {}
        cross = 0
        seen: set = set()
        for i in self.instances.values():
            merge(hbm, getattr(i.hbm, "tenant_stats", None))
            cross += i.hbm.stats.get("cross_tenant_evictions", 0)
            if id(i.expander) in seen:
                continue          # hosts share one expander tier
            seen.add(id(i.expander))
            merge(dram, getattr(i.expander, "tenant_stats", None))
            cross += i.expander.stats.get("cross_tenant_evictions", 0)
        for s in list(self.cold_stores.values()) \
                + list(self._orphan_cold.values()):
            merge(cold, getattr(s, "tenant_stats", None))
            cross += s.stats.get("cross_tenant_evictions", 0)
        admission = {int(t): dict(d) for t, d in
                     getattr(self.trigger, "tenant_stats", {}).items()}
        return {"admission": admission, "hbm": hbm, "dram": dram,
                "cold": cold, "cross_tenant_evictions": cross}
