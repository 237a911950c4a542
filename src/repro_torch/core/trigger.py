# Copied from src/repro/core/trigger.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Sequence-aware trigger: selective admission of at-risk requests
(paper §3.2, Eqs. 1-3).

The trigger runs beside retrieval, inspects only lightweight behaviour
metadata, and admits a request for prefix pre-inference iff

  (risk)  full inline ranking would violate the ranking-stage P99 budget,
  (Eq. 2) the live caches it creates survive T_life under the HBM budget:
              L * kv_p99 <= r1 * HBM,   L = Q_admit * T_life       (Eq. 1)
  (Eq. 3) per-instance compute is not overloaded:
              Q_admit <= Q_m * M, and pool-wide
              Q_max   <= (Q_m * M) * (r2 * N).

Rates are enforced with token buckets (one per special instance plus a
pool-wide bucket), so admission is load-aware at millisecond granularity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from .costmodel import GRCostModel
from .types import UserMeta


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    hbm_bytes: float = 32e9          # HBM per special instance
    r1: float = 0.5                  # HBM fraction reserved for live caches
    t_life_s: float = 0.3            # request lifecycle window
    q_m: float = 30.0                # pre-infer QPS per model slot
    m_slots: int = 5                 # concurrent model slots per instance
    r2: float = 0.1                  # fraction of instances that are special
    n_instances: int = 100           # total ranking instances
    rank_p99_budget_ms: float = 50.0 # ranking-stage P99 budget
    kv_p99_len: int = 4096           # P99 prefix length among admitted users
    concurrency_factor: float = 2.0  # queueing amplification at high QPS
    # beyond-paper (EXPERIMENTS.md §Perf): only admit when pre-inference
    # is estimated to finish inside the retrieval+preprocess slack, so
    # ranking never parks on its own pre-infer signal. 0 disables.
    # Under disaggregated prefill the runtime installs a shipping-cost
    # estimator (``SequenceAwareTrigger.ship_estimator``) and the slack
    # test prices the cross-host psi shipment too — a psi that arrives
    # after its rank request is useless, so it must not be admitted.
    slack_budget_ms: float = 0.0
    # multi-tenant serving: number of tenants sharing the fleet.  1
    # (default) builds no tenant machinery at all — bit-identical to
    # the single-tenant trigger.  With tenants > 1, admission layers a
    # per-tenant token bucket between the instance and pool buckets so
    # one tenant's surge cannot consume another tenant's admission
    # budget.
    tenants: int = 1
    # per-tenant share of the pool admission rate, indexed by tenant id
    # (tuple to stay hashable).  Empty -> equal shares.
    tenant_shares: tuple = ()
    # per-tenant SLO classes: (rank_p99_budget_ms, slack_budget_ms)
    # per tenant id.  A tenant beyond the tuple (or an empty tuple)
    # falls back to the global rank_p99_budget_ms / slack_budget_ms.
    tenant_slo: tuple = ()

    @property
    def n_special(self) -> int:
        return max(1, int(round(self.r2 * self.n_instances)))

    def tenant_rank_budget_ms(self, tenant: int) -> float:
        if 0 <= tenant < len(self.tenant_slo):
            return float(self.tenant_slo[tenant][0])
        return self.rank_p99_budget_ms

    def tenant_slack_ms(self, tenant: int) -> float:
        if 0 <= tenant < len(self.tenant_slo):
            return float(self.tenant_slo[tenant][1])
        return self.slack_budget_ms

    def tenant_share(self, tenant: int) -> float:
        if 0 <= tenant < len(self.tenant_shares):
            return float(self.tenant_shares[tenant])
        return 1.0 / max(self.tenants, 1)


class TokenBucket:
    """Leaky token bucket with a LAZY epoch.

    The bucket's clock starts at the first ``try_take`` — not at
    construction.  The old ``t_last = 0.0`` initialisation credited the
    whole wall-clock epoch (``now - 0``) as idle refill on the first
    take: harmless while the initial allowance equals ``burst`` (the
    cap masks it), but any bucket configured to start below ``burst``
    would be silently topped up to a full free burst the moment it was
    first consulted with a real timestamp.  Refill is also clamped to
    non-negative elapsed time so an out-of-order timestamp can never
    drain (or mint) tokens.
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 tokens: Optional[float] = None):
        self.rate = float(rate)
        self.burst = burst if burst is not None else max(rate, 1.0)
        # initial allowance: a full bucket by default (deliberate — the
        # first T_life window may admit a burst), never above burst
        self.tokens = (self.burst if tokens is None
                       else min(float(tokens), self.burst))
        self.t_last: Optional[float] = None   # epoch set on first take

    def try_take(self, now: float) -> bool:
        if self.t_last is not None:
            elapsed = max(0.0, now - self.t_last)
            self.tokens = min(self.burst,
                              self.tokens + elapsed * self.rate)
            self.t_last = max(self.t_last, now)
        else:
            self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclasses.dataclass
class Decision:
    admitted: bool
    at_risk: bool
    est_full_ms: float
    reason: str


class SequenceAwareTrigger:
    def __init__(self, cfg: TriggerConfig, cost: GRCostModel):
        self.cfg = cfg
        self.cost = cost
        self.kv_p99_bytes = cost.kv_bytes(cfg.kv_p99_len)
        # Eq. 2 -> cap on live caches, Eq. 1 -> admitted rate cap
        self.live_cap = cfg.r1 * cfg.hbm_bytes / self.kv_p99_bytes
        rate_survive = self.live_cap / cfg.t_life_s
        rate_compute = cfg.q_m * cfg.m_slots                      # Eq. 3a
        self.q_admit = min(rate_survive, rate_compute)
        self.q_max = rate_compute * cfg.n_special                 # Eq. 3b
        self._instance_buckets: Dict[str, TokenBucket] = {}
        # per-instance admission-rate overrides (Eq. 3a with the
        # instance's TRUE compute): a dedicated prefill engine serves
        # the whole pool's side path, so its rate is q_m x its own
        # slot count, not the rank-instance default — the runtime
        # fills this for the prefill tier
        self.instance_rates: Dict[str, float] = {}
        self._pool_bucket = TokenBucket(self.q_max)
        # multi-tenant admission: one bucket per tenant, layered
        # between the instance and pool buckets (empty dict — and zero
        # overhead on the admit path — when tenants == 1)
        self._tenant_buckets: Dict[int, TokenBucket] = {}
        self.tenant_stats: Dict[int, Dict[str, int]] = {}
        if cfg.tenants > 1:
            for t in range(cfg.tenants):
                self._tenant_buckets[t] = TokenBucket(
                    self.q_max * cfg.tenant_share(t))
                self.tenant_stats[t] = {
                    "assessed": 0, "at_risk": 0, "admitted": 0,
                    "rate_limited": 0, "rate_limited_tenant": 0,
                    "rate_limited_instance": 0, "rate_limited_pool": 0,
                    "slack_rejected": 0}
        # disaggregated prefill: the runtime installs an estimate of the
        # cross-host psi shipping delay (ms as a function of UserMeta);
        # the slack test then admits only when pre-infer AND the
        # shipment both fit the retrieval/preprocess window.
        self.ship_estimator = None
        # hierarchical cold tier: the runtime installs a probe that
        # returns the promotion-path estimate (cold read + reload, ms)
        # for a cold-RESIDENT user, or None.  For those users the side
        # path is a revival, not a prefill — the slack test prices the
        # (much cheaper) disk path instead of the compute estimate, so
        # long-prefix tail users that prefill would price out of the
        # deadline stay admittable once their psi exists cold.
        self.cold_estimator = None
        # segment-aware value scoring (beyond-prefix reuse): when the
        # runtime flips this on, admission scores the TOTAL reusable
        # tokens (prefix + candidate-independent interior segments),
        # not just the prefix — the side path computes and caches every
        # reusable span, so the slack deadline must price all of them
        self.segments = False
        self.stats = {"assessed": 0, "at_risk": 0, "admitted": 0,
                      "rate_limited": 0, "rate_limited_pool": 0,
                      "rate_limited_instance": 0,
                      "rate_limited_tenant": 0, "slack_rejected": 0,
                      "cold_scored": 0, "reusable_tokens_admitted": 0}

    def _tbump(self, tenant: int, key: str) -> None:
        ts = self.tenant_stats.get(tenant)
        if ts is not None:
            ts[key] += 1

    # --- side-path risk test (metadata only) -------------------------------
    def assess(self, meta: UserMeta) -> Decision:
        self.stats["assessed"] += 1
        tenant = getattr(meta, "tenant", 0)
        self._tbump(tenant, "assessed")
        dim_scale = (meta.dim / self.cost.cfg.d_model) ** 2 \
            if meta.dim else 1.0
        est = self.cost.full_rank_ms(
            meta.prefix_len, meta.incr_len, meta.n_items,
            dim_scale=dim_scale) * self.cfg.concurrency_factor
        # per-tenant SLO class: each tenant is at-risk against ITS OWN
        # ranking budget (identical to the global budget when no
        # tenant_slo classes are configured)
        at_risk = est > self.cfg.tenant_rank_budget_ms(tenant)
        if at_risk:
            self.stats["at_risk"] += 1
            self._tbump(tenant, "at_risk")
        return Decision(False, at_risk, est,
                        "at-risk" if at_risk else "safe")

    # --- segment-aware value score (beyond-prefix reuse) ---------------------
    def reusable_tokens(self, meta: UserMeta) -> int:
        """Total cacheable tokens for this request: the prefix, plus —
        under segment reuse — every candidate-independent interior
        segment.  This is the value score admission prices: more
        reusable tokens means more rank-time saved per admitted psi."""
        toks = int(meta.prefix_len)
        if self.segments:
            toks += int(sum(getattr(meta, "seg_lens", ()) or ()))
        return toks

    # --- admission ----------------------------------------------------------
    def admit(self, meta: UserMeta, instance: str, now: float) -> Decision:
        d = self.assess(meta)
        tenant = getattr(meta, "tenant", 0)
        if not d.at_risk:
            return Decision(False, False, d.est_full_ms, "safe")
        reuse = self.reusable_tokens(meta)
        slack_ms = self.cfg.tenant_slack_ms(tenant)
        if slack_ms:
            cold_est = (self.cold_estimator(meta)
                        if self.cold_estimator is not None else None)
            if cold_est is not None:
                # cold-resident: the side path promotes the existing
                # psi (disk read + reload) instead of prefilling — no
                # compute, no shipping hop
                self.stats["cold_scored"] += 1
                pre_est = cold_est
            else:
                pre_est = self.cost.pre_infer_ms(reuse)
                if self.ship_estimator is not None:
                    # psi must land at the OWNER before ranking arrives:
                    # the shipping hop is on the relay's deadline path
                    pre_est += self.ship_estimator(meta)
            if pre_est > slack_ms:
                self.stats["slack_rejected"] += 1
                self._tbump(tenant, "slack_rejected")
                return Decision(False, True, d.est_full_ms,
                                "insufficient-slack")
        bucket = self._instance_buckets.get(instance)
        if bucket is None:
            bucket = TokenBucket(self.instance_rates.get(instance,
                                                         self.q_admit))
            self._instance_buckets[instance] = bucket
        # instance bucket first: an instance-rate rejection must not
        # burn a pool token (pool-wide under-admission under
        # per-instance contention); each later take refunds the earlier
        # tokens on ITS rejection for the same reason
        if not bucket.try_take(now):
            self.stats["rate_limited"] += 1
            self.stats["rate_limited_instance"] += 1
            self._tbump(tenant, "rate_limited")
            self._tbump(tenant, "rate_limited_instance")
            return Decision(False, True, d.est_full_ms,
                            "instance-rate-limited")
        # tenant bucket second (multi-tenant only): a tenant that has
        # exhausted its share is rejected HERE, before it can burn a
        # pool token another tenant is entitled to — the isolation
        # guarantee admission contributes
        tbucket = self._tenant_buckets.get(tenant)
        if tbucket is not None and not tbucket.try_take(now):
            bucket.tokens = min(bucket.burst, bucket.tokens + 1.0)
            self.stats["rate_limited"] += 1
            self.stats["rate_limited_tenant"] += 1
            self._tbump(tenant, "rate_limited")
            self._tbump(tenant, "rate_limited_tenant")
            return Decision(False, True, d.est_full_ms,
                            "tenant-rate-limited")
        if not self._pool_bucket.try_take(now):
            bucket.tokens = min(bucket.burst, bucket.tokens + 1.0)
            if tbucket is not None:
                tbucket.tokens = min(tbucket.burst, tbucket.tokens + 1.0)
            self.stats["rate_limited"] += 1
            self.stats["rate_limited_pool"] += 1
            self._tbump(tenant, "rate_limited")
            self._tbump(tenant, "rate_limited_pool")
            return Decision(False, True, d.est_full_ms, "pool-rate-limited")
        self.stats["admitted"] += 1
        self.stats["reusable_tokens_admitted"] += reuse
        self._tbump(tenant, "admitted")
        return Decision(True, True, d.est_full_ms, "admitted")

    # --- derived quantities (paper §3.2 sanity check) ------------------------
    def summary(self) -> Dict[str, float]:
        return {
            "kv_p99_bytes": self.kv_p99_bytes,
            "live_cache_cap_L": self.live_cap,
            "q_admit_per_instance": self.q_admit,
            "q_max_pool": self.q_max,
            "n_special": self.cfg.n_special,
        }
