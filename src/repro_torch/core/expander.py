# Copied from src/repro/core/expander.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Memory-aware expander (paper §3.4): server-local DRAM reuse tier.

HBM bridges a single request lifecycle; DRAM extends reuse across
repeated requests from the same user (rapid refresh) at bounded H2D
cost.  Three mechanisms:

  * two-level lookup: HBM first, DRAM on miss, then DRAM->HBM reload;
  * per-user single-flight: at most one cache-affecting action in flight
    per user — concurrent requests wait and then hit HBM;
  * pseudo-pre-infer: a lightweight cache-check step enqueued in front of
    every ranking request, so out-of-order arrivals (ranking before the
    real pre-infer lands) trigger at most ONE reload per user per burst.

Reloads are additionally rate-limited with a bounded-concurrency gate so
the expander cannot become a new PCIe bottleneck.

With a paged HBM window (``repro_torch.core.cache.PagedHBMStore``) both
directions go block-granular: a spill materializes psi out of the page
pool into a dense host copy, and a reload streams only the pages the
window is missing — a partially evicted entry (tail pages freed under
pressure) RESUMES from its resident head instead of restarting, with
``CacheEntry.reload_tokens`` carrying the remaining transfer so the
executor prices exactly the missing pages.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from .cache import CacheEntry, HBMCacheStore, tenant_ledger
from .paging import PagedPsi
from .types import CacheState


@dataclasses.dataclass
class ExpanderConfig:
    dram_budget_bytes: float = 500e9
    max_reload_concurrency: int = 4


class SingleFlight:
    """Per-user in-flight op registry. begin() returns True for the op
    leader; followers queue and are released on end()."""

    def __init__(self):
        self._inflight: Dict[int, int] = {}

    def begin(self, user_id: int) -> bool:
        n = self._inflight.get(user_id, 0)
        self._inflight[user_id] = n + 1
        return n == 0

    def end(self, user_id: int):
        n = self._inflight.get(user_id, 0)
        if n <= 1:
            self._inflight.pop(user_id, None)
        else:
            self._inflight[user_id] = n - 1

    def active(self, user_id: int) -> bool:
        """True while any op for this user is still in flight."""
        return self._inflight.get(user_id, 0) > 0

    def waiters(self, user_id: int) -> int:
        return max(0, self._inflight.get(user_id, 0) - 1)


class DRAMExpander:
    def __init__(self, cfg: ExpanderConfig,
                 tenant_quota: Optional[Dict[int, int]] = None):
        self.cfg = cfg
        self.entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        self.used_bytes = 0
        self.flight = SingleFlight()
        self.active_reloads = 0
        # multi-tenant partition: tenant id -> byte share of the DRAM
        # budget.  A tenant's spill only LRU-evicts that tenant's own
        # copies; None (single-tenant) builds no tenant machinery.
        self.tenant_quota = ({int(t): int(b)
                              for t, b in tenant_quota.items()}
                             if tenant_quota is not None else None)
        self.tenant_used: Optional[Dict[int, int]] = (
            {t: 0 for t in self.tenant_quota}
            if self.tenant_quota is not None else None)
        self.tenant_stats = tenant_ledger(
            self.tenant_quota, "inserts", "evictions", "demotions",
            "promotions", "handoffs", "spills", "dram_hits",
            "lru_evictions")
        # Optional cold-tier hook: when a runtime wires a sink, LRU
        # evictees are DEMOTED down the hierarchy (the sink prices and
        # lands the copy asynchronously) instead of dropped.  Returns
        # whether the sink accepted the entry.
        self.demote_sink = None
        # Unified tier counter family (same core as HBMCacheStore and
        # ColdStore, so stats() renders one coherent table):
        #   inserts == live + evictions + demotions + handoffs + promotions
        # evictions  — copies dropped from the hierarchy (LRU without a
        #              cold tier, same-user replacement, unfit drops);
        # demotions  — LRU evictees accepted by the cold-tier sink;
        # promotions — copies moved UP (DRAM -> HBM reload completed);
        # handoffs   — extracted for rebalance migration.
        # The rest are tier-specific extras (note lru_evictions counts
        # ALL LRU removals, demoted or dropped).
        self.stats = {"inserts": 0, "evictions": 0, "demotions": 0,
                      "promotions": 0, "handoffs": 0,
                      "spills": 0, "reloads": 0, "redundant_avoided": 0,
                      "dram_hits": 0, "dram_misses": 0, "lru_evictions": 0,
                      "reload_throttled": 0, "unfit_dropped": 0,
                      "rejected_spills": 0, "cross_tenant_evictions": 0}

    # --- tenant partition helpers ------------------------------------------
    def _tenant_budget(self, tenant: int) -> float:
        if self.tenant_quota is None:
            return self.cfg.dram_budget_bytes
        return self.tenant_quota.get(int(tenant), 0)

    def _taccount(self, tenant: int, delta: int):
        if self.tenant_used is not None:
            t = int(tenant)
            self.tenant_used[t] = self.tenant_used.get(t, 0) + delta

    def _tbump(self, tenant: int, key: str, n: int = 1):
        if self.tenant_stats is not None:
            s = self.tenant_stats.get(int(tenant))
            if s is not None:
                s[key] = s.get(key, 0) + n

    def _lru_victim(self, tenant: int) -> Optional[int]:
        """Oldest entry eligible for eviction on behalf of ``tenant``:
        the global LRU head untenanted, the tenant's OWN LRU head under
        partition (a tenant's spill never displaces another tenant)."""
        for uid, e in self.entries.items():
            if self.tenant_quota is not None and e.tenant != int(tenant):
                continue
            return uid
        return None

    # --- spill (after consumption, off the critical path) -------------------
    def spill(self, entry: CacheEntry) -> bool:
        """Store ``entry`` in the DRAM tier; returns whether it fit
        (callers use this for their own spill accounting)."""
        if entry.value is None:
            # a partially evicted paged entry finally left the window:
            # its stale head is worthless, but the full DRAM copy made
            # at consume time already lives here — keep it fresh
            if entry.user_id in self.entries:
                self.entries.move_to_end(entry.user_id)
                return True
            return False
        if entry.nbytes > self._tenant_budget(entry.tenant):
            # an entry that can never fit must be rejected UP FRONT,
            # without disturbing the tier: letting it reach the LRU
            # loop would evict every resident psi before the final fit
            # check rejects it anyway (mirror of the HBM window's
            # rejected_inserts)
            self.stats["rejected_spills"] += 1
            return False
        if isinstance(entry.value, PagedPsi):
            # psi leaves the pool: the DRAM copy is a dense host pytree,
            # detached from page ids the window is free to recycle
            entry = dataclasses.replace(
                entry, value=entry.value.materialize(), page_table=None,
                tokens_resident=entry.prefix_len)
        elif entry.page_table is not None:
            entry = dataclasses.replace(entry, page_table=None,
                                        tokens_resident=entry.prefix_len)
        if entry.user_id in self.entries:
            stale = self._remove(entry.user_id)
            self.stats["evictions"] += 1       # replaced same-user copy
            self._tbump(stale.tenant, "evictions")
        used = (self.tenant_used.get(int(entry.tenant), 0)
                if self.tenant_used is not None else self.used_bytes)
        while (used + entry.nbytes > self._tenant_budget(entry.tenant)
               and self.entries):
            old_uid = self._lru_victim(entry.tenant)
            if old_uid is None:
                break
            _ = self._remove(old_uid)          # LRU (same-tenant under quota)
            if _.tenant != entry.tenant:
                self.stats["cross_tenant_evictions"] += 1
            self.stats["lru_evictions"] += 1
            self._tbump(_.tenant, "lru_evictions")
            if self.demote_sink is not None and self.demote_sink(_):
                self.stats["demotions"] += 1   # spilled DOWN, not dropped
                self._tbump(_.tenant, "demotions")
            else:
                self.stats["evictions"] += 1
                self._tbump(_.tenant, "evictions")
            used = (self.tenant_used.get(int(entry.tenant), 0)
                    if self.tenant_used is not None else self.used_bytes)
        if entry.nbytes <= self._tenant_budget(entry.tenant):
            entry.state = CacheState.DRAM
            self.entries[entry.user_id] = entry
            self.used_bytes += entry.nbytes
            self._taccount(entry.tenant, entry.nbytes)
            self.stats["spills"] += 1
            self.stats["inserts"] += 1
            self._tbump(entry.tenant, "spills")
            self._tbump(entry.tenant, "inserts")
            return True
        return False

    def lookup(self, user_id: int) -> Optional[CacheEntry]:
        e = self.entries.get(user_id)
        if e is None:
            self.stats["dram_misses"] += 1
        else:
            self.entries.move_to_end(user_id)  # LRU touch
            self.stats["dram_hits"] += 1
            self._tbump(e.tenant, "dram_hits")
        return e

    def _remove(self, user_id: int) -> CacheEntry:
        e = self.entries.pop(user_id)
        self.used_bytes -= e.nbytes
        self._taccount(e.tenant, -e.nbytes)
        return e

    def take(self, user_id: int) -> Optional[CacheEntry]:
        """Remove an entry for ownership handoff (rebalancing churn):
        the DRAM copy migrates to the new owning host's tier instead of
        being dropped.  No hit/miss accounting — this is background
        migration, not a lookup."""
        e = self.entries.get(user_id)
        if e is not None:
            self._remove(user_id)
            self.stats["handoffs"] = self.stats.get("handoffs", 0) + 1
            self._tbump(e.tenant, "handoffs")
        return e

    # --- pseudo-pre-infer --------------------------------------------------
    def pseudo_pre_infer(self, user_id: int, hbm: HBMCacheStore,
                         now: float) -> Tuple[str, Optional[CacheEntry]]:
        """The cache-check step enqueued ahead of every ranking request.

        Returns (action, entry):
          'hbm'    — psi already resident, proceed to ranking directly;
          'reload' — leader: psi in DRAM, caller performs the (rate-
                     limited) DRAM->HBM reload;
          'wait'   — follower: another op for this user is in flight;
                     caller re-probes HBM after the leader completes;
          'miss'   — psi nowhere local: caller falls back (or the real
                     pre-infer computes it)."""
        e = hbm.lookup(user_id)
        if e is not None:
            return "hbm", e
        leader = self.flight.begin(user_id)
        if not leader:
            self.stats["redundant_avoided"] += 1
            return "wait", None
        d = self.lookup(user_id)
        if d is None:
            return "miss", None
        if not hbm.fits(d.nbytes, d.prefix_len, tenant=d.tenant):
            # permanently unpromotable (psi over the whole window
            # budget): drop the copy so we stop scheduling doomed
            # reloads — otherwise every request for this user would pay
            # a full H2D transfer just to be rejected and fall back
            self._remove(user_id)
            self.stats["unfit_dropped"] += 1
            self.stats["evictions"] += 1
            self._tbump(d.tenant, "evictions")
            return "miss", None
        if self.active_reloads >= self.cfg.max_reload_concurrency:
            self.stats["reload_throttled"] += 1
            return "miss", None
        # page-granular streaming: a partially resident window entry
        # resumes — only the missing suffix rides the H2D channel
        d.reload_tokens = hbm.missing_tokens(user_id, d.prefix_len)
        return "reload", d

    def complete_reload(self, user_id: int, hbm: HBMCacheStore, now: float
                        ) -> List[CacheEntry]:
        """Leader finished the H2D copy: promote DRAM entry into HBM.
        A paged window with a partially resident entry tops up just the
        missing tail pages (``PagedHBMStore._resume``)."""
        e = self.entries.get(user_id)
        evicted: List[CacheEntry] = []
        if e is not None:
            e.reload_tokens = None
            evicted = hbm.insert(user_id, e.value, e.nbytes, now,
                                 prefix_len=e.prefix_len, spans=e.spans,
                                 tenant=e.tenant)
            if hbm.resident(user_id) is None:
                # the window rejected the promotion: the reload is
                # wasted, but a TRANSIENTLY rejected copy (zombie-
                # pinched paged pool) must survive — dropping it would
                # turn every future request for this user into a cold
                # full-inference miss although psi still exists
                # locally.  A permanently unfit psi is dropped so no
                # further reloads get scheduled for it.
                if not hbm.fits(e.nbytes, e.prefix_len, tenant=e.tenant):
                    self._remove(user_id)
                    self.stats["unfit_dropped"] += 1
                    self.stats["evictions"] += 1
                    self._tbump(e.tenant, "evictions")
                return evicted
            self._remove(user_id)
            e.state = CacheState.HBM
            # the copy moved UP and out of this tier; a cold-revived
            # entry keeps its marker so the rank it unblocks classifies
            # as a cold hit
            hbm.entries[user_id].dram_backed = False
            hbm.entries[user_id].cold_sourced = e.cold_sourced
            self.stats["reloads"] += 1
            self.stats["promotions"] += 1
            self._tbump(e.tenant, "promotions")
        return evicted

    def finish(self, user_id: int):
        self.flight.end(user_id)
