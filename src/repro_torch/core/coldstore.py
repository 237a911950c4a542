# Copied from src/repro/core/coldstore.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Cold tier: host-local SSD / remote psi store under the DRAM expander.

MTServe-style hierarchical caching (PAPERS.md): at capacity-harness
population scale (millions of users, Zipf tail) the DRAM expander's
LRU horizon is a few hundred entries, so every tail user falls
straight back to full re-inference the first time their DRAM copy is
evicted.  The cold tier catches those evictions — a ``ColdStore`` per
rank host holds demoted psi under a (large) byte budget, and a later
trigger-admitted visit *promotes* the copy back up the hierarchy off
the critical path.

The store itself is deliberately dumb: an LRU dict of dense
``CacheEntry`` copies with the unified tier counter family.  All
*timing* lives in the runtime — demotions and promotions are priced
through ``GRCostModel.psi_transfer_ms(link="cold")`` and serialized on
a per-host cold link that contends exactly like the NIC
(``RelayRuntime._cold_transfer``).  All *policy* lives in the trigger
(cold-aware admission scoring) and the runtime (promotion on the pre
path, lazy cross-host handoff on next touch after churn).

Counter family (every tier reports the same core so ``stats()``
renders one coherent table):

    inserts == live + evictions + handoffs + promotions

``evictions``  — LRU / replacement drops (the copy is gone);
``handoffs``   — extracted for a lazy cross-host re-home (extract !=
                 evict, same turnstile discipline as the HBM window);
``promotions`` — moved UP the hierarchy (cold -> DRAM revival).
Extras: ``hits`` / ``misses`` (runtime probes that did / did not find
a resident copy) and ``rejected_inserts`` (could never fit).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional

from .cache import CacheEntry, tenant_ledger
from .types import CacheState


@dataclasses.dataclass
class ColdStoreConfig:
    #: byte budget of the host's SSD namespace / remote-store share;
    #: 0 disables the tier (``ClusterConfig.cold_budget_bytes``)
    budget_bytes: float = 0.0


class ColdStore:
    """LRU cold store for demoted psi (one per rank host)."""

    def __init__(self, cfg: ColdStoreConfig,
                 tenant_quota: Optional[Dict[int, int]] = None):
        self.cfg = cfg
        self.entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        self.used_bytes = 0
        self.stats: Dict[str, int] = {
            "inserts": 0, "evictions": 0, "handoffs": 0, "promotions": 0,
            "hits": 0, "misses": 0, "rejected_inserts": 0,
            "cross_tenant_evictions": 0,
        }
        # multi-tenant partition (same discipline as the HBM window and
        # DRAM expander): tenant id -> byte share; a tenant's demotion
        # only LRU-evicts that tenant's own copies.  None = untenanted.
        self.tenant_quota = ({int(t): int(b)
                              for t, b in tenant_quota.items()}
                             if tenant_quota is not None else None)
        self.tenant_used: Optional[Dict[int, int]] = (
            {t: 0 for t in self.tenant_quota}
            if self.tenant_quota is not None else None)
        self.tenant_stats = tenant_ledger(
            self.tenant_quota, "inserts", "evictions", "handoffs",
            "promotions", "hits")

    # --- tenant partition helpers ------------------------------------------
    def _tenant_budget(self, tenant: int) -> float:
        if self.tenant_quota is None:
            return self.cfg.budget_bytes
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
        for uid, e in self.entries.items():
            if self.tenant_quota is not None and e.tenant != int(tenant):
                continue
            return uid
        return None

    @property
    def live_count(self) -> int:
        return len(self.entries)

    # --- writes (demotion landings) -----------------------------------------

    def insert(self, entry: CacheEntry) -> bool:
        """Land a demoted copy.  Replaces any stale copy of the same
        user (counted as an eviction — the old bytes are gone), LRU-
        evicts until the budget fits, and rejects entries that could
        never fit.  The entry must carry a dense ``value`` (the DRAM
        tier materializes paged psi at spill time)."""
        if entry.nbytes > self._tenant_budget(entry.tenant) \
                or entry.value is None:
            self.stats["rejected_inserts"] += 1
            return False
        self.drop(entry.user_id)            # stale same-user copy
        used = (self.tenant_used.get(int(entry.tenant), 0)
                if self.tenant_used is not None else self.used_bytes)
        while (used + entry.nbytes > self._tenant_budget(entry.tenant)
               and self.entries):
            old_uid = self._lru_victim(entry.tenant)
            if old_uid is None:
                break
            old = self.entries.pop(old_uid)
            self.used_bytes -= old.nbytes
            self._taccount(old.tenant, -old.nbytes)
            if old.tenant != entry.tenant:
                self.stats["cross_tenant_evictions"] += 1
            self.stats["evictions"] += 1
            self._tbump(old.tenant, "evictions")
            used = (self.tenant_used.get(int(entry.tenant), 0)
                    if self.tenant_used is not None else self.used_bytes)
        entry.state = CacheState.COLD
        self.entries[entry.user_id] = entry
        self.used_bytes += entry.nbytes
        self._taccount(entry.tenant, entry.nbytes)
        self.stats["inserts"] += 1
        self._tbump(entry.tenant, "inserts")
        return True

    # --- reads ---------------------------------------------------------------

    def peek(self, user_id: int) -> Optional[CacheEntry]:
        """Residency probe with NO accounting and no LRU touch — for
        admission-time scoring (the trigger's cold estimator) and the
        runtime's owner-locality checks."""
        return self.entries.get(user_id)

    def lookup(self, user_id: int) -> Optional[CacheEntry]:
        """Accounted probe: counts hit/miss and renews LRU position."""
        e = self.entries.get(user_id)
        if e is None:
            self.stats["misses"] += 1
            return None
        self.entries.move_to_end(user_id)
        self.stats["hits"] += 1
        self._tbump(e.tenant, "hits")
        return e

    # --- removals (the three turnstiles) ------------------------------------

    def take(self, user_id: int) -> Optional[CacheEntry]:
        """Remove for promotion up the hierarchy (cold -> DRAM)."""
        return self._remove(user_id, "promotions")

    def extract(self, user_id: int) -> Optional[CacheEntry]:
        """Remove for a lazy cross-host re-home: the entry is leaving
        this store but NOT the hierarchy (extract != evict)."""
        return self._remove(user_id, "handoffs")

    def drop(self, user_id: int) -> bool:
        """Discard a (stale) copy; counted as an eviction."""
        return self._remove(user_id, "evictions") is not None

    def _remove(self, user_id: int, counter: str) -> Optional[CacheEntry]:
        e = self.entries.pop(user_id, None)
        if e is None:
            return None
        self.used_bytes -= e.nbytes
        self._taccount(e.tenant, -e.nbytes)
        self.stats[counter] += 1
        self._tbump(e.tenant, counter)
        return e
