"""HBM-resident prefix-cache store — the sliding lifecycle window.

Port of ``repro.core.cache`` with two repairs for torch tensors:
``kv_nbytes`` sizes a tensor by ``numel() * element_size()`` (``np.dtype``
of a torch dtype raises), and the paged store brings psi to the host
through ``paging.to_host`` instead of ``np.asarray``.

Admitted prefix caches psi(u) are inserted by pre-inference, consumed by
ranking within the request lifecycle T_life, and evicted as new admitted
users arrive (paper Fig. 10).  The store enforces the byte budget
``r1 * HBM`` from invariant I2; admission control (trigger) is what makes
the budget sufficient for survival — the store itself just implements
the window and reports violations (an admitted-but-evicted-before-
consumption cache counts as a ``premature_eviction``; under a correctly
configured trigger this stays at zero, and the property tests assert it).

Accounting is conserved: every entry that ever entered the window is
either still live or counted in ``evictions`` (budget pressure,
same-user refresh, or an explicit ``pop``), so

    stats["inserts"] == live_count + stats["evictions"]

holds after any interleaving (tests/test_cache_properties.py).

In live mode ``CacheEntry.value`` holds the real per-layer KV pytree
psi(u) — (K, V) tensors of shape (L, B, P, H, D) as produced by
``HSTUModel.prefill`` — which the batched executor pads and stacks
directly (``repro_torch.serving.batching.pad_psi``); ``kv_nbytes`` sizes such
a pytree for budget accounting.

An insert that can never fit (``nbytes`` over the whole budget) is
REJECTED up front: the window is left untouched, the rejection is
counted in ``stats["rejected_inserts"]``, and the runtime observes the
absence as a miss — it must never believe psi is resident.

``PagedHBMStore`` is the block-granular variant (``ClusterConfig.
page_tokens > 0``): same window semantics, but psi is stored in a
fixed-size page pool (``repro_torch.core.paging``) so mixed prefix lengths
share the budget without fragmentation, eviction can free just the tail
pages of a consumed DRAM-backed entry, and a later reload *resumes*
from the still-resident head pages instead of restarting.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .paging import (DevicePagePool, PageLayout, PagePool, PagedPsi,
                     ceil_div, slice_into_pages, to_host)
from .types import CacheState


def kv_nbytes(value: Any) -> int:
    """Bytes held by a KV pytree (nested tuples/lists/dicts of arrays);
    scalar/stub values (the sim executor's psi token) count as zero."""
    if isinstance(value, (tuple, list)):
        return sum(kv_nbytes(v) for v in value)
    if isinstance(value, dict):
        return sum(kv_nbytes(v) for v in value.values())
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    shape = getattr(value, "shape", None)
    dtype = getattr(value, "dtype", None)
    if shape is None or dtype is None:
        return 0
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


@dataclasses.dataclass
class CacheEntry:
    user_id: int
    value: Any                 # pytree of per-layer KV (or a byte-size stub)
    nbytes: int
    created_at: float
    state: CacheState = CacheState.HBM
    consumed: bool = False
    prefix_len: int = 0
    dram_backed: bool = False  # a DRAM spill copy exists (set by runtime)
    # paged-store residency: tokens still page-resident (== prefix_len
    # when fully resident; less after a partial tail eviction) and the
    # tokens a pending DRAM->HBM reload must actually stream
    tokens_resident: int = 0
    reload_tokens: Optional[int] = None
    page_table: Optional[np.ndarray] = None   # (slabs, n_pages) int32
    # beyond-prefix segment reuse: ordered (global_start, valid_len)
    # cached spans — None for prefix-only entries.  In the paged store a
    # segmented entry pads EVERY span to whole pages and ``prefix_len``
    # holds the padded total, so the page math (entry_pages, resume,
    # partial tail eviction) is span-agnostic; ``spans`` preserves the
    # true layout for the kernel's position/validity tables.
    spans: Optional[Tuple[Tuple[int, int], ...]] = None
    # cold-tier revival marker: set when this copy was promoted out of
    # the cold store; the first rank it serves classifies as COLD_HIT
    # (then the flag clears — later lifecycles are ordinary warm hits)
    cold_sourced: bool = False
    # multi-tenant serving: the tenant this psi belongs to.  Rides the
    # entry through every tier (HBM -> DRAM -> cold) and every copy
    # (spill / demotion / handoff), so partition enforcement never has
    # to guess ownership.  0 for single-tenant deployments.
    tenant: int = 0


def tenant_ledger(quota: Optional[Dict[int, int]], *keys: str
                  ) -> Optional[Dict[int, Dict[str, int]]]:
    """Per-tenant counter block for a store: one zeroed dict of ``keys``
    per tenant in the quota map, or None when the store is untenanted
    (single-tenant deployments build no per-tenant machinery at all)."""
    if quota is None:
        return None
    return {int(t): {k: 0 for k in keys} for t in quota}


class HBMCacheStore:
    """FIFO sliding-window cache under a byte budget (single instance).

    With a ``tenant_quota`` map (multi-tenant serving) the byte budget
    is PARTITIONED: each tenant owns a fixed share, an insert can only
    evict that tenant's own entries, and a cross-tenant eviction — the
    isolation violation the partition exists to prevent — is counted in
    ``stats["cross_tenant_evictions"]`` (asserted zero by the invariant
    suite).  ``tenant_quota=None`` (the default) builds none of this
    and is bit-identical to the untenanted store.
    """

    def __init__(self, budget_bytes: int,
                 tenant_quota: Optional[Dict[int, int]] = None):
        self.budget = int(budget_bytes)
        self.entries: "OrderedDict[int, CacheEntry]" = OrderedDict()
        self.used_bytes = 0
        self.stats = {"inserts": 0, "hits": 0, "misses": 0,
                      "evictions": 0, "premature_evictions": 0,
                      "rejected_inserts": 0, "peak_bytes": 0,
                      "handoffs": 0, "cross_tenant_evictions": 0}
        self.tenant_quota = ({int(t): int(b)
                              for t, b in tenant_quota.items()}
                             if tenant_quota is not None else None)
        self.tenant_used: Optional[Dict[int, int]] = (
            {t: 0 for t in self.tenant_quota}
            if self.tenant_quota is not None else None)
        self.tenant_stats = tenant_ledger(
            self.tenant_quota, "inserts", "hits", "evictions",
            "premature_evictions", "rejected_inserts", "handoffs")

    def __contains__(self, user_id: int) -> bool:
        return user_id in self.entries

    @property
    def live_count(self) -> int:
        return len(self.entries)

    # --- tenant partition helpers (inert when tenant_quota is None) ----------

    def _tenant_budget(self, tenant: int) -> int:
        if self.tenant_quota is None:
            return self.budget
        return self.tenant_quota.get(int(tenant), 0)

    def _taccount(self, tenant: int, delta: int) -> None:
        if self.tenant_used is not None:
            self.tenant_used[int(tenant)] = \
                self.tenant_used.get(int(tenant), 0) + delta

    def _tbump(self, tenant: int, key: str, n: int = 1) -> None:
        if self.tenant_stats is not None:
            self.tenant_stats.setdefault(
                int(tenant),
                {k: 0 for k in next(iter(self.tenant_stats.values()))}
            )[key] += n

    def _victim_uid(self, tenant: int, exclude: Optional[int] = None
                    ) -> Optional[int]:
        """Oldest evictable entry for an insert by ``tenant``: FIFO over
        the whole window when untenanted, FIFO over the tenant's OWN
        entries under a partition (never another tenant's)."""
        for uid, e in self.entries.items():
            if uid == exclude:
                continue
            if self.tenant_quota is not None and e.tenant != tenant:
                continue
            return uid
        return None

    def insert(self, user_id: int, value: Any, nbytes: int, now: float,
               prefix_len: int = 0,
               spans: Optional[Tuple[Tuple[int, int], ...]] = None,
               tenant: int = 0) -> List[CacheEntry]:
        """Insert psi(u); evicts oldest entries past the budget.
        Returns the evicted entries (candidates for DRAM spill).

        An entry larger than the whole budget can never land: it is
        rejected WITHOUT disturbing other entries (evicting everything
        for a doomed insert would only manufacture premature evictions)
        and counted in ``stats["rejected_inserts"]`` so callers observe
        the absence instead of believing psi is resident.  A rejected
        same-user REFRESH still evicts the superseded psi — serving the
        stale cache for the new lifecycle would be the silent-drop bug
        this path exists to prevent.

        Under a tenant partition the budget tests run against the
        tenant's OWN share and the pressure loop only evicts the
        tenant's own entries."""
        if int(nbytes) > self._tenant_budget(tenant):
            evicted = ([self._evict(user_id)]
                       if user_id in self.entries else [])
            self.stats["rejected_inserts"] += 1
            self._tbump(tenant, "rejected_inserts")
            return evicted
        if user_id in self.entries:
            # same-user refresh: the superseded psi leaves the window
            # (counted as an eviction for conservation, never premature —
            # the fresher psi serves this lifecycle)
            self._evict(user_id)
        entry = CacheEntry(user_id, value, int(nbytes), now,
                           prefix_len=prefix_len, tokens_resident=prefix_len,
                           spans=tuple(spans) if spans else None,
                           tenant=int(tenant))
        evicted = []
        used = (self.tenant_used.get(int(tenant), 0)
                if self.tenant_used is not None else self.used_bytes)
        while used + entry.nbytes > self._tenant_budget(tenant) \
                and self.entries:
            old_uid = self._victim_uid(tenant)
            if old_uid is None:
                break
            old = self.entries[old_uid]
            self._evict(old_uid)
            if old.tenant != entry.tenant:
                self.stats["cross_tenant_evictions"] += 1
            if not old.consumed:
                self.stats["premature_evictions"] += 1
                self._tbump(old.tenant, "premature_evictions")
            evicted.append(old)
            used = (self.tenant_used.get(int(tenant), 0)
                    if self.tenant_used is not None else self.used_bytes)
        self.entries[user_id] = entry
        self.used_bytes += entry.nbytes
        self._taccount(tenant, entry.nbytes)
        self.stats["inserts"] += 1
        self._tbump(tenant, "inserts")
        self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                       self.used_bytes)
        return evicted

    def lookup(self, user_id: int) -> Optional[CacheEntry]:
        e = self.entries.get(user_id)
        if e is None:
            self.stats["misses"] += 1
        else:
            self.stats["hits"] += 1
            self._tbump(e.tenant, "hits")
        return e

    def consume(self, user_id: int) -> Optional[CacheEntry]:
        """Mark psi(u) consumed by ranking; it stays until evicted by the
        sliding window (it may serve same-lifecycle repeats) but becomes
        the preferred spill candidate."""
        e = self.entries.get(user_id)
        if e is not None:
            e.consumed = True
        return e

    def pop(self, user_id: int) -> Optional[CacheEntry]:
        e = self.entries.get(user_id)
        if e is not None:
            self._evict(user_id)
        return e

    def extract(self, user_id: int) -> Optional[CacheEntry]:
        """Remove an entry for ownership HANDOFF during rebalancing —
        not an eviction: the entry continues its lifecycle on another
        instance, so it bypasses the eviction/premature accounting and
        is counted in ``stats["handoffs"]`` instead.  Conservation
        across churn is therefore

            inserts == live_count + evictions + handoffs
        """
        e = self.entries.pop(user_id, None)
        if e is None:
            return None
        self.used_bytes -= e.nbytes
        self._taccount(e.tenant, -e.nbytes)
        self.stats["handoffs"] += 1
        self._tbump(e.tenant, "handoffs")
        return e

    def fits(self, nbytes: int, prefix_len: int = 0,
             tenant: int = 0) -> bool:
        """Could an entry of this size EVER land in the window?  False
        means permanently unpromotable (over the whole budget — or over
        the owning tenant's share, under a partition) — the expander
        uses this to stop scheduling doomed reloads."""
        return int(nbytes) <= self._tenant_budget(tenant)

    def missing_tokens(self, user_id: int, total: int) -> int:
        """Tokens a DRAM->HBM reload must stream for this user.  The
        dense store is all-or-nothing; the paged store subtracts the
        still-resident head pages of a partially evicted entry."""
        return int(total)

    def resident(self, user_id: int) -> Optional[CacheEntry]:
        """Entry if psi is FULLY resident (no hit/miss accounting) —
        the pre-inference dedup probe."""
        return self.entries.get(user_id)

    def touch(self, user_id: int, now: float) -> None:
        """Same-psi refresh without data movement: a deduped pre-infer
        found psi already resident — renew its lifecycle (back of the
        FIFO window, consumption re-armed)."""
        e = self.entries.get(user_id)
        if e is not None:
            e.consumed = False
            e.created_at = now
            self.entries.move_to_end(user_id)

    def acquire_value(self, entry: CacheEntry) -> Any:
        """Snapshot psi for a rank launch.  Paired with
        ``release_value`` after the launch; the paged store pins the
        entry's pages across the (possibly deferred) batched launch so
        window recycling can't free them mid-flight."""
        return entry.value

    def release_value(self, psi: Any) -> None:
        pass

    def _evict(self, user_id: int) -> CacheEntry:
        e = self.entries.pop(user_id)
        self.used_bytes -= e.nbytes
        self._taccount(e.tenant, -e.nbytes)
        e.state = CacheState.EVICTED
        self.stats["evictions"] += 1
        self._tbump(e.tenant, "evictions")
        return e


def _is_kv_pytree(value: Any) -> bool:
    """True for a real per-layer (K, V) psi — (L, B, P, H, D) arrays —
    as opposed to the sim executor's scalar stub."""
    return (isinstance(value, (tuple, list)) and len(value) == 2
            and getattr(value[0], "ndim", 0) == 5
            and getattr(value[1], "ndim", 0) == 5)


class PagedHBMStore(HBMCacheStore):
    """Block-granular HBM window: the ``r1 * HBM`` budget carved into a
    fixed-size page pool (free-list allocator, ``repro_torch.core.paging``).

    Same external contract as the dense store — insert / lookup /
    consume / pop, FIFO window, conserved entry accounting — plus:

      * an entry holds a per-slab *page table* (one row per layer K/V
        plane) instead of a dense pytree; ``used_bytes`` counts whole
        pages, so the only waste is each slab's last-page padding;
      * eviction under pressure can free just the TAIL pages of the
        oldest consumed, DRAM-backed entry (``partial_evictions``) —
        the head stays resident and a later reload *resumes*, streaming
        only the missing pages (``resumed_reloads``);
      * launches pin pages (``acquire_value``/``release_value``), so a
        deferred batched launch never reads a recycled page;
      * in live mode the pool owns a real ``(n_pages + 1, page_tokens,
        H, D)`` buffer (lazily shaped from the first psi; the extra
        last row is the all-zero null page used to pad page tables to a
        bucket) and ``PagedPsi`` handles point into it;
      * with ``device_pool=True`` the pool is a ``DevicePagePool``:
        the host buffer stays the staging area / host-read source, and
        every page write additionally scatters into the device-resident
        mirror (one donated update per insert/resume) so rank launches
        pass the pool by reference instead of re-shipping it.
    """

    def __init__(self, budget_bytes: int, layout: PageLayout,
                 device_pool: bool = False,
                 tenant_quota: Optional[Dict[int, int]] = None):
        super().__init__(budget_bytes, tenant_quota=tenant_quota)
        self.layout = layout
        pool_cls = DevicePagePool if device_pool else PagePool
        self.pool = pool_cls(
            n_pages=int(budget_bytes) // layout.page_bytes,
            page_bytes=layout.page_bytes)
        # page-granular partition: each tenant's byte share floors to
        # whole pages — a tenant's insert can only allocate inside its
        # own page quota, so one tenant's footprint can never starve
        # another's pool (None when untenanted)
        self.tenant_pages: Optional[Dict[int, int]] = (
            {t: int(b) // layout.page_bytes
             for t, b in self.tenant_quota.items()}
            if self.tenant_quota is not None else None)
        self.buffer: Optional[np.ndarray] = None   # lazily shaped
        # device-pool routing: when the runtime wires an executor here
        # (``InstanceRuntime``), page-data movement goes through its
        # insert_pages/free_pages hooks; unwired device pools scatter
        # directly.  None + host pool is the pure-host path.
        self.device_hooks = None
        # gather a dense host copy of psi when it leaves the pool, so
        # the evictee can spill to DRAM; deployments without a DRAM
        # tier turn this off (InstanceRuntime) — the copy would be
        # discarded anyway
        self.materialize_on_evict = True
        self.stats.update({"partial_evictions": 0, "resumed_reloads": 0,
                           "pages_reloaded": 0})

    @property
    def null_page(self) -> int:
        return self.pool.n_pages                   # always-zero pad row

    def _tokens_of(self, nbytes: int, prefix_len: int) -> int:
        if prefix_len > 0:
            return int(prefix_len)
        per_token = self.layout.slabs * self.layout.token_bytes
        return max(1, ceil_div(int(nbytes), per_token))

    def _ensure_buffer(self, value: Any) -> None:
        if self.buffer is not None or not _is_kv_pytree(value):
            return
        k = to_host(value[0])
        H, D = k.shape[3], k.shape[4]
        self.buffer = np.zeros(
            (self.pool.n_pages + 1, self.layout.page_tokens, H, D), k.dtype)

    def _land_pages(self, pages) -> None:
        """Route freshly staged pages to the device-resident pool —
        every write path (fresh insert, resumed reload, handoff
        re-insert, cold-promotion landing) converges here, so the
        device mirror can never miss a page a launch may reference."""
        if self.buffer is None:
            return                          # sim mode: no page data
        pages = [int(p) for p in pages]
        if self.device_hooks is not None:
            self.device_hooks.insert_pages(self.pool, pages, self.buffer)
        elif isinstance(self.pool, DevicePagePool):
            self.pool.scatter(pages, self.buffer)

    def _free_pages(self, pages) -> None:
        """Single exit turnstile for page frees (through the executor
        hook when wired, so device- and host-pool deployments free
        through the same conserved accounting)."""
        pages = [int(p) for p in pages]
        if self.device_hooks is not None:
            self.device_hooks.free_pages(self.pool, pages)
        else:
            self.pool.free(pages)

    # --- insert: fresh / refresh / resume -----------------------------------

    def _tenant_page_cap(self, tenant: int) -> int:
        if self.tenant_pages is None:
            return self.pool.n_pages
        return self.tenant_pages.get(int(tenant), 0)

    def _tenant_pages_used(self, tenant: int) -> int:
        if self.tenant_used is None:
            return 0
        return self.tenant_used.get(int(tenant), 0) // self.layout.page_bytes

    def insert(self, user_id: int, value: Any, nbytes: int, now: float,
               prefix_len: int = 0,
               spans: Optional[Tuple[Tuple[int, int], ...]] = None,
               tenant: int = 0) -> List[CacheEntry]:
        tokens = self._tokens_of(nbytes, prefix_len)
        if spans:
            # segmented entry: every span pads to whole pages so spans
            # stay independently addressable; the page math (entry
            # sizing, resume, partial tail eviction) runs on the PADDED
            # total, which becomes the entry's prefix_len.  Live psi
            # for a segmented entry must arrive pre-padded to the same
            # grid (zero pad keys are exact under silu attention).
            pt = self.layout.page_tokens
            tokens = sum(pt * ceil_div(int(ln), pt) for _, ln in spans)
        if _is_kv_pytree(value):
            # live psi arrives on the executor's 64-token prefill grid,
            # which can overhang the page grid — page the WHOLE value
            # so paged and dense ranking see identical keys
            tokens = max(tokens, int(value[0].shape[2]))
        need = self.layout.entry_pages(tokens)
        if need > self._tenant_page_cap(tenant):
            # doomed insert: reject, but never let a superseded psi
            # serve the new lifecycle (same contract as the base store)
            evicted = ([self._evict(user_id)]
                       if user_id in self.entries else [])
            self.stats["rejected_inserts"] += 1
            self._tbump(tenant, "rejected_inserts")
            return evicted
        self._ensure_buffer(value)
        existing = self.entries.get(user_id)
        if (existing is not None and existing.prefix_len == tokens
                and existing.tokens_resident < existing.prefix_len):
            return self._resume(existing, value, now)
        if existing is not None:
            # same-user refresh: superseded psi leaves through the
            # eviction turnstile, exactly like the dense store
            self._evict(user_id)
        evicted = self._make_room(need, exclude=user_id, tenant=tenant)
        pages = self.pool.alloc(need)
        if pages is None:
            # pinned zombie pages of in-flight launches can transiently
            # shrink the pool below the byte budget; reject, observed
            # by the runtime as a miss
            self.stats["rejected_inserts"] += 1
            self._tbump(tenant, "rejected_inserts")
            return evicted
        pps = self.layout.pages_per_slab(tokens)
        table = np.asarray(pages, np.int32).reshape(self.layout.slabs, pps)
        entry = CacheEntry(
            user_id, value, need * self.layout.page_bytes, now,
            prefix_len=tokens, tokens_resident=tokens, page_table=table,
            spans=tuple(spans) if spans else None, tenant=int(tenant))
        if self.buffer is not None and _is_kv_pytree(value):
            slice_into_pages(self.buffer, table, value,
                             self.layout.page_tokens)
            self._land_pages(table.reshape(-1))
            entry.value = PagedPsi(table, tokens, self.layout, self.buffer,
                                   spans=entry.spans, pool=self.pool)
        self.entries[user_id] = entry
        self.used_bytes += entry.nbytes
        self._taccount(tenant, entry.nbytes)
        self.stats["inserts"] += 1
        self._tbump(tenant, "inserts")
        self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                       self.used_bytes)
        return evicted

    def _resume(self, entry: CacheEntry, value: Any, now: float
                ) -> List[CacheEntry]:
        """Partial-reload completion: top up the missing tail pages of a
        partially resident entry instead of restarting from scratch."""
        pps_full = self.layout.pages_per_slab(entry.prefix_len)
        pps_res = self.layout.pages_per_slab(entry.tokens_resident) \
            if entry.tokens_resident else 0
        missing = (pps_full - pps_res) * self.layout.slabs
        evicted = self._make_room(missing, exclude=entry.user_id,
                                  tenant=entry.tenant)
        pages = self.pool.alloc(missing)
        if pages is None:                  # zombie-pinched pool: restart
            evicted.append(self._evict(entry.user_id))
            self.stats["rejected_inserts"] += 1
            return evicted
        fresh = np.asarray(pages, np.int32).reshape(
            self.layout.slabs, pps_full - pps_res)
        table = np.concatenate([entry.page_table[:, :pps_res], fresh],
                               axis=1)
        entry.page_table = table
        if self.buffer is not None and _is_kv_pytree(value):
            t0 = pps_res * self.layout.page_tokens
            slice_into_pages(self.buffer, table, value,
                             self.layout.page_tokens, t0=t0)
            # partial-reload resume: only the missing TAIL pages move
            # over the link — the resident head never re-ships
            self._land_pages(fresh.reshape(-1))
            entry.value = PagedPsi(table, entry.prefix_len, self.layout,
                                   self.buffer, spans=entry.spans,
                                   pool=self.pool)
        added = missing * self.layout.page_bytes
        entry.tokens_resident = entry.prefix_len
        entry.nbytes += added
        entry.consumed = False             # re-armed for this lifecycle
        entry.dram_backed = False          # the DRAM copy moved out
        entry.created_at = now
        self.entries.move_to_end(entry.user_id)
        self.used_bytes += added
        self._taccount(entry.tenant, added)
        self.stats["resumed_reloads"] += 1
        self.stats["pages_reloaded"] += missing
        self.stats["peak_bytes"] = max(self.stats["peak_bytes"],
                                       self.used_bytes)
        return evicted

    def _make_room(self, need: int, exclude: int, tenant: int = 0
                   ) -> List[CacheEntry]:
        """Free pages until ``need`` fit: partial tail eviction of the
        oldest consumed DRAM-backed entry when that covers the deficit,
        whole-entry FIFO eviction otherwise.  Under a tenant partition
        the pressure test is the tenant's own page quota and victims
        come only from the tenant's own entries."""
        evicted: List[CacheEntry] = []
        while (self.pool.free_pages < need
               or self._tenant_pages_used(tenant) + need
               > self._tenant_page_cap(tenant)):
            victim = self._victim_uid(tenant, exclude=exclude)
            if victim is None:
                break
            old = self.entries[victim]
            if self.tenant_pages is None:
                deficit = need - self.pool.free_pages
            else:
                deficit = (self._tenant_pages_used(tenant) + need
                           - self._tenant_page_cap(tenant))
            per_slab = ceil_div(deficit, self.layout.slabs)
            pps_res = self.layout.pages_per_slab(old.tokens_resident) \
                if old.tokens_resident else 0
            if (old.consumed and old.dram_backed and 0 < per_slab < pps_res):
                # free just the tail pages; the head stays resident and
                # the next reload for this user resumes from it
                keep = pps_res - per_slab
                tail = old.page_table[:, keep:pps_res].reshape(-1)
                self._free_pages(tail)
                freed = per_slab * self.layout.slabs
                old.tokens_resident = keep * self.layout.page_tokens
                old.nbytes -= freed * self.layout.page_bytes
                self.used_bytes -= freed * self.layout.page_bytes
                self._taccount(old.tenant, -freed * self.layout.page_bytes)
                self.stats["partial_evictions"] += 1
                continue
            self._evict(victim)
            if old.tenant != int(tenant):
                self.stats["cross_tenant_evictions"] += 1
            if not old.consumed:
                self.stats["premature_evictions"] += 1
                self._tbump(old.tenant, "premature_evictions")
            evicted.append(old)
        return evicted

    # --- residency-aware lookups --------------------------------------------

    def lookup(self, user_id: int) -> Optional[CacheEntry]:
        e = self.entries.get(user_id)
        if e is not None and e.tokens_resident < e.prefix_len:
            self.stats["misses"] += 1      # partial: ranking needs all of psi
            return None
        return super().lookup(user_id)

    def fits(self, nbytes: int, prefix_len: int = 0,
             tenant: int = 0) -> bool:
        tokens = self._tokens_of(nbytes, prefix_len)
        return self.layout.entry_pages(tokens) \
            <= self._tenant_page_cap(tenant)

    def missing_tokens(self, user_id: int, total: int) -> int:
        e = self.entries.get(user_id)
        if e is None or e.prefix_len != int(total):
            return int(total)
        return max(int(total) - e.tokens_resident, 0)

    def resident(self, user_id: int) -> Optional[CacheEntry]:
        e = self.entries.get(user_id)
        if e is None or e.tokens_resident < e.prefix_len:
            return None
        return e

    def extract(self, user_id: int) -> Optional[CacheEntry]:
        """Handoff removal, page-pool flavour: the travelling copy must
        be detached from this pool, so a fully resident PagedPsi is
        materialized to a dense host pytree before its pages are freed.
        A partially resident entry's stale head is worthless off-host —
        its full DRAM backing copy (it is dram_backed by construction)
        migrates instead, and the value travels as ``None``."""
        e = self.entries.get(user_id)
        if e is None:
            return None
        if e.page_table is not None:
            pps_res = self.layout.pages_per_slab(e.tokens_resident) \
                if e.tokens_resident else 0
            if isinstance(e.value, PagedPsi):
                full = e.tokens_resident >= e.prefix_len
                e.value = e.value.materialize() if full else None
            self._free_pages(e.page_table[:, :pps_res].reshape(-1))
            e.page_table = None
        return super().extract(user_id)

    # --- launch pinning ------------------------------------------------------

    def acquire_value(self, entry: CacheEntry) -> Any:
        if entry.page_table is None:
            return entry.value
        pps = self.layout.pages_per_slab(entry.tokens_resident)
        psi = PagedPsi(entry.page_table[:, :pps].copy(),
                       entry.tokens_resident, self.layout, self.buffer,
                       spans=entry.spans, pool=self.pool)
        self.pool.pin(psi.pages)
        return psi

    def release_value(self, psi: Any) -> None:
        if isinstance(psi, PagedPsi):
            self.pool.unpin(psi.pages)

    # --- eviction frees pages ------------------------------------------------

    def _evict(self, user_id: int) -> CacheEntry:
        e = self.entries[user_id]
        if e.page_table is not None:
            pps_res = self.layout.pages_per_slab(e.tokens_resident) \
                if e.tokens_resident else 0
            if isinstance(e.value, PagedPsi):
                # psi leaves the pool: materialize the dense copy for a
                # possible DRAM spill BEFORE the pages are recycled.
                # Skipped when the copy could never be used — no DRAM
                # tier, unconsumed victim (never spilled), or an entry
                # whose byte-identical DRAM copy already exists (the
                # consume-time spill or a partial entry's backing;
                # value None makes the expander keep the existing copy)
                spillable = (self.materialize_on_evict and e.consumed
                             and not e.dram_backed
                             and e.tokens_resident >= e.prefix_len)
                e.value = e.value.materialize() if spillable else None
            self._free_pages(e.page_table[:, :pps_res].reshape(-1))
            e.page_table = None
            e.tokens_resident = 0
        return super()._evict(user_id)


def make_hbm_store(budget_bytes: int, layout: Optional[PageLayout] = None,
                   device_pool: bool = False,
                   tenant_quota: Optional[Dict[int, int]] = None
                   ) -> HBMCacheStore:
    """Window factory: dense store, or the paged pool when a layout is
    given (``ClusterConfig.page_tokens > 0``).  ``device_pool`` makes
    the pool's data plane a device-resident array mutated in place by
    scatter-on-insert (``ClusterConfig.device_pool``).  ``tenant_quota``
    (tenant id -> byte share) partitions the window per tenant."""
    if layout is None:
        return HBMCacheStore(budget_bytes, tenant_quota=tenant_quota)
    return PagedHBMStore(budget_bytes, layout, device_pool=device_pool,
                         tenant_quota=tenant_quota)
