"""Block-granular psi storage: the fixed-size HBM page pool (port of
``repro.core.paging``: the allocator is copied unchanged, the device
pool is a torch tensor, and psi reaches the host through ``to_host``).

The unpaged window stores each admitted psi(u) as one monolithic pytree,
so mixed prefix lengths fragment the ``r1 * HBM`` budget (invariant I2)
and every spill/reload moves a whole prefix.  Paging fixes both: the
budget is carved into fixed-size pages of ``page_tokens`` tokens each,
an entry owns a *page table* instead of a dense buffer, and the only
waste is the zero padding of each slab's last page.

Layout.  psi(u) is the per-layer (K, V) pytree of shape
``(L, B, P, H, D)``; paging slices the token axis P.  Each of the
``2 * L`` K/V planes — called *slabs* here — is paged independently, so
one page holds ``page_tokens`` tokens of ONE slab, shaped
``(page_tokens, H, D)``.  A ``PagedPsi`` handle carries the
``(slabs, n_pages)`` page table; the paged CUDA kernel
(``repro_torch.kernels.paged_prefix_attn``), which the live executor's
``rank_with_pages`` path launches, reads K/V from the pool through it.

Accounting is conserved at page granularity, mirroring the entry-level
turnstile of the HBM window:

    stats["pages_allocated"] == pages_live + stats["pages_freed"]

after any interleaving, and the free list never double-allocates
(tests/test_cache_properties.py).  Pages referenced by an in-flight
rank launch are *pinned*: freeing a pinned page parks it in a zombie
set (still occupying the pool, still "live") and the release after the
launch returns it to the free list — so a batched group can never read
a page the window recycled under it.

``DevicePagePool`` keeps the same bookkeeping but makes the data plane
a device-resident torch tensor mutated in place: freshly written pages
land via ``index_copy_`` and rank launches pass the pool by reference
(zero per-launch re-ship); the ``h2d`` ledger on every pool accounts the
host->device traffic either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """psi (or any array) as a host numpy array: THE one device->host
    hop of the paged window — a torch tensor on the card is copied once,
    a numpy array passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Static geometry of the page pool for one model family."""
    page_tokens: int
    slabs: int                  # independently paged K/V planes: 2 * L
    token_bytes: int            # bytes per token per slab: H * D * itemsize

    @property
    def page_bytes(self) -> int:
        return self.page_tokens * self.token_bytes

    def pages_per_slab(self, tokens: int) -> int:
        return ceil_div(max(int(tokens), 1), self.page_tokens)

    def entry_pages(self, tokens: int) -> int:
        """Pool pages held by a fully resident psi of ``tokens`` tokens."""
        return self.slabs * self.pages_per_slab(tokens)

    def entry_bytes(self, tokens: int) -> int:
        return self.entry_pages(tokens) * self.page_bytes

    @classmethod
    def from_model_config(cls, cfg, page_tokens: int) -> "PageLayout":
        # pages must tile the 64-token shape-bucket grid exactly, or the
        # paged launch pads to a different context length than the dense
        # bucketed path and the 1/n_total normalizer silently diverges —
        # fail at config time instead of producing wrong scores
        if page_tokens <= 0 or 64 % int(page_tokens) != 0:
            raise ValueError(
                f"page_tokens={page_tokens} must divide the 64-token "
                f"bucket grid (1, 2, 4, 8, 16, 32 or 64) so paged and "
                f"dense launches share shape buckets and normalizers")
        itemsize = 4 if cfg.dtype == "float32" else 2
        return cls(page_tokens=int(page_tokens),
                   slabs=2 * cfg.n_layers,
                   token_bytes=cfg.n_heads * cfg.head_dim * itemsize)


class PagePool:
    """Free-list allocator over a fixed number of pages.

    Pure bookkeeping — data lives in the owner's (optional) page buffer,
    indexed by the ids handed out here.  Conservation invariant:
    ``stats["pages_allocated"] == pages_live + stats["pages_freed"]``
    where a page stays *live* from alloc until it actually returns to
    the free list (a freed-but-pinned zombie is still live: it occupies
    pool capacity until the pinning launch releases it).
    """

    def __init__(self, n_pages: int, page_bytes: int):
        self.n_pages = int(n_pages)
        self.page_bytes = int(page_bytes)
        self._free: List[int] = list(range(self.n_pages - 1, -1, -1))
        self._pins: Dict[int, int] = {}     # page id -> in-flight refs
        self._zombies: set = set()          # freed while pinned
        self.stats = {"pages_allocated": 0, "pages_freed": 0,
                      "alloc_failures": 0, "peak_pages": 0}
        # host->device traffic ledger.  On a DevicePagePool the scatter
        # side counts every page landed in the device-resident buffer
        # (``bytes_scattered`` == bytes of freshly written pages) and
        # ``launch_reships`` stays 0; on a host-buffer pool the launch
        # path counts each whole-pool re-ship instead.
        self.h2d = {"bytes_scattered": 0, "pages_scattered": 0,
                    "scatters": 0, "launch_reships": 0,
                    "reshipped_bytes": 0}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def zombie_pages(self) -> int:
        return len(self._zombies)

    @property
    def pages_live(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` page ids, or None (and a counted failure) if the
        free list is short — the caller evicts and retries."""
        if n > len(self._free):
            self.stats["alloc_failures"] += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        self.stats["pages_allocated"] += n
        self.stats["peak_pages"] = max(self.stats["peak_pages"],
                                       self.pages_live)
        return pages

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self._pins.get(p, 0) > 0:
                self._zombies.add(p)        # still live until unpinned
            else:
                self._free.append(p)
                self.stats["pages_freed"] += 1

    def pin(self, pages: Sequence[int]) -> None:
        for p in pages:
            self._pins[p] = self._pins.get(p, 0) + 1

    def unpin(self, pages: Sequence[int]) -> None:
        for p in pages:
            n = self._pins.get(p, 0) - 1
            if n <= 0:
                self._pins.pop(p, None)
                if p in self._zombies:      # deferred free fires now
                    self._zombies.discard(p)
                    self._free.append(p)
                    self.stats["pages_freed"] += 1
            else:
                self._pins[p] = n


class DevicePagePool(PagePool):
    """Page pool whose data plane is a device-resident torch tensor
    mutated in place: inserts and reload completions ``scatter`` only the
    freshly written pages into the resident buffer, and rank launches
    pass the buffer by reference — zero per-launch host->device
    re-ship.  The device is the executor's: it binds ``device`` when it
    first lands pages (``LiveExecutor.insert_pages``); there is no
    global default.

    Bookkeeping (free list, pins, zombies, conservation) is inherited
    unchanged, so stale-page reuse is impossible by construction: a
    freed page cannot re-enter a table until the allocator hands it out
    again, and every allocation is rewritten (host slice + scatter)
    before any launch can reference it — the stale device bytes of a
    recycled page are unreadable in between.  The owner's host buffer
    stays the staging area and source of truth for host-side reads
    (``PagedPsi.materialize`` on evict-spill / handoff-extract); the
    device buffer mirrors it incrementally, starting from device-side
    zeros so ``h2d["bytes_scattered"]`` counts exactly the inserted
    page bytes."""

    def __init__(self, n_pages: int, page_bytes: int, device=None):
        super().__init__(n_pages, page_bytes)
        self.device = None if device is None else torch.device(device)
        self.device_buffer = None           # lazily shaped torch tensor

    def ensure_device(self, host_buffer: np.ndarray):
        """Create the resident buffer on first use — device-side zeros
        (matching the zero-filled host pool), so creation itself moves
        no bytes over the link."""
        if self.device_buffer is None:
            if self.device is None:
                raise RuntimeError(
                    "DevicePagePool has no device: the executor that owns "
                    "the pool binds it (LiveExecutor.insert_pages)")
            self.device_buffer = torch.zeros(
                host_buffer.shape, device=self.device,
                dtype=torch.from_numpy(host_buffer[:0]).dtype)
        return self.device_buffer

    def device_view(self, host_buffer: np.ndarray):
        """The resident pool buffer a launch passes by reference."""
        return self.ensure_device(host_buffer)

    def scatter(self, pages: Sequence[int], host_buffer: np.ndarray) -> int:
        """Land freshly written ``pages`` (already sliced into
        ``host_buffer``) in the device-resident pool.  Returns the bytes
        moved over the H2D link (== len(pages) * page_bytes)."""
        pages = [int(p) for p in pages]
        if not pages:
            return 0
        self.ensure_device(host_buffer)
        idx = np.asarray(pages, np.int64)
        # the reference's donated ``.at[idx].set(vals)`` scatter becomes
        # an in-place index_copy_ into the resident tensor: only the
        # fresh pages cross the link, and the pool is never copied
        self.device_buffer.index_copy_(
            0, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(host_buffer[idx]).to(self.device))
        nbytes = len(pages) * self.page_bytes
        self.h2d["bytes_scattered"] += nbytes
        self.h2d["pages_scattered"] += len(pages)
        self.h2d["scatters"] += 1
        return nbytes


class PagedPsi:
    """Handle to a paged psi: the page table plus the pool buffer.

    This is what a paged ``CacheEntry.value`` holds in live mode and
    what ``classify_rank`` snapshots for a (possibly deferred) batched
    launch.  ``table`` is ``(slabs, n_pages)`` int32 — row ``2*l`` is
    layer ``l``'s K plane, row ``2*l + 1`` its V plane.  ``materialize``
    gathers back to the dense ``(L, 1, P, H, D)`` (K, V) numpy pair — used
    when psi leaves the pool (DRAM spill) — with P padded to the page
    grid (zero tail, exact for HSTU's silu attention).
    """

    def __init__(self, table: np.ndarray, n_tokens: int, layout: PageLayout,
                 buffer: Optional[np.ndarray], spans=None,
                 pool: Optional[PagePool] = None):
        self.table = np.asarray(table, np.int32)
        self.n_tokens = int(n_tokens)
        self.layout = layout
        self.buffer = buffer
        # owning pool (when handed out by a PagedHBMStore): lets the
        # launch path pass a DevicePagePool's resident buffer by
        # reference instead of re-shipping the host pool per launch
        self.pool = pool
        # beyond-prefix reuse: ordered (global_start, valid_len) cached
        # spans; None for prefix-only psi.  Each span occupies whole
        # pages (``n_tokens`` is the padded total), so the consumer can
        # derive the kernel's page_pos/page_valid tables from it.
        self.spans = tuple(spans) if spans else None

    @property
    def pages(self) -> List[int]:
        return [int(p) for p in self.table.reshape(-1)]

    def materialize(self) -> Any:
        assert self.buffer is not None, "sim-mode psi has no page data"
        slabs, np_ = self.table.shape
        L = slabs // 2
        # (slabs, n_pages, pt, H, D) -> (slabs, P_padded, H, D)
        flat = self.buffer[self.table].reshape(
            slabs, np_ * self.layout.page_tokens, *self.buffer.shape[2:])
        k = flat[0::2][:, None]             # (L, 1, P, H, D)
        v = flat[1::2][:, None]
        return (k.copy(), v.copy())


def slice_into_pages(buffer: np.ndarray, table: np.ndarray, value: Any,
                     page_tokens: int, t0: int = 0) -> None:
    """Write the dense psi pytree ``value`` — per-layer (K, V) arrays of
    shape (L, B, P, H, D) — into pool ``buffer`` pages named by
    ``table`` (slabs, n_pages), starting at token ``t0`` (page-aligned;
    nonzero for partial-reload resume).  The tail of the last page is
    zeroed so padded tokens contribute silu(0) = 0 exactly."""
    k, v = value
    k, v = to_host(k), to_host(v)
    P = k.shape[2]
    assert t0 % page_tokens == 0, (t0, page_tokens)
    for slab in range(table.shape[0]):
        src = (k if slab % 2 == 0 else v)[slab // 2, 0]   # (P, H, D)
        for j in range(t0 // page_tokens, table.shape[1]):
            pid = int(table[slab, j])
            lo = j * page_tokens
            hi = min(lo + page_tokens, P)
            n = max(hi - lo, 0)
            if n > 0:
                buffer[pid, :n] = src[lo:hi]
            buffer[pid, n:] = 0.0
