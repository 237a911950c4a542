"""Executor protocol + registry: how a ranking instance computes.

Port of ``repro.core.executors``: the protocol, registry and
``SimExecutor`` are copied; the live executors run the PyTorch HSTU
model eagerly on the executor's device (attention through the CUDA
kernels on the card), synchronize the device before every clock read,
and hand the page pool to the paged kernel instead of gathering psi.

The relay-race state machine never touches tensors directly — every
compute step goes through an ``Executor``:

  * ``SimExecutor``  — analytic cost-model latencies, no real compute
    (cluster-scale simulation, capacity planning, paper figures);
  * ``LiveExecutor`` — PyTorch HSTU prefill / rank-with-cache /
    full-rank on the executor's device, latencies measured.

Both satisfy the same ``typing.Protocol``, so the runtime drives the
identical state machine in either mode; new backends register under a
name and are selected per deployment via ``get_executor``:

  * ``BatchedLiveExecutor`` (name ``batched``) — ``LiveExecutor`` plus
    continuous micro-batching: compatible rank requests grouped by the
    per-instance ``BatchAggregator`` execute as ONE batched launch on
    bucketed shapes (``rank_group``), and per-request shapes snap to
    the same bucket grid, so a row's scores do not depend on the batch
    it rode in (each kernel block reduces one row on its own).

An executor opts into runtime-driven batching by carrying a
``batching: BatchingConfig`` attribute and a ``rank_group(group)``
method; ``RelayRuntime`` then parks rank work in a ``BatchAggregator``
and flushes groups through one model slot each.  ``SimExecutor``
mirrors the same surface via ``GRCostModel.batched_rank_ms`` so the
cluster simulator stays trace-comparable with the live engine.

Both executors also serve the *disaggregated-prefill* split
(``ClusterConfig.prefill_hosts > 0``): a dedicated prefill engine
drives only the side-path surface — ``pre_infer`` and the batched
``pre_infer_group`` — while its produced psi is shipped cross-host by
the runtime; the rank surface of the same executor runs on the owning
rank instances.  No prefill-specific executor subclass exists on
purpose: the compute is identical, only the placement (and the NIC
hop) differs.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Protocol, \
    Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.serving.batching import (BatchingConfig, PendingRank,
                                          bucket_of, pad_psi, prefill_grid,
                                          stack_psi)

from .cache import kv_nbytes
from .costmodel import GRCostModel
from .graphs import GraphRunner, resolve_runner
from .paging import (DevicePagePool, PageLayout, PagedPsi, ceil_div,
                     from_host, host_dtype, span_page_rows)
from .types import UserMeta


@runtime_checkable
class Executor(Protocol):
    """Compute backend for one ranking instance."""

    def pre_infer(self, meta: UserMeta) -> Tuple[Any, int, float]:
        """Pre-infer psi for the user's long-term prefix.
        Returns (psi, nbytes, latency_ms)."""
        ...

    def rank_cached(self, meta: UserMeta, psi: Any) -> Tuple[Any, float]:
        """Rank candidates reusing cached psi. Returns (scores, ms)."""
        ...

    def rank_full(self, meta: UserMeta) -> Tuple[Any, float]:
        """Full inference on the critical path (miss fallback)."""
        ...

    def reload_ms(self, meta: UserMeta, tokens: Optional[int] = None
                  ) -> float:
        """DRAM -> HBM reload cost for this user's psi.  ``tokens``
        narrows the transfer to the missing suffix (paged stores resume
        partial reloads); None means the whole prefix."""
        ...


# --- paged psi launch helpers -------------------------------------------------


def page_bucket(tokens: int, page_tokens: int) -> int:
    """Page count a launch pads its tables to: the shared ``BUCKETS``
    token grid expressed in pages (the page-count bucket of a
    ``rank_with_pages`` launch)."""
    return ceil_div(bucket_of(int(tokens)), int(page_tokens))


def _pages_of(tokens: int, psi: PagedPsi) -> int:
    return page_bucket(tokens, psi.layout.page_tokens)


def _pool_and_tables(psis: Sequence[PagedPsi], np_bucket: int, device,
                     runner: Optional[GraphRunner] = None):
    """The pool tensor and the (B, L, 2, np_bucket) int32 page tables —
    per-member (slabs, n) tables padded with the pool's null (all-zero)
    page — that every paged launch reads.

    The pool: a ``DevicePagePool`` passes its device-resident tensor by
    REFERENCE (zero host->device traffic per launch); a host-buffer pool
    re-ships the whole pool (into the graph runner's static pool buffer
    when graphs are on), counted in the owning pool's ``h2d`` ledger.  A
    member whose table exceeds ``np_bucket`` is an error — truncating
    would silently drop cached pages (callers widen the launch bucket to
    the group's largest member instead)."""
    buf = psis[0].buffer
    null = buf.shape[0] - 1
    rows = []
    for psi in psis:
        slabs, n = psi.table.shape
        if n > np_bucket:
            raise ValueError(
                f"page table has {n} pages/slab but the launch bucket "
                f"is {np_bucket}: truncation would silently drop cached "
                f"pages — widen the bucket to the group's largest member")
        t = np.full((slabs, np_bucket), null, np.int32)
        t[:, :n] = psi.table
        rows.append(t.reshape(slabs // 2, 2, np_bucket))
    pool = psis[0].pool
    if isinstance(pool, DevicePagePool):
        launch_buf = pool.device_view(buf)
    else:
        host = from_host(buf)
        if runner is None:
            launch_buf = host.to(device)              # O(pool bytes)
        else:
            launch_buf = runner.reship_buffer(host.shape, host.dtype)
            launch_buf.copy_(host)                    # O(pool bytes)
        if pool is not None:
            pool.h2d["launch_reships"] += 1
            pool.h2d["reshipped_bytes"] += int(buf.nbytes)
    return launch_buf, torch.from_numpy(np.stack(rows)).to(device)


def _page_rows(psis: Sequence[PagedPsi], np_bucket: int, device,
               segments: bool):
    """The per-row inputs of a paged launch besides the tables: the (B,)
    int32 resident token counts (``PagedPsi.n_tokens``: keys between a
    user's prefix_len and the 64-token grid are real K/V, which the dense
    path attends to as well); or, for the segment kernel, each member's
    ``span_page_rows`` as the (B, np_bucket) int32 ``page_pos`` /
    ``page_valid``, padded slots at position 0 holding nothing.
    Residency rides in ``page_valid``.  A prefix-only member is one run
    ``(0, n_tokens)``, which gives the paged launch's scores."""
    if not segments:
        return (torch.tensor([psi.n_tokens for psi in psis],
                             dtype=torch.int32, device=device),)
    pos = np.zeros((len(psis), np_bucket), np.int32)
    valid = np.zeros((len(psis), np_bucket), np.int32)
    for i, psi in enumerate(psis):
        p, v = span_page_rows(psi)
        pos[i, :len(p)], valid[i, :len(v)] = p, v
    return torch.from_numpy(pos).to(device), torch.from_numpy(valid).to(device)


# --- registry ----------------------------------------------------------------

EXECUTORS: Dict[str, Callable[..., Executor]] = {}


def register_executor(name: str):
    def deco(cls):
        EXECUTORS[name] = cls
        return cls

    return deco


def get_executor(name: str) -> Callable[..., Executor]:
    try:
        return EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown executor {name!r}; "
                       f"registered: {sorted(EXECUTORS)}") from None


def executor_names():
    return sorted(EXECUTORS)


# --- built-in executors --------------------------------------------------------


@register_executor("sim")
class SimExecutor:
    """Latency-only executor driven by the analytic cost model.

    Passing a ``BatchingConfig`` opts the executor into runtime-driven
    micro-batching: group launch cost comes from
    ``GRCostModel.batched_rank_ms`` — the sim-side mirror of the live
    ``batched`` executor, keeping ``ClusterSim`` trace-comparable."""

    def __init__(self, cost: GRCostModel,
                 batching: Optional[BatchingConfig] = None,
                 page_tokens: int = 0, segments: bool = False):
        self.cost = cost
        self.batching = batching
        self.page_tokens = int(page_tokens)
        # beyond-prefix segment reuse: the side path also computes the
        # candidate-independent interior segments (UserMeta.seg_lens),
        # and a cache hit ranks only the truly fresh tokens.  Disabled
        # (or with empty seg_lens) every cost is unchanged.
        self.segments = bool(segments)

    def _seg_tokens(self, meta: UserMeta) -> int:
        if not self.segments:
            return 0
        return int(sum(getattr(meta, "seg_lens", ()) or ()))

    def pre_infer(self, meta: UserMeta) -> Tuple[Any, int, float]:
        reuse = meta.prefix_len + self._seg_tokens(meta)
        nbytes = self.cost.kv_bytes(reuse)
        ms = self.cost.pre_infer_ms(reuse)
        return ("psi", meta.user_id, reuse), nbytes, ms

    def rank_cached(self, meta: UserMeta, psi) -> Tuple[Any, float]:
        segs = self._seg_tokens(meta)
        return None, self.cost.rank_on_cache_ms(
            meta.prefix_len + segs, meta.incr_len - segs, meta.n_items)

    def rank_full(self, meta: UserMeta) -> Tuple[Any, float]:
        return None, self.cost.full_rank_ms(
            meta.prefix_len, meta.incr_len, meta.n_items)

    def reload_ms(self, meta: UserMeta, tokens: Optional[int] = None
                  ) -> float:
        t = meta.prefix_len if tokens is None else tokens
        if self.page_tokens:
            # page-granular streaming: resumed reloads pay only for the
            # missing pages — the sim mirror of the paged live store
            return self.cost.paged_load_ms(t, self.page_tokens)
        return self.cost.dram_load_ms(t)

    def rank_group(self, group: Sequence[PendingRank]
                   ) -> Tuple[List[Any], float]:
        """Rank a compatible group in one modelled launch.
        Returns (per-member scores, group wall ms)."""
        per = []
        for w in group:
            m = w.meta
            plen = m.prefix_len if m is not None else w.prefix_len
            if w.psi is not None:
                segs = self._seg_tokens(m) if m is not None else 0
                per.append(self.cost.rank_on_cache_ms(
                    plen + segs, w.incr_len - segs, w.n_items))
            else:
                per.append(self.cost.full_rank_ms(
                    plen, w.incr_len, w.n_items))
        bucket = bucket_of(max(w.prefix_len for w in group))
        return ([None] * len(group),
                self.cost.batched_rank_ms(per, bucket=bucket))

    def pre_infer_group(self, metas: Sequence[UserMeta]
                        ) -> Tuple[List[Tuple[Any, int]], float]:
        """Pre-infer a prefill-grid-compatible group as one modelled
        launch (the batched side path).  Returns
        ([(psi, nbytes), ...], group wall ms) — single-member groups
        cost exactly the per-request ``pre_infer``, keeping uncontended
        traces bit-identical to the unbatched side path."""
        outs, per = [], []
        for m in metas:
            psi, nbytes, ms = self.pre_infer(m)
            outs.append((psi, nbytes))
            per.append(ms)
        bucket = prefill_grid(max(m.prefix_len for m in metas))
        return outs, self.cost.batched_rank_ms(per, bucket=bucket)


@register_executor("live")
class LiveExecutor:
    """Runs the real HSTU backbone on the model's device.

    On a CUDA device every entry point (prefill, rank with cache, full
    rank, paged and segment rank) runs as a CUDA-graph replay keyed by
    its launch shape (``core/graphs.py``): the counterpart of the
    reference's jitted entry points.  ``graphs``: None (default) for
    graphs on CUDA and eager on the CPU, False for eager, True to
    require graphs (raises on the CPU), or a ``GraphRunner`` shared by
    several executors of one model."""

    def __init__(self, model, store, cost: Optional[GRCostModel] = None,
                 page_tokens: int = 0, segments: bool = False,
                 device_pool: bool = False, graphs=None):
        self.model = model
        self.device = model.device      # every tensor of this executor
        self.store = store
        self.cost = cost or GRCostModel(model.cfg)
        self.page_tokens = int(page_tokens)
        self.segments = bool(segments)
        # device-resident page pool: the serving window allocates a
        # DevicePagePool and routes page writes through the
        # insert_pages/free_pages hooks below, so rank_with_pages
        # launches pass the pool by reference instead of re-shipping
        # the host buffer (InstanceRuntime wires store <-> executor)
        self.device_pool = bool(device_pool) and self.page_tokens > 0
        # the executor owns compute geometry: a paged window must page
        # THIS model's psi, not the (possibly full-scale) cost model's
        self.page_layout = (PageLayout.from_model_config(
            model.cfg, page_tokens) if page_tokens else None)
        self.graphs = resolve_runner(graphs, self.device)
        self._warmed: set = set()

    def _sync(self) -> None:
        """Wait for the device before the clock is read: kernel
        launches return at once, so an unsynchronized clock would
        measure the enqueue, not the work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), device=self.device)

    def _psi(self, psi):
        """psi on this device: cached tensors pass through, a host copy
        (a DRAM spill materialized out of the page pool, bf16 as its
        uint16 bits) moves over in its torch type."""
        return tuple(a.to(self.device) if isinstance(a, torch.Tensor)
                     else from_host(a).to(self.device) for a in psi)

    def _round(self, n: int, m: int = 64) -> int:
        return max(m, (n + m - 1) // m * m)  # bucketed shapes

    def _rank_len(self, n: int) -> int:
        """Prefix length a dense rank launch runs at: psi as cached."""
        return n

    def _batch_grid(self, n: int) -> int:
        return 1

    # --- launches: eager, or replayed from a graph per launch key -----------
    # Each launch is (key, fn, args, refs): ``fn(*refs, *args)`` eagerly,
    # or ``GraphRunner.run`` over them.  A key is (entry point, batch,
    # shapes...); a page pool read in place is a ref, its storage in the
    # key.

    def _run(self, key, fn, args, refs=()):
        if self.graphs is None:
            return fn(*refs, *args)
        return self.graphs.run(key, fn, args, refs)

    def _owned(self, t):
        """A launch's result the caller may keep: graph outputs are
        overwritten by the next replay, so they are cloned."""
        if self.graphs is None:
            return t
        return tuple(a.clone() for a in t) if isinstance(t, tuple) \
            else t.clone()

    def _prefill_launch(self, toks):
        return (("prefill", toks.shape[0], toks.shape[1]),
                self.model.prefill, ({"tokens": toks},))

    def _dense_launch(self, psis, bucket: int, incr, items):
        """Rank over dense psi: each member's (K, V) zero-padded to
        ``bucket`` and stacked on the batch axis — written straight into
        the graph's static psi once the key is captured."""
        key = ("rank", len(psis), bucket, incr.shape[1], items.shape[1])
        g = self.graphs.get(key) if self.graphs is not None else None
        if g is not None:
            kv = stack_psi(psis, bucket, out=g.args[0])
        elif len(psis) == 1:
            kv = pad_psi(psis[0], bucket)
        else:
            kv = stack_psi(psis, bucket)
        return key, self.model.rank_with_cache, (kv, incr, items)

    def _full_launch(self, pref, incr, items):
        return (("full", pref.shape[0], pref.shape[1], incr.shape[1],
                 items.shape[1]), self.model.full_rank, (pref, incr, items))

    def _paged_launch(self, buf, tables, rows, incr, items):
        """One paged launch per layer over the pool ``buf``: through the
        segment kernel when segments are on (every paged rank, span-
        carrying or not, then reads the span tables), else through the
        paged-prefix kernel.  The two give the same scores on the live
        path, whose interior spans are zero K/V."""
        kind, fn = (("segment", self.model.rank_with_segments)
                    if self.segments else
                    ("paged", self.model.rank_with_pages))
        key = (kind, tables.shape[0], tables.shape[-1], incr.shape[1],
               items.shape[1], buf.data_ptr(), tuple(buf.shape))
        return key, fn, (tables, *rows, incr, items), (buf,)

    def _rank_paged(self, psis: Sequence[PagedPsi], np_bucket: int, incr,
                    items):
        buf, tables = _pool_and_tables(psis, np_bucket, self.device,
                                       self.graphs)
        rows = _page_rows(psis, np_bucket, self.device, self.segments)
        return self._run(*self._paged_launch(buf, tables, rows, incr, items))

    # --- entry points ----------------------------------------------------------

    def pre_infer(self, meta: UserMeta) -> Tuple[Any, int, float]:
        n = self._round(meta.prefix_len)
        toks = self._tokens(
            np.resize(self.store.long_term(meta.user_id), n)[None, :])
        t0 = time.perf_counter()
        _, kv = self._run(*self._prefill_launch(toks))
        kv = self._owned(kv)
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        kv = self._pad_segments(kv, meta)
        return kv, kv_nbytes(kv), ms

    def rank_cached(self, meta: UserMeta, psi) -> Tuple[Any, float]:
        incr = self._tokens(self.store.short_term(meta.user_id)[None, :])
        items = self._tokens(self.store.candidates(meta.user_id)[None, :])
        t0 = time.perf_counter()
        if isinstance(psi, PagedPsi):
            # page tables pad to the page-count bucket
            scores = self._rank_paged([psi], _pages_of(psi.n_tokens, psi),
                                      incr, items)
        else:
            kv = self._psi(psi)
            scores = self._run(*self._dense_launch(
                [kv], self._rank_len(kv[0].shape[2]), incr, items))
        scores = self._owned(scores)
        self._sync()
        return scores, (time.perf_counter() - t0) * 1e3

    def rank_full(self, meta: UserMeta) -> Tuple[Any, float]:
        n = self._full_pad(meta.prefix_len)
        pref = self._tokens(
            np.resize(self.store.long_term(meta.user_id), n)[None, :])
        incr = self._tokens(self.store.short_term(meta.user_id)[None, :])
        items = self._tokens(self.store.candidates(meta.user_id)[None, :])
        t0 = time.perf_counter()
        scores = self._owned(self._run(*self._full_launch(pref, incr, items)))
        self._sync()
        return scores, (time.perf_counter() - t0) * 1e3

    def _pad_segments(self, kv, meta: UserMeta):
        """Append the segmented entry's span slots to live psi: one
        whole-page run of ZERO K/V per interior segment, matching the
        page grid ``PagedHBMStore.insert`` sizes a span-carrying entry
        to.  Zero keys are exact under silu attention (they contribute
        silu(0)·v = 0), so live scores equal the prefix-only launch
        while the span storage machinery runs end-to-end."""
        segs = tuple(getattr(meta, "seg_lens", ()) or ())
        if not (self.segments and self.page_layout is not None and segs):
            return kv
        pt = self.page_layout.page_tokens
        extra = sum(pt * ceil_div(int(s), pt) for s in segs)
        return tuple(torch.nn.functional.pad(a, (0, 0, 0, 0, 0, extra))
                     for a in kv)

    def _full_pad(self, n: int) -> int:
        """Padded prefix length for the full-inference fallback."""
        return self._round(n)

    def reload_ms(self, meta: UserMeta, tokens: Optional[int] = None
                  ) -> float:
        t = meta.prefix_len if tokens is None else tokens
        if self.page_tokens:
            return self.cost.paged_load_ms(t, self.page_tokens)
        return self.cost.dram_load_ms(t)

    # --- startup pre-warming -------------------------------------------------

    def _warm_shapes(self, prefix_lens, batch_sizes):
        """(prefix lengths, batch sizes) ``warmup`` runs: every length
        of the live 64-token grid the workload hits, batch 1."""
        return sorted({self._round(int(n)) for n in prefix_lens}), [1]

    def _warm(self, key, fn, args, refs=()):
        if self.graphs is None:
            fn(*refs, *args)
        elif self.graphs.get(key) is None:
            self.graphs.capture(key, fn, args, refs)

    def _warm_pool(self, pool) -> torch.Tensor:
        """The pool tensor a serving window's launches will read: a
        ``DevicePagePool``'s resident tensor (bound to this device and
        allocated now), else what a host pool re-ships into (the graph
        runner's static buffer; a zero pool when eager)."""
        cfg = self.model.cfg
        shape = (pool.n_pages + 1, self.page_tokens, cfg.n_heads,
                 cfg.head_dim)
        dtype = self.model.tok.dtype
        if isinstance(pool, DevicePagePool):
            if pool.device is None:
                pool.device = self.device
            return pool.ensure_device(
                np.broadcast_to(np.zeros((), host_dtype(dtype)), shape))
        if self.graphs is not None:
            return self.graphs.reship_buffer(shape, dtype)
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def warmup(self, prefix_lens: Sequence[int],
               batch_sizes: Sequence[int] = (1,),
               incr_len: int = 64, n_items: int = 512,
               pool_pages: int = 0, pools: Sequence = ()) -> List[Tuple]:
        """Run the rank entry points once ahead of traffic, so that the
        first request does not pay the kernel library's load (the build
        and ``ctypes`` load of the CUDA kernels, cuBLAS handles); with
        graphs, capture each launch key (the reference's jit compile,
        ``repro.core.executors`` ``warmup``).  A key left out is captured
        at its first hit.

        ``prefix_lens`` is the expected workload (e.g. the sampled
        arrival stream).  Returns the freshly warmed (prefix length,
        batch, incr_len, n_items) keys (already-warm keys are skipped).
        With ``page_tokens`` set, the paged launch runs too
        (``rank_with_segments`` when segments are on, else
        ``rank_with_pages``) over each of ``pools`` — the serving
        windows' page pools, whose launch tensors the graphs then read
        — or, without pools, over a zero pool of ``pool_pages``
        pages."""
        cfg = self.model.cfg
        dtype = self.model.tok.dtype
        lengths, sizes = self._warm_shapes(prefix_lens, batch_sizes)
        if self.page_tokens and pools:
            bufs = {t.data_ptr(): t for t in map(self._warm_pool, pools)}
            bufs = list(bufs.values())
        elif self.page_tokens and pool_pages:
            bufs = [torch.zeros((pool_pages + 1, self.page_tokens,
                                 cfg.n_heads, cfg.head_dim), dtype=dtype,
                                device=self.device)]
        else:
            bufs = []
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=self.device)
        if self.graphs is not None:
            self.graphs.warming = True
        done = []
        try:
            for n in lengths:
                for nb in sizes:
                    key = (n, nb, incr_len, n_items)
                    if key in self._warmed:
                        continue
                    z = torch.zeros((cfg.n_layers, 1, n, cfg.n_heads,
                                     cfg.head_dim), dtype=dtype,
                                    device=self.device)
                    incr, items = zeros(nb, incr_len), zeros(nb, n_items)
                    self._warm(*self._dense_launch([(z, z)] * nb, n, incr,
                                                   items))
                    self._warm(*self._full_launch(
                        zeros(nb, self._full_pad(n)), incr, items))
                    npb = page_bucket(n, self.page_tokens or 1)
                    rows = ((zeros(nb, npb), zeros(nb, npb))
                            if self.segments else (zeros(nb),))
                    for buf in bufs:
                        self._warm(*self._paged_launch(
                            buf, zeros(nb, cfg.n_layers, 2, npb), rows,
                            incr, items))
                    self._sync()
                    self._warmed.add(key)
                    done.append(key)
        finally:
            if self.graphs is not None:
                self.graphs.warming = False
        return done

    # --- device-pool hooks ---------------------------------------------------
    # The paged window routes its page-data movement through the
    # executor (the owner of the device), so every path that writes
    # pages — fresh insert, resumed partial reload, handoff re-insert,
    # cold-promotion landing — lands them in the device-resident pool
    # with ONE in-place index_copy_, and every free goes back through
    # the same conserved free-list accounting.

    def insert_pages(self, pool: DevicePagePool, pages: Sequence[int],
                     host_buffer: np.ndarray) -> int:
        """Scatter freshly written ``pages`` (already staged in the
        host buffer) into the device-resident pool, binding the pool to
        this executor's device on first use.  Returns the bytes moved
        over the H2D link (== len(pages) * page_bytes)."""
        if pool.device is None:
            pool.device = self.device
        elif pool.device != self.device:
            raise ValueError(f"page pool lives on {pool.device}, executor "
                             f"on {self.device}")
        return pool.scatter(pages, host_buffer)

    def free_pages(self, pool, pages: Sequence[int]) -> None:
        """Return pages to the pool's free list (pin/zombie protection
        applies unchanged).  No device write: a freed page is
        unreachable until realloc re-stages and re-scatters it."""
        pool.free(pages)


@register_executor("batched")
class BatchedLiveExecutor(LiveExecutor):
    """LiveExecutor + continuous micro-batching on bucketed shapes.

    Shape discipline is what makes batching correct AND cheap:

      * pre-inference keeps the 64-token grid (psi stays compact);
      * every rank launch — per-request or grouped — snaps the prefix
        axis to the shared ``BUCKETS`` grid (psi zero-padded, which is
        exact for HSTU's silu attention; full-rank prefix tokens tiled,
        matching what the per-request call does after bucketing);
      * the batch axis snaps to a power-of-two grid by repeating the
        first member (row-independent compute, sliced off afterwards),
        so few distinct launch shapes exist — ``warmup`` captures each
        (or runs it once, eagerly) so the first request does not pay the
        kernel library's load;
      * over a paged HBM window (``page_tokens > 0``) the group path
        becomes ``rank_with_pages``: members carry ``PagedPsi`` handles,
        their page tables pad to the page-count bucket with the pool's
        null page, and the paged kernel reads K/V from the pool inside
        the one launch — scores equal the dense path's.
    """

    def __init__(self, model, store, cost: Optional[GRCostModel] = None,
                 batching: Optional[BatchingConfig] = None,
                 page_tokens: int = 0, segments: bool = False,
                 device_pool: bool = False, graphs=None):
        super().__init__(model, store, cost, page_tokens=page_tokens,
                         segments=segments, device_pool=device_pool,
                         graphs=graphs)
        self.batching = batching or BatchingConfig()

    # --- per-request paths on the bucket grid -------------------------------

    def _rank_len(self, n: int) -> int:
        return bucket_of(n)

    def _full_pad(self, n: int) -> int:
        return bucket_of(n)

    # --- group path ---------------------------------------------------------

    def _batch_grid(self, n: int) -> int:
        """Smallest power-of-two >= n, clamped to max_batch (so a
        non-power-of-two max_batch tops the grid itself)."""
        b = 1
        while b < n and b < self.batching.max_batch:
            b *= 2
        return min(b, self.batching.max_batch)

    def rank_group(self, group: Sequence[PendingRank]
                   ) -> Tuple[List[Any], float]:
        """Execute a compatible group as ONE batched launch.
        Returns (per-member scores, measured group wall ms)."""
        n = len(group)
        bucket = bucket_of(max(w.prefix_len for w in group))
        pad_rows = self._batch_grid(n) - n
        rows = list(group) + [group[0]] * pad_rows
        incr = np.stack([w.incr if w.incr is not None
                         else self.store.short_term(w.user_id)
                         for w in rows])
        items = np.stack([w.items if w.items is not None
                          else self.store.candidates(w.user_id)
                          for w in rows])
        t0 = time.perf_counter()
        incr, items = self._tokens(incr), self._tokens(items)
        if isinstance(group[0].psi, PagedPsi):
            # rank_with_pages: ONE launch per layer keyed (page-count
            # bucket, batch grid); K/V stay in the page pool and the
            # kernel reads them through the stacked page tables.  The
            # bucket widens to the group's largest member: a segmented
            # entry's whole-page span padding can push its table past
            # the prefix-derived bucket, and truncating it would drop
            # cached pages (prefix-only members never exceed the prefix
            # bucket, so this is exact for them)
            pt = group[0].psi.layout.page_tokens
            npb = max([page_bucket(bucket, pt)]
                      + [_pages_of(w.psi.n_tokens, w.psi) for w in rows])
            scores = self._rank_paged([w.psi for w in rows], npb, incr,
                                      items)
        elif group[0].psi is not None:        # homogeneous by aggregator key
            scores = self._run(*self._dense_launch(
                [self._psi(w.psi) for w in rows], bucket, incr, items))
        else:
            pref = self._tokens(np.stack([
                np.resize(self.store.long_term(w.user_id), bucket)
                for w in rows]))
            scores = self._run(*self._full_launch(pref, incr, items))
        scores = self._owned(scores[:n])
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        return [scores[i] for i in range(n)], ms

    def pre_infer_group(self, metas: Sequence[UserMeta]
                        ) -> Tuple[List[Tuple[Any, int]], float]:
        """Batched pre-inference: ONE prefill for a group sharing the
        64-token prefill grid (the aggregator keys pre work by
        ``prefill_grid``, so every member's padded length is identical).
        The batch axis snaps to the power-of-two grid by repeating the
        first member.  Each member gets its OWN contiguous psi copy: a
        view ``a[:, i:i+1]`` would pin the whole batched psi (or, with
        graphs, the next replay would overwrite it), and the window's
        byte ledger would undercount the memory the device holds."""
        n = self._round(max(m.prefix_len for m in metas))
        rows = list(metas)
        rows += [metas[0]] * (self._batch_grid(len(metas)) - len(metas))
        toks = self._tokens(np.stack(
            [np.resize(self.store.long_term(m.user_id), n) for m in rows]))
        t0 = time.perf_counter()
        _, kv = self._run(*self._prefill_launch(toks))
        self._sync()
        ms = (time.perf_counter() - t0) * 1e3
        outs = []
        for i, meta in enumerate(metas):
            psi = tuple(a[:, i:i + 1].clone(memory_format=torch.contiguous_format)
                        for a in kv)                 # (L, 1, n, H, D)
            psi = self._pad_segments(psi, meta)
            outs.append((psi, kv_nbytes(psi)))
        return outs, ms

    # --- startup pre-warming -------------------------------------------------

    def _warm_shapes(self, prefix_lens, batch_sizes):
        """The ``batching.max_buckets_live`` most frequent buckets of the
        workload, at every batch size of the power-of-two grid that
        ``batch_sizes`` reach."""
        freq = Counter(bucket_of(int(n)) for n in prefix_lens)
        buckets = sorted(b for b, _ in
                         freq.most_common(self.batching.max_buckets_live))
        return buckets, sorted({self._batch_grid(int(b))
                                for b in batch_sizes})
