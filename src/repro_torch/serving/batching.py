"""Continuous micro-batching for ranking instances (port of
``repro.serving.batching``: psi padding and stacking on torch tensors,
the group executor run eagerly; the aggregator is copied unchanged).

The paper's "M model slots" (§3.2, Fig. 7) abstracts NPU-side
concurrency.  On a real accelerator the equivalent mechanism is
*batched execution with bucketed shapes*: ranking requests that arrive
within a short window are grouped by (kind, prefix-bucket, incr-len,
item-count) and executed as one batched launch, amortizing dispatch and
filling the MXU.

This module implements that layer for the live engine:

  * shape bucketing — prefix lengths round up to power-of-two-ish
    buckets so few distinct launch shapes exist
    (``BatchedLiveExecutor.warmup`` runs each once at startup);
  * a `BatchAggregator` that groups compatible requests up to
    ``max_batch`` or ``max_wait_ms``;
  * `BatchedRankExecutor` — drop-in for `LiveExecutor.rank_cached` that
    pads/stacks per-user psi caches and scores candidates for the whole
    group in one `rank_with_cache` call.

The live relay path drives this layer through the registered ``batched``
executor (``repro_torch.core.executors.BatchedLiveExecutor``): ``RelayRuntime``
enqueues ``PendingRank`` work into a per-instance ``BatchAggregator``
and flushes groups through one model slot each (see
``src/repro/core/README.md`` for the lifecycle).

Correctness contract: batched scores equal per-request scores (same
mask semantics; padding keys are masked by zero-length contribution) —
asserted in tests/test_batching.py.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def bucket_of(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def prefill_grid(n: int, grid: int = 64) -> int:
    """The prefill shape grid: prefix lengths round up to ``grid``
    tokens (the live executor's psi layout).  Batched pre-inference
    groups by THIS key — members of one group share the padded prefill
    length, so each member's psi slice is bit-identical to the psi its
    own per-request prefill would have produced."""
    return max(grid, (int(n) + grid - 1) // grid * grid)


def pad_psi(psi, target_len: int):
    """Right-pad a per-layer (K, V) pair — tensors (L, B, P, H, D) —
    with zero keys/values up to ``target_len`` along the P axis.

    Exact for HSTU's pointwise attention: zero K rows contribute
    silu(q . 0) = silu(0) = 0, so padded keys add literally nothing to
    the aggregation; only the 1/n_total normalizer must then use the
    padded length consistently, which every caller in a bucket does."""
    k, v = psi
    pad = target_len - k.shape[2]
    if pad <= 0:
        return psi
    # F.pad lists (before, after) pairs from the LAST axis: H, D untouched
    widths = (0, 0, 0, 0, 0, pad)
    return (torch.nn.functional.pad(k, widths),
            torch.nn.functional.pad(v, widths))


def stack_psi(psis, bucket: int, out=None):
    """Pad each member's (K, V) to the shared prefix bucket and stack on
    the batch axis — THE group-launch cache layout, shared by the raw
    ``BatchedRankExecutor`` and ``BatchedLiveExecutor.rank_group``.

    ``out``: a (K, V) pair of (L, len(psis), bucket, H, D) tensors to
    write into (a CUDA graph's static psi) — each member is copied once
    into its row and the row's tail zeroed; returns ``out``."""
    if out is None:
        ks, vs = zip(*(pad_psi(psi, bucket) for psi in psis))
        return (torch.cat(ks, dim=1), torch.cat(vs, dim=1))
    for dst, src in zip(out, zip(*psis)):
        if dst.shape[1] != len(src) or dst.shape[2] != bucket:
            raise ValueError(f"out {tuple(dst.shape)} does not hold "
                             f"{len(src)} members at bucket {bucket}")
        for i, a in enumerate(src):
            n = a.shape[2]
            dst[:, i:i + 1, :n].copy_(a)
            dst[:, i:i + 1, n:].zero_()
    return out


@dataclasses.dataclass
class PendingRank:
    """One ranking request parked in the aggregator.

    ``psi`` is the cached per-layer (K, V) pytree for the rank-on-cache
    path, or ``None`` for a miss-fallback (full inference) member —
    the two kinds never share a batch.  ``incr``/``items`` carry the
    token arrays when the caller has them (raw ``BatchedRankExecutor``
    use); the runtime instead fills ``meta`` and the executor fetches
    tokens from its behaviour store."""
    user_id: int
    psi: Any                      # per-layer (K, V), (L, 1, P, H, D) | None
    prefix_len: int
    incr: Optional[np.ndarray] = None     # (n_incr,)
    items: Optional[np.ndarray] = None    # (n_items,)
    incr_len: int = 0
    n_items: int = 0
    meta: Any = None              # UserMeta (runtime-driven path)
    payload: Any = None           # opaque runtime job state rides along
    enqueued_at: float = 0.0

    def __post_init__(self):
        if self.incr is not None:
            self.incr_len = len(self.incr)
        elif self.meta is not None and not self.incr_len:
            self.incr_len = self.meta.incr_len
        if self.items is not None:
            self.n_items = len(self.items)
        elif self.meta is not None and not self.n_items:
            self.n_items = self.meta.n_items

    @property
    def kind(self) -> str:
        return "cached" if self.psi is not None else "full"


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    max_batch: int = 8
    max_wait_ms: float = 2.0
    max_buckets_live: int = 4     # jit-cache pressure guard (warmup)


class BatchAggregator:
    """Groups compatible pending requests into executable batches.

    The default compatibility key is the rank-launch shape key
    (kind, prefix-bucket, incr-len, item-count); pass ``key`` to group
    by something else (the pre-inference aggregator keys by the
    prefill grid instead — one jitted prefill per group)."""

    def __init__(self, cfg: BatchingConfig = BatchingConfig(), key=None):
        self.cfg = cfg
        self.queues: Dict[Tuple, List[PendingRank]] = defaultdict(list)
        self.stats = {"batches": 0, "requests": 0, "max_seen_batch": 0}
        if key is not None:
            self._key = key

    def _key(self, p: PendingRank) -> Tuple:
        return (p.kind, bucket_of(p.prefix_len), p.incr_len, p.n_items)

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def depth_for(self, p: PendingRank) -> int:
        """Current queue depth of the group compatible with ``p``."""
        return len(self.queues.get(self._key(p), ()))

    def add(self, p: PendingRank, now: float) -> Optional[List[PendingRank]]:
        """Enqueue; returns a full batch if one is ready."""
        p.enqueued_at = now
        q = self.queues[self._key(p)]
        q.append(p)
        self.stats["requests"] += 1
        if len(q) >= self.cfg.max_batch:
            return self._take(self._key(p))
        return None

    def take_for(self, p: PendingRank) -> Optional[List[PendingRank]]:
        """Flush the (possibly partial) batch compatible with ``p`` now —
        the continuous-batching fast path: when a model slot is idle
        there is nothing to gain by waiting for co-batchable arrivals."""
        key = self._key(p)
        if self.queues.get(key):
            return self._take(key)
        return None

    def take_oldest(self) -> Optional[List[PendingRank]]:
        """Flush the group whose head has waited longest (slot-idle
        drain), regardless of deadline."""
        if not self.queues:
            return None
        key = min(self.queues, key=lambda k: self.queues[k][0].enqueued_at)
        return self._take(key)

    def expired(self, now: float) -> List[List[PendingRank]]:
        """Batches whose oldest member exceeded max_wait_ms (with a tiny
        epsilon so a flush timer scheduled at exactly +max_wait fires)."""
        out = []
        for key in list(self.queues):
            q = self.queues[key]
            if q and (now - q[0].enqueued_at) * 1e3 \
                    >= self.cfg.max_wait_ms - 1e-6:
                out.append(self._take(key))
        return out

    def _take(self, key) -> List[PendingRank]:
        q = self.queues.pop(key, [])
        batch = q[: self.cfg.max_batch]
        rest = q[self.cfg.max_batch:]
        if rest:
            self.queues[key] = rest
        self.stats["batches"] += 1
        self.stats["max_seen_batch"] = max(self.stats["max_seen_batch"],
                                           len(batch))
        return batch


class BatchedRankExecutor:
    """Executes a batch of rank-with-cache requests in one launch.

    psi caches are padded to the shared prefix bucket: HSTU's pointwise
    attention with explicit 1/n normalization is *not* invariant to
    zero-padding keys (zero K rows still contribute silu(0)=0 — exactly
    nothing) so right-padding K/V with zeros is mask-free and exact;
    only the n_total normalizer must use the bucket length consistently
    for every request in the batch (same value the per-request call
    would use after bucketing).
    """

    def __init__(self, model):
        self.model = model          # holds its parameters and device

    def run(self, batch: Sequence[PendingRank]):
        device = self.model.device
        bucket = bucket_of(max(p.prefix_len for p in batch))
        kv = stack_psi([p.psi for p in batch], bucket)
        incr = torch.as_tensor(np.stack([p.incr for p in batch]),
                               device=device)
        items = torch.as_tensor(np.stack([p.items for p in batch]),
                                device=device)
        scores = self.model.rank_with_cache(kv, incr, items)
        return [scores[i] for i in range(len(batch))]
