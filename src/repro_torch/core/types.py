# Copied from src/repro/core/types.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Request/lifecycle types shared by the RelayGR core.

A recommendation request flows retrieval -> pre-processing -> fine-grained
ranking.  RelayGR adds a *relay-race* side path: an auxiliary, response-
free pre-infer signal issued during retrieval.  Both the signal and the
eventual ranking request carry the user-keyed ``consistency-hash-key``
header so the affinity router lands them on the same special instance.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional, Tuple

HASH_KEY = "consistency-hash-key"


class Stage(str, enum.Enum):
    PRE_INFER = "pre-infer"
    RANK = "rank"


class CacheState(str, enum.Enum):
    PENDING = "pending"        # pre-infer admitted, compute in flight
    HBM = "hbm"                # resident in device memory (live window)
    DRAM = "dram"              # spilled to server-local DRAM
    COLD = "cold"              # demoted to host SSD / remote psi store
    EVICTED = "evicted"


class HitKind(str, enum.Enum):
    HBM_HIT = "hbm_hit"
    DRAM_HIT = "dram_hit"      # required a DRAM->HBM reload
    COLD_HIT = "cold_hit"      # revived from the cold tier this lifecycle
    MISS_FALLBACK = "miss"     # full inference on the critical path


@dataclasses.dataclass
class UserMeta:
    """Lightweight behaviour metadata the trigger inspects during
    retrieval (it never touches the full behaviour sequence)."""
    user_id: int
    prefix_len: int            # long-term behaviour tokens
    incr_len: int = 64         # short-term behaviours + cross features
    dim: int = 256             # feature/embedding dimension
    n_items: int = 512         # candidate items reaching ranking
    # beyond-prefix reuse (RcLLM): lengths of candidate-independent
    # interior segments WITHIN the incr region — behaviour runs whose
    # psi does not depend on the candidate items, so the side path can
    # compute and cache them alongside the prefix.  Empty = prefix-only
    # (the default; every non-segment workload leaves this untouched).
    # sum(seg_lens) <= incr_len; the remainder is fresh critical-path
    # tokens.
    seg_lens: Tuple[int, ...] = ()
    # multi-tenant serving: the scenario/surface this request belongs
    # to.  Tenant 0 is the default — single-tenant deployments never
    # set it and every tenant-aware code path is inert for them.
    tenant: int = 0


def reuse_spans(meta: "UserMeta"
                ) -> Optional[Tuple[Tuple[int, int], ...]]:
    """Deterministic (global_start, length) layout of a user's reusable
    spans: the prefix plus the candidate-independent interior segments,
    the latter interleaved with the fresh incr tokens (an equal fresh
    gap precedes each segment; the remainder — including the items —
    trails the last one).  Returns None for prefix-only users, so every
    non-segment path is untouched."""
    segs = tuple(int(s) for s in (meta.seg_lens or ()))
    if not segs:
        return None
    spans = []
    if meta.prefix_len:
        spans.append((0, int(meta.prefix_len)))
    fresh = max(int(meta.incr_len) - sum(segs), 0)
    gap = fresh // (len(segs) + 1)
    cursor = int(meta.prefix_len)
    for ln in segs:
        cursor += gap
        spans.append((cursor, ln))
        cursor += ln
    return tuple(spans)


@dataclasses.dataclass
class Request:
    req_id: int
    user: UserMeta
    stage: Stage
    t_arrival: float = 0.0
    header: Dict[str, Any] = dataclasses.field(default_factory=dict)
    body: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def pre_infer(cls, req_id: int, user: UserMeta, now: float = 0.0):
        """The auxiliary response-free pre-infer signal (paper §3.2)."""
        return cls(
            req_id=req_id, user=user, stage=Stage.PRE_INFER, t_arrival=now,
            header={HASH_KEY: user.user_id},
            body={"user_id": user.user_id, "stage": Stage.PRE_INFER.value},
        )

    @classmethod
    def rank(cls, req_id: int, user: UserMeta, items=None, now: float = 0.0,
             long_sequence: bool = True):
        header = {HASH_KEY: user.user_id} if long_sequence else {}
        return cls(
            req_id=req_id, user=user, stage=Stage.RANK, t_arrival=now,
            header=header,
            body={"user_id": user.user_id, "items": items},
        )


@dataclasses.dataclass
class RankResult:
    req_id: int
    user_id: int
    hit: HitKind
    scores: Any = None
    latency_ms: float = 0.0
    components: Dict[str, float] = dataclasses.field(default_factory=dict)
    instance: str = ""
