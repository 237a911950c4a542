# Copied from src/repro/data/synthetic.py (numpy-only): only module paths are renamed repro -> repro_torch.
"""Synthetic user-behaviour data substrate.

Deterministic, hash-seeded per-user behaviour streams mirroring the
paper's workload description (§4.1): most users have short histories,
<6% exceed 2K tokens (long-sequence users); items follow a Zipf
popularity law.  Used by the serving engine (behaviour fetch for
pre-inference), the trainer (next-item prediction batches) and the
benchmarks (request generators).

Request-level workload layer (the capacity harness substrate):

  * ``ZipfPopularity`` — WHO arrives: a multi-million-user *request
    popularity* sampler (skew ``s=0`` is uniform; ``s>0`` draws user
    ranks from a bounded Zipf(s) law, so a head of hot users recurs
    within cache lifetimes and hit rates finally depend on footprint
    pressure instead of pinning at 100%);
  * ``arrival_times`` — WHEN they arrive: pluggable arrival processes
    (homogeneous Poisson, diurnal sinusoid via Lewis–Shedler thinning,
    MMPP-style two-state bursty), all normalized to a mean offered QPS;
  * ``capacity_stream`` — the composition: a timed
    ``(t, UserMeta)`` stream that feeds ``ClusterSim.run`` unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.types import UserMeta


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_users: int = 1_000_000
    vocab: int = 100_000
    zipf_a: float = 1.2
    # behaviour-length distribution: log-normal, calibrated so ~6% of
    # users exceed 2K tokens (paper §4.1)
    len_mu: float = 6.2          # median ~ e^6.2 ~ 490 tokens
    len_sigma: float = 0.95
    max_len: int = 32_768
    incr_len: int = 64
    n_items: int = 512
    dim: int = 256


class UserBehaviorStore:
    def __init__(self, cfg: WorkloadConfig = WorkloadConfig()):
        self.cfg = cfg

    def _rng(self, user_id: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([user_id & 0x7FFFFFFF, salt]))

    def prefix_len(self, user_id: int) -> int:
        rng = self._rng(user_id, 1)
        ln = int(np.exp(rng.normal(self.cfg.len_mu, self.cfg.len_sigma)))
        return int(np.clip(ln, 8, self.cfg.max_len))

    def meta(self, user_id: int) -> UserMeta:
        return UserMeta(user_id=user_id,
                        prefix_len=self.prefix_len(user_id),
                        incr_len=self.cfg.incr_len,
                        n_items=self.cfg.n_items,
                        dim=self.cfg.dim)

    def _zipf_tokens(self, rng: np.random.Generator, n: int) -> np.ndarray:
        # inverse-CDF Zipf over [0, vocab)
        u = rng.random(n)
        ranks = np.floor(np.exp(u * np.log(self.cfg.vocab))).astype(np.int64)
        return np.clip(ranks - 1, 0, self.cfg.vocab - 1).astype(np.int32)

    def long_term(self, user_id: int, length: Optional[int] = None
                  ) -> np.ndarray:
        n = length or self.prefix_len(user_id)
        return self._zipf_tokens(self._rng(user_id, 2), n)

    def short_term(self, user_id: int, trial: int = 0) -> np.ndarray:
        return self._zipf_tokens(self._rng(user_id, 100 + trial),
                                 self.cfg.incr_len)

    def candidates(self, user_id: int, trial: int = 0,
                   n_items: Optional[int] = None) -> np.ndarray:
        return self._zipf_tokens(self._rng(user_id, 10_000 + trial),
                                 n_items or self.cfg.n_items)

    # --- training pipeline ----------------------------------------------------
    def train_batches(self, batch_size: int, seq_len: int, *,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Next-item-prediction batches over synthetic behaviour streams."""
        rng = np.random.default_rng(seed)
        while True:
            uids = rng.integers(0, self.cfg.n_users, size=batch_size)
            toks = np.stack([
                np.resize(self.long_term(int(u), max(seq_len + 1, 16)),
                          seq_len + 1)
                for u in uids])
            yield {"tokens": toks[:, :-1].astype(np.int32),
                   "labels": toks[:, 1:].astype(np.int32)}


# ---------------------------------------------------------------------------
# beyond-prefix segments (candidate-independent incr spans)
# ---------------------------------------------------------------------------


def segment_lens(user_id: int, incr_len: int, *, salt: int = 7,
                 max_segments: int = 2) -> Tuple[int, ...]:
    """Deterministic per-user candidate-independent segment lengths
    inside the incr region (RcLLM beyond-prefix reuse).  Drawn from a
    dedicated hash-seeded RNG keyed on the user id — NEVER from a
    stream's arrival/popularity RNG — so enabling segments leaves every
    existing trace's draws untouched.  Total segment mass is 40–75% of
    ``incr_len`` split across 1..``max_segments`` runs; the remainder
    stays fresh critical-path tokens."""
    if incr_len < 8:
        return ()
    rng = np.random.default_rng(
        np.random.SeedSequence([user_id & 0x7FFFFFFF, 7000 + salt]))
    k = int(rng.integers(1, max_segments + 1))
    total = int(incr_len * rng.uniform(0.4, 0.75))
    if total < k:
        return ()
    if k > 1:
        cuts = np.sort(rng.integers(1, total, size=k - 1))
    else:
        cuts = np.array([], dtype=np.int64)
    parts = np.diff(np.concatenate([[0], cuts, [total]]))
    return tuple(int(p) for p in parts if p > 0)


# ---------------------------------------------------------------------------
# request popularity (WHO arrives)
# ---------------------------------------------------------------------------


class ZipfPopularity:
    """Request-level user-popularity sampler over a ``population`` of
    user ids: rank-``r`` user receives a share of traffic ``∝ r^-skew``
    (bounded continuous Zipf, inverse-CDF sampled — O(1) per draw even
    for multi-million populations).  ``skew=0`` degenerates to the
    uniform draw the legacy benchmark streams used, where a repeat user
    is a once-in-a-billion event and HBM hit rates pin at 100%; real
    recommendation traffic is heavily head-skewed, which is what makes
    hit rate / P99 curves move with footprint pressure.

    The rank -> user-id mapping is the identity (popular users are the
    low ids); every consumer of a user id hashes it (rendezvous owner
    map, per-host rings, behaviour-store seeds), so contiguity carries
    no placement bias.
    """

    def __init__(self, population: int, skew: float = 0.0):
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        if skew < 0:
            raise ValueError(f"skew must be >= 0, got {skew}")
        self.population = int(population)
        self.skew = float(skew)

    def cdf(self, rank: float) -> float:
        """Analytic share of requests landing on the top-``rank`` users
        (continuous bounded-Zipf CDF) — used by the statistical skew
        tests and by capacity reports to label workload head-heaviness."""
        n, s = self.population, self.skew
        rank = min(max(float(rank), 1.0), float(n))
        if n == 1:
            return 1.0
        if abs(s - 1.0) < 1e-9:
            return np.log(rank) / np.log(n)
        return (rank ** (1.0 - s) - 1.0) / (n ** (1.0 - s) - 1.0)

    def tail_share(self, rank: float) -> float:
        """Analytic share of requests landing BEYOND the top-``rank``
        users (1 - cdf): the fraction of traffic from the long tail a
        head-sized cache cannot hold — capacity reports use this to
        label how much load the sub-DRAM tiers are responsible for."""
        return 1.0 - self.cdf(rank)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """Draw ``n`` user ids (int64 array)."""
        u = rng.random(n)
        pop, s = self.population, self.skew
        if pop == 1:
            ranks = np.ones(n)
        elif abs(s - 1.0) < 1e-9:
            ranks = np.exp(u * np.log(pop))
        else:
            ranks = (1.0 + u * (pop ** (1.0 - s) - 1.0)) ** (1.0 / (1.0 - s))
        ids = np.floor(ranks).astype(np.int64) - 1
        return np.clip(ids, 0, pop - 1)

    def sample_one(self, rng: np.random.Generator) -> int:
        return int(self.sample(rng, 1)[0])


# ---------------------------------------------------------------------------
# arrival processes (WHEN they arrive)
# ---------------------------------------------------------------------------


def _poisson_arrivals(qps: float, duration_s: float,
                      rng: np.random.Generator) -> Iterator[float]:
    t = 0.0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= duration_s:
            return
        yield t


def _diurnal_arrivals(qps: float, duration_s: float,
                      rng: np.random.Generator, *, amp: float = 0.6,
                      period_s: float = 10.0) -> Iterator[float]:
    """Sinusoidal rate modulation ``λ(t) = qps·(1 + amp·sin(2πt/T))``
    via Lewis–Shedler thinning (exact for any bounded λ).  The mean
    rate over whole periods is ``qps``; the peak is ``(1+amp)·qps`` —
    a compressed diurnal cycle so a 12 s sim sees both the trough and
    the crest of a day."""
    if not 0.0 <= amp < 1.0:
        raise ValueError(f"diurnal amp must be in [0, 1), got {amp}")
    lam_max = qps * (1.0 + amp)
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= duration_s:
            return
        lam_t = qps * (1.0 + amp * np.sin(2.0 * np.pi * t / period_s))
        if rng.random() * lam_max <= lam_t:
            yield t


def _mmpp_arrivals(qps: float, duration_s: float,
                   rng: np.random.Generator, *, low: float = 0.3,
                   high: float = 1.7, dwell_s: float = 1.0
                   ) -> Iterator[float]:
    """Two-state Markov-modulated Poisson process: the rate alternates
    between ``low·qps`` and ``high·qps`` with exponential dwell times
    (equal mean dwell in each state, so the stationary mean rate is
    ``(low+high)/2 · qps`` — keep ``low+high == 2`` to offer ``qps`` on
    average).  This is the bursty workload: multi-second on/off surges
    that queue the rank pool far beyond what Poisson at the same mean
    produces."""
    if low < 0 or high < low:
        raise ValueError(f"need 0 <= low <= high, got {low}, {high}")
    t, hot = 0.0, bool(rng.random() < 0.5)
    t_switch = rng.exponential(dwell_s)
    while True:
        rate = qps * (high if hot else low)
        # draw the next arrival in the current state; a state switch
        # before it invalidates the draw (memorylessness: redraw)
        gap = rng.exponential(1.0 / rate) if rate > 0 else float("inf")
        if t + gap >= t_switch:
            t = t_switch
            hot = not hot
            t_switch = t + rng.exponential(dwell_s)
            if t >= duration_s:
                return
            continue
        t += gap
        if t >= duration_s:
            return
        yield t


ARRIVAL_PROCESSES = {
    "poisson": _poisson_arrivals,
    "diurnal": _diurnal_arrivals,
    "mmpp": _mmpp_arrivals,
}


def arrival_times(process: str, qps: float, duration_s: float, *,
                  rng: np.random.Generator, **kw) -> Iterator[float]:
    """Arrival-time generator for one of ``ARRIVAL_PROCESSES`` (mean
    offered rate ``qps`` over ``duration_s`` seconds)."""
    try:
        fn = ARRIVAL_PROCESSES[process]
    except KeyError:
        raise ValueError(
            f"unknown arrival process {process!r}; "
            f"known: {sorted(ARRIVAL_PROCESSES)}") from None
    if qps <= 0:
        return iter(())
    return fn(qps, duration_s, rng, **kw)


def capacity_stream(L: int, qps: float, duration_s: float, *,
                    skew: float = 0.0, population: int = 2_000_000,
                    arrival: str = "poisson", seed: int = 0,
                    dim: int = 256, n_items: int = 512,
                    incr_len: int = 64, arrival_kw: Optional[Dict] = None,
                    segments: bool = False, tenant: int = 0
                    ) -> Iterator[Tuple[float, UserMeta]]:
    """The capacity-harness request stream: WHO (Zipf(skew) popularity
    over ``population`` users) × WHEN (a named arrival process at mean
    ``qps``), at a fixed request profile (prefix ``L``, ``n_items``
    candidates).  Yields ``(t, UserMeta)`` and feeds ``ClusterSim.run``
    unchanged.  ``segments=True`` attaches per-user candidate-
    independent ``seg_lens`` from a separate hash RNG; ``tenant``
    stamps every request with a tenant id — neither consumes any
    stream RNG draw, so the arrival and popularity sequences are
    identical either way."""
    rng = np.random.default_rng(seed)
    pop = ZipfPopularity(population, skew)
    for t in arrival_times(arrival, qps, duration_s, rng=rng,
                           **(arrival_kw or {})):
        uid = pop.sample_one(rng)
        segs = segment_lens(uid, incr_len) if segments else ()
        yield t, UserMeta(user_id=uid, prefix_len=L, incr_len=incr_len,
                          dim=dim, n_items=n_items, seg_lens=segs,
                          tenant=int(tenant))


#: user-id stride between tenant workloads in ``multi_tenant_stream``:
#: far above any per-tenant ``population``, so tenants can never share
#: a cache key (the isolation guarantee starts at the workload layer)
TENANT_UID_STRIDE = 100_000_000


def multi_tenant_stream(mixes, duration_s: float, *, seed: int = 0
                        ) -> Iterator[Tuple[float, UserMeta]]:
    """Per-tenant traffic mixes merged into ONE timed request stream.

    ``mixes[i]`` is a dict of ``capacity_stream`` keyword args for
    tenant ``i`` — each tenant gets its own offered load, skew, prefix
    length and arrival process (e.g. tenant A steady Poisson, tenant B
    an MMPP burst for the isolation bench).  Isolation discipline:

      * every tenant draws from its OWN seeded RNG (``seed + 1000·i``
        unless the mix pins ``seed``), so one tenant's draw order can
        never perturb another's arrivals or popularity;
      * user ids live in DISJOINT per-tenant spaces (offset by
        ``i · TENANT_UID_STRIDE``) — tenants never share cache keys.

    Yields globally time-ordered ``(t, UserMeta)`` with
    ``UserMeta.tenant`` set, ready for ``RelayRuntime.run``."""
    import heapq

    def tagged(i: int, kw: Dict) -> Iterator[Tuple[float, UserMeta]]:
        kw = dict(kw)
        kw.setdefault("seed", seed + 1000 * i)
        kw["tenant"] = i
        for t, meta in capacity_stream(duration_s=duration_s, **kw):
            yield t, dataclasses.replace(
                meta, user_id=meta.user_id + i * TENANT_UID_STRIDE)

    return heapq.merge(*(tagged(i, kw) for i, kw in enumerate(mixes)),
                       key=lambda tm: tm[0])


def request_stream(store: UserBehaviorStore, qps: float, duration_s: float,
                   *, seed: int = 0, refresh_prob: float = 0.0,
                   refresh_horizon: int = 256, long_only: bool = False,
                   min_len: int = 0, segments: bool = False,
                   tenants: int = 1
                   ) -> Iterator[Tuple[float, UserMeta]]:
    """Poisson arrivals; with probability ``refresh_prob`` a request is a
    rapid-refresh repeat of a recent user (drives DRAM-tier reuse).
    ``segments=True`` attaches hash-derived per-user ``seg_lens``
    without consuming any stream RNG draws.  ``tenants > 1`` assigns
    each request a deterministic tenant (``user_id % tenants`` — a pure
    function of the id, no RNG draw), so the same trace replays
    identically with tenancy on or off."""
    rng = np.random.default_rng(seed)
    t = 0.0
    recent: list = []
    while t < duration_s:
        t += rng.exponential(1.0 / qps)
        if recent and rng.random() < refresh_prob:
            uid = int(rng.choice(recent[-refresh_horizon:]))
        else:
            uid = int(rng.integers(0, store.cfg.n_users))
            if min_len and store.prefix_len(uid) < min_len:
                continue
        recent.append(uid)
        m = store.meta(uid)
        if segments:
            m = dataclasses.replace(
                m, seg_lens=segment_lens(uid, m.incr_len))
        if tenants > 1:
            m = dataclasses.replace(m, tenant=uid % int(tenants))
        yield t, m
