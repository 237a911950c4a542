"""The one traffic generator: a traffic file's parameters and a seed in,
the requests of a run out.

Its pieces are copies of ``repro_torch.data.synthetic``: the Zipf token
law of ``UserBehaviorStore._zipf_tokens`` and the homogeneous Poisson
arrivals of ``arrival_times("poisson", ...)``.  The prefix lengths are
drawn from the file's length law by stratified sampling: each request's
length is the law's quantile at a uniform draw inside its own stratum
of (0, 1), so every request follows the law exactly while the strata
keep the run's mix of lengths the same from seed to seed.

Traffic file keys:

* ``loop``: ``open`` (arrivals at ``rate_per_s``, by the law
  ``arrivals`` names: ``poisson``) or ``closed`` (``callers`` that each
  send the next request when the last one's scores arrive).
* ``prefix``: ``{"law": "log_uniform", "lo", "hi"}`` or
  ``{"law": "log_normal", "mu", "sigma", "lo", "hi"}`` (truncated to
  [lo, hi]).
* ``block``: > 0 stratifies the lengths in blocks of that many
  consecutive requests, each block holding every stratum once, so that
  a stretch of the window does not depend on the seed's luck (0: the
  whole run's strata in one permutation).
* ``incr_len``, ``n_items``: short-term tokens and candidates a request.
* ``drain_s``: how long after the window's close a run waits for the
  answers that were due in it.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from types import SimpleNamespace
from typing import Dict, List

import numpy as np


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a salt."""
    s = int(seed)
    return np.random.default_rng(np.random.SeedSequence(
        [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, int(s < 0), salt]))


def zipf_tokens(rng: np.random.Generator, n: int, vocab: int) -> np.ndarray:
    """Inverse-CDF Zipf over [0, vocab) (``UserBehaviorStore``'s law)."""
    u = rng.random(n)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64)
    return np.clip(ranks - 1, 0, vocab - 1).astype(np.int32)


def length_quantile(law: dict, u: np.ndarray) -> np.ndarray:
    lo, hi = float(law["lo"]), float(law["hi"])
    if law["law"] == "log_uniform":
        return lo * (hi / lo) ** u
    if law["law"] == "log_normal":
        nd = NormalDist(float(law["mu"]), float(law["sigma"]))
        a, b = nd.cdf(math.log(lo)), nd.cdf(math.log(hi))
        return np.exp([nd.inv_cdf(a + (b - a) * x) for x in u])
    raise ValueError(f"unknown length law {law['law']!r}")


def strata(n: int, block: int, rng: np.random.Generator) -> np.ndarray:
    """n stratified uniform draws of (0, 1) in the seed's order: one in
    each of n equal strata, or, with ``block`` > 0, one in each of
    ``block`` strata for every block of ``block`` consecutive
    requests."""
    k = n if block <= 0 else block
    nb = -(-n // k)
    u = np.concatenate([rng.permutation(k) for _ in range(nb)])[:n]
    return (u + rng.random(n)) / k


def prefix_lengths(law: dict, n: int, rng: np.random.Generator,
                   block: int = 0) -> np.ndarray:
    """n prefix lengths drawn from the law at ``strata``."""
    lens = np.floor(length_quantile(law, strata(n, block, rng)))
    return np.clip(lens, int(law["lo"]), int(law["hi"])).astype(int)


def poisson_arrivals(rate: float, seconds: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson arrival times in (0, seconds) at ``rate``
    (``data.synthetic._poisson_arrivals``)."""
    out, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= seconds:
            return np.asarray(out)
        out.append(t)


class TrafficStore:
    """The behaviour store handed to the program's executor: the tokens
    of every user of the run, made by the benchmark from the seed.  It
    answers the three calls the executor makes (``long_term``,
    ``short_term``, ``candidates``) and keeps ``cfg.incr_len`` and
    ``cfg.n_items``, as ``UserBehaviorStore`` does."""

    def __init__(self, incr_len: int, n_items: int):
        self.cfg = SimpleNamespace(incr_len=int(incr_len),
                                   n_items=int(n_items))
        self._long: Dict[int, np.ndarray] = {}
        self._short: Dict[int, np.ndarray] = {}
        self._items: Dict[int, np.ndarray] = {}

    def add(self, uid: int, long: np.ndarray, short: np.ndarray,
            items: np.ndarray) -> None:
        self._long[uid], self._short[uid], self._items[uid] = \
            long, short, items

    def long_term(self, user_id: int, length=None) -> np.ndarray:
        return self._long[int(user_id)]

    def short_term(self, user_id: int, trial: int = 0) -> np.ndarray:
        return self._short[int(user_id)]

    def candidates(self, user_id: int, trial: int = 0,
                   n_items=None) -> np.ndarray:
        return self._items[int(user_id)]


@dataclasses.dataclass
class Request:
    index: int
    user_id: int
    prefix_len: int
    offset_s: float            # arrival, from the window's open


def make_users(store: TrafficStore, lens: np.ndarray, vocab: int,
               rng: np.random.Generator, first_uid: int) -> List[int]:
    """Tokens for one user per length, drawn in one call; returns the
    user ids (consecutive from ``first_uid``)."""
    inc, items = store.cfg.incr_len, store.cfg.n_items
    per = np.asarray(lens, np.int64) + inc + items
    toks = zipf_tokens(rng, int(per.sum()), vocab)
    uids, at = [], 0
    for i, n in enumerate(lens):
        n = int(n)
        uid = first_uid + i
        store.add(uid, toks[at:at + n], toks[at + n:at + n + inc],
                  toks[at + n + inc:at + n + inc + items])
        at += n + inc + items
        uids.append(uid)
    return uids


def generate(traffic: dict, seed: int, seconds: float, vocab: int,
             rate: float = None, callers_pool: int = 0):
    """(store, requests) of one run.  Open loop: the window's arrivals.
    Closed loop: a pool of ``callers_pool`` users whose lengths follow
    the law, taken in order as the callers ask."""
    rng = seed_rng(seed, 1)
    store = TrafficStore(traffic["incr_len"], traffic["n_items"])
    first_uid = int(seed_rng(seed, 2).integers(1, 2 ** 30))
    block = int(traffic.get("block", 0))
    if traffic["loop"] == "open":
        if traffic.get("arrivals", "poisson") != "poisson":
            raise ValueError(f"unknown arrival law {traffic['arrivals']!r}")
        offs = poisson_arrivals(rate or traffic["rate_per_s"], seconds, rng)
    else:
        offs = np.zeros(callers_pool)
    lens = prefix_lengths(traffic["prefix"], len(offs), rng, block)
    uids = make_users(store, lens, vocab, seed_rng(seed, 3), first_uid)
    reqs = [Request(i, u, int(n), float(t))
            for i, (u, n, t) in enumerate(zip(uids, lens, offs))]
    return store, reqs


def warm_users(store: TrafficStore, lengths, vocab: int) -> List[int]:
    """Users of the given lengths for warming prefill shapes up (ids
    below any run's users)."""
    return make_users(store, np.asarray(list(lengths)), vocab,
                      np.random.default_rng(0), first_uid=-len(lengths))
