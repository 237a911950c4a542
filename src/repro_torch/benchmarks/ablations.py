# Copied from benchmarks/ablations.py (numpy-only): only module paths are renamed repro -> repro_torch, benchmarks -> repro_torch.benchmarks.
"""Component ablations: each RelayGR mechanism removed in turn.

Shows each of the paper's three techniques is load-bearing:
  no-trigger   -> admit everything: special pool overloads (P99 blows);
  no-affinity  -> random special routing: producer/consumer miss, ranking
                  falls back to full inference (the paper's Fig.12 point);
  no-singleflight -> rapid same-user bursts trigger redundant reloads.

The first two now demonstrate the runtime's policy registry: the ablated
variant is just a different ``trigger_policy`` / ``router_policy`` string
in the ``ClusterConfig`` — no engine code changes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core import (ClusterConfig, GRCostModel, RelayGRService,
                        TriggerConfig, relay_config)
from repro_torch.core.types import HitKind, UserMeta
from repro_torch.models import get_config

COST = GRCostModel(get_config("hstu_gr"))


def _metas(n=400, L=4096, seed=0):
    rng = np.random.default_rng(seed)
    return [UserMeta(user_id=int(rng.integers(0, 10**9)), prefix_len=L)
            for _ in range(n)]


def ablation_affinity() -> List[Tuple]:
    """Affinity on vs off (``router_policy="random"``: the pre-infer
    producer and the ranking consumer land on independent random special
    instances, so they rendezvous only by chance)."""
    rows = []
    for policy in ("affinity", "random"):
        svc = RelayGRService(
            relay_config(trigger=TriggerConfig(n_instances=10, r2=0.5),
                         cluster=ClusterConfig(router_policy=policy,
                                               seed=1)),
            COST)
        hits = 0
        metas = _metas()
        for i, meta in enumerate(metas):
            sig = svc.on_retrieval(meta, now=i * 0.01)
            if sig is not None:
                svc.deliver_pre_infer(sig, now=i * 0.01)
            r = svc.on_rank(meta, now=i * 0.01 + 1e-3)
            hits += r.hit in (HitKind.HBM_HIT, HitKind.DRAM_HIT)
        rate = hits / len(metas)
        rows.append((f"ablation/{policy}-routing", rate * 1e6,
                     f"hit_rate={rate:.2f}"))
    return rows


def ablation_trigger() -> List[Tuple]:
    """Selective admission vs unconditional pre-inference (paper §2.4
    challenge 3: pre-inferring every request overloads the shared
    resources that ranking needs).  Realistic mixed-length traffic at
    high QPS: the ``sequence-aware`` trigger pre-infers only the ~10%
    at-risk requests; ``admit-all`` floods the special pool with
    pre-inference for *safe* short-sequence users.  Rank-stage routing
    uses the true risk test in both variants (``route_trigger``), so
    only the admission policy differs."""
    from repro_torch.core.trigger import SequenceAwareTrigger
    from repro_torch.data.synthetic import UserBehaviorStore, request_stream
    from repro_torch.serving.simulator import ClusterSim
    rows = []
    store = UserBehaviorStore()
    for label, policy in (("selective-trigger", "sequence-aware"),
                          ("admit-all", "admit-all")):
        trig = TriggerConfig(n_instances=5, r2=0.4)
        sim = ClusterSim(
            relay_config(trigger=trig,
                         cluster=ClusterConfig(hbm_cache_bytes=4e9,
                                               trigger_policy=policy)),
            COST)
        sim.runtime.route_trigger = SequenceAwareTrigger(trig, COST)
        s = sim.run(request_stream(store, 900, 12.0))
        rows.append((f"ablation/{label}", s["p99_ms"] * 1e3,
                     f"p99={s['p99_ms']:.0f}ms succ={s['success_rate']:.3f} "
                     f"special_util={s['special_util']:.2f}"))
    return rows


def ablation_single_flight() -> List[Tuple]:
    """Pseudo-pre-infer dedup vs naive per-request reloads."""
    from repro_torch.core import DRAMExpander, ExpanderConfig, HBMCacheStore
    from repro_torch.core.cache import CacheEntry
    hbm = HBMCacheStore(10**12)
    exp = DRAMExpander(ExpanderConfig())
    exp.spill(CacheEntry(7, "psi", 10, 0.0, prefix_len=4096))
    burst = 8
    actions = [exp.pseudo_pre_infer(7, hbm, 0.0)[0] for _ in range(burst)]
    reloads = actions.count("reload")
    return [("ablation/single-flight", reloads,
             f"{reloads} reload for {burst}-req burst "
             f"(naive: {burst}; redundant_avoided="
             f"{exp.stats['redundant_avoided']})")]


ALL_ABLATIONS = [ablation_affinity, ablation_trigger,
                 ablation_single_flight]
