# Port of examples/cluster_capacity.py: module paths renamed repro ->
# repro_torch, and the body runs from main() so that importing the
# module runs nothing.
"""Capacity planning with the paper's admission-control equations.

Sweeps the trigger knobs (r1, r2, M, T_life) and prints the derived
live-cache cap L, per-instance admitted QPS and pool-wide Q_max
(Eqs. 1-3), validates the chosen operating point in the discrete-event
cluster simulator, then rebuilds the same point with the full memory
hierarchy (HBM window -> DRAM expander -> cold store) under a
rapid-refresh stream and prints the unified per-tier stats ledger —
every tier reports the same counter core (inserts / live / evictions /
handoffs [+ demotions / promotions]), so the table reads as one
conserved flow down and back up the hierarchy.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_capacity
"""
import numpy as np

from repro_torch.core import (ClusterConfig, GRCostModel,
                              SequenceAwareTrigger, TriggerConfig, UserMeta,
                              relay_config)
from repro_torch.data.synthetic import UserBehaviorStore, request_stream
from repro_torch.models import get_config
from repro_torch.serving.simulator import ClusterSim, run_sim


def main() -> None:
    cost = GRCostModel(get_config("hstu-gr"))
    print("r1   M   T_life   L(cap)  Q_admit/inst  Q_max(pool)")
    for r1 in (0.25, 0.5):
        for m in (3, 5):
            for t_life in (0.2, 0.4):
                cfg = TriggerConfig(r1=r1, m_slots=m, t_life_s=t_life)
                trig = SequenceAwareTrigger(cfg, cost)
                s = trig.summary()
                print(f"{r1:.2f} {m:3d} {t_life:6.1f}   "
                      f"{s['live_cache_cap_L']:7.0f} "
                      f"{s['q_admit_per_instance']:12.0f} "
                      f"{s['q_max_pool']:12.0f}")

    print("\nvalidating r1=0.5, M=5 at 300 QPS in the cluster sim:")
    store = UserBehaviorStore()
    arr = request_stream(store, 300, 15.0)
    s = run_sim(relay_config(trigger=TriggerConfig(n_instances=10)), cost,
                arr)
    print({k: round(v, 3) for k, v in s.items() if k in
           ("p99_ms", "success_rate", "goodput_qps", "hbm_hit", "miss")})

    # --- the full memory hierarchy under tail pressure ----------------------
    # Small HBM window + small DRAM expander + big cold store, driven by a
    # 90%-recurring pool wider than both warm tiers: psi demotes down the
    # hierarchy on LRU pressure and promotes back on return visits.
    print("\nmemory hierarchy (HBM -> DRAM -> cold) under a recurring pool:")
    trig = TriggerConfig(n_instances=5, r2=0.8, t_life_s=0.5, kv_p99_len=4096,
                         hbm_bytes=4e9, r1=0.5,
                         q_m=1e3 / cost.pre_infer_ms(3072))
    sim = ClusterSim(relay_config(trigger=trig, cluster=ClusterConfig(
        hbm_cache_bytes=300e6, dram_budget_bytes=150e6,
        cold_budget_bytes=400e9)), cost)
    rng = np.random.default_rng(7)
    pool, t, arrivals = [1000 + i for i in range(60)], 0.0, []
    for _ in range(400):
        t += rng.exponential(1 / 60.0)
        uid = (int(rng.choice(pool)) if rng.random() < 0.9
               else int(rng.integers(0, 10 ** 9)))
        arrivals.append((t, UserMeta(user_id=uid, prefix_len=2048)))
    summary = sim.run(iter(arrivals))
    print({k: round(summary[k], 3)
           for k in ("hbm_hit", "dram_hit", "cold_hit", "miss")})

    stats = sim.runtime.stats()
    CORE = ("inserts", "live", "evictions", "demotions", "handoffs",
            "promotions")
    print(f"\n{'tier':<16}" + "".join(f"{c:>11}" for c in CORE))
    for name, inst in stats["instances"].items():
        for tier in ("hbm", "dram"):
            row = inst[tier]
            print(f"{name}/{tier:<{16 - len(name) - 1}}"
                  + "".join(f"{row.get(c, 0):>11}" for c in CORE))
    for host, row in stats["cold"]["stores"].items():
        print(f"{host}/cold      "
              + "".join(f"{row.get(c, 0):>11}" for c in CORE))
    ledger = {k: v for k, v in stats["cold"].items() if k != "stores"}
    print("\ncold runtime ledger:", ledger)


if __name__ == "__main__":
    main()
