"""Quickstart: the RelayGR relay in 50 lines (port of
``examples/quickstart.py``).

Builds the HSTU GR backbone, pre-infers a user's long-term behaviour
prefix (psi), relays it through the HBM sliding-window cache, and
scores candidates with ``rank_with_cache`` — asserting the paper's
epsilon-equivalence against full inference — then prints the window's
stats ledger (the same unified counter family every cache tier
reports: inserts / live / evictions / handoffs + extras).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
on the card; ``--device cpu`` for the CPU.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.cache import HBMCacheStore, kv_nbytes
from repro_torch.models import get_model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    args = ap.parse_args(argv)

    model = get_model("hstu-gr", smoke=True, device=args.device).init(
        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a, device=model.device)

    # a user's behaviour stream: long-term prefix | short-term | candidates
    prefix = on(rng.integers(0, 500, (1, 128)))
    incr = on(rng.integers(0, 500, (1, 16)))
    items = on(rng.integers(0, 500, (1, 32)))

    # 1) relay-race side path (during retrieval): pre-infer psi
    _, psi = model.prefill({"tokens": prefix})
    print(f"psi: per-layer KV cache, {kv_nbytes(psi) / 2**20:.2f} MiB for "
          f"128 tokens")

    # 2) the relay baton: psi waits in the HBM sliding window until the
    #    ranking request arrives (T_life-bounded in production)
    window = HBMCacheStore(budget_bytes=64 * 2 ** 20)
    window.insert(user_id=1, value=psi, nbytes=kv_nbytes(psi), now=0.0,
                  prefix_len=prefix.shape[1])
    psi_cached = window.lookup(1).value
    window.consume(1)                   # ranking takes the baton

    # 3) fine-grained ranking (later, same instance): reuse psi
    scores_relay = model.rank_with_cache(psi_cached, incr, items)

    # 4) the paper's correctness contract: |relay - full| <= eps
    scores_full = model.full_rank(prefix, incr, items)
    err = (scores_relay - scores_full).abs().max().item()
    print(f"scores: {tuple(scores_relay.shape)}, |relay - full| = {err:.2e}")
    assert err < 1e-4
    print("relay-race inference == full inference (eps-bound holds)")

    # 5) the window's ledger: the unified counter family (inserts == live
    #    + evictions + handoffs)
    print("hbm window ledger:",
          {k: window.stats[k] for k in ("inserts", "hits", "misses",
                                        "evictions", "handoffs")},
          f"live={window.live_count}")
    return err


if __name__ == "__main__":
    main()
