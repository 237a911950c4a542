"""Serving launcher: the end-to-end RelayGR driver (port of
``repro.launch.serve``).

``python -m repro_torch.launch.serve --requests 200`` boots a live
RelayGR service (real HSTU compute on ``--device``, ``cuda`` unless told
otherwise, attention through the CUDA kernels), replays a synthetic
request stream through the shared event-driven relay runtime —
retrieval -> trigger -> affinity routing -> ranking — and reports hit
rates + latency components.  ``--sim`` switches to the virtual-clock
cluster simulation at production QPS.  ``--batched`` swaps in the
registered ``batched`` executor: rank requests micro-batch through the
per-instance aggregator into single bucketed launches, with the bucket x
batch-size shapes warmed from the sampled arrival stream.  All modes
drive the identical ``RelayRuntime`` state machine
(repro_torch.core.runtime); only the clock and the executor differ.

``--smoke`` (the default) serves the 2-layer smoke model; ``--no-smoke``
serves the full-width configuration.  Weights are random, drawn from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (BatchingConfig, ClusterConfig, GRCostModel,
                              LiveExecutor, RelayGRService, TriggerConfig,
                              get_executor, relay_config)
from repro_torch.data.synthetic import (UserBehaviorStore, WorkloadConfig,
                                        request_stream)
from repro_torch.models import build_model, get_config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hstu-gr")
    # a boolean pair (what BooleanOptionalAction builds), spelled out so
    # each option is declared by name: --no-smoke gives full width
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    default=True,
                    help="serve the 2-layer smoke model (default)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false",
                    help="serve the full-width configuration")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live model (cuda or cpu)")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--qps", type=float, default=200.0)
    ap.add_argument("--sim", action="store_true",
                    help="cluster-scale discrete-event simulation")
    ap.add_argument("--batched", action="store_true",
                    help="live continuous micro-batching "
                         "(registered 'batched' executor)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-wait-ms", type=float, default=2.0)
    ap.add_argument("--page-tokens", type=int, default=0,
                    help=">0 stores psi in a paged HBM pool and ranks "
                         "through the rank_with_pages path")
    ap.add_argument("--segments", action="store_true",
                    help="beyond-prefix reuse: the stream attaches per-"
                         "user candidate-independent seg_lens and the "
                         "side path caches them alongside the prefix "
                         "(implies a paged window; defaults "
                         "--page-tokens to 64 when unset)")
    ap.add_argument("--device-pool", action="store_true",
                    help="keep the paged KV pool device-resident: "
                         "inserts/reloads scatter only fresh pages "
                         "(donated in-place update) and rank launches "
                         "pass the pool by reference — per-launch H2D "
                         "re-ship drops to zero (implies a paged "
                         "window; defaults --page-tokens to 64 when "
                         "unset)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="stripe the instance pools over N hosts; keyed "
                         "traffic routes owner-map -> per-host ring")
    ap.add_argument("--prefill-hosts", type=int, default=0,
                    help=">0 disaggregates the pre-infer side path onto "
                         "dedicated hosts; psi ships cross-host to its "
                         "owning rank instance over the NIC fabric")
    ap.add_argument("--cold-budget", type=float, default=0.0,
                    help=">0 adds a host-local cold tier (SSD / remote "
                         "psi store) of this many bytes under DRAM: "
                         "evictions demote instead of dropping, and a "
                         "cold-resident user's admission starts an async "
                         "cold->DRAM promotion")
    ap.add_argument("--dram-budget", type=float, default=500e9,
                    help="per-host DRAM expander budget in bytes")
    ap.add_argument("--tenants", type=int, default=1,
                    help=">1 serves N tenants off the one fleet: every "
                         "memory tier is partitioned into per-tenant "
                         "byte/page quotas (a tenant can only evict its "
                         "own entries), admission gets per-tenant token "
                         "buckets, and stats report per-tenant ledgers")
    args = ap.parse_args(argv)
    if (args.segments or args.device_pool) and not args.page_tokens:
        args.page_tokens = 64  # segment spans / device pool need pages
    return args


def main(argv=None):
    args = parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke and not args.sim)
    cost = GRCostModel(get_config(args.arch))

    if args.sim:
        from repro_torch.serving.simulator import run_sim
        store = UserBehaviorStore()
        arr = request_stream(store, args.qps, args.requests / args.qps,
                             segments=args.segments, tenants=args.tenants)
        s = run_sim(relay_config(
            trigger=TriggerConfig(n_instances=10),
            cluster=ClusterConfig(hosts=args.hosts,
                                  prefill_hosts=args.prefill_hosts,
                                  page_tokens=args.page_tokens,
                                  segments=args.segments,
                                  device_pool=args.device_pool,
                                  dram_budget_bytes=args.dram_budget,
                                  cold_budget_bytes=args.cold_budget,
                                  tenants=args.tenants)),
            cost, arr)
        print(json.dumps(s, indent=1))
        return s

    # live mode: real PyTorch compute, small instance pool
    model = build_model(cfg, device=resolve_device(args.device))
    model.init(torch.Generator().manual_seed(0))
    store = UserBehaviorStore(WorkloadConfig(
        vocab=cfg.vocab, n_items=64, incr_len=16, len_mu=6.8, len_sigma=0.9,
        max_len=2048))
    # a paged window preallocates its pool buffer up front (that is the
    # point: fixed pages, zero fragmentation) — bound it to a host-
    # friendly size for the local smoke instead of the 16 GB default
    hbm_bytes = 128e6 if args.page_tokens else 16e9
    relay_cfg = relay_config(
        trigger=TriggerConfig(n_instances=4, r2=0.5,
                              rank_p99_budget_ms=20.0),
        cluster=ClusterConfig(max_batch=args.max_batch if args.batched
                              else 0,
                              batch_wait_ms=args.batch_wait_ms,
                              page_tokens=args.page_tokens,
                              segments=args.segments,
                              device_pool=args.device_pool,
                              hosts=args.hosts,
                              prefill_hosts=args.prefill_hosts,
                              hbm_cache_bytes=hbm_bytes,
                              dram_budget_bytes=args.dram_budget,
                              cold_budget_bytes=args.cold_budget,
                              tenants=args.tenants))

    def report(results):
        hits, lat = {}, []
        for r in results:
            assert abs(r.latency_ms - sum(r.components.values())) < 1e-6
            hits[r.hit.value] = hits.get(r.hit.value, 0) + 1
            lat.append(r.components["rank"])
        print(f"requests={len(results)} hits={hits}")
        print(f"rank compute ms: p50={np.percentile(lat, 50):.1f} "
              f"p99={np.percentile(lat, 99):.1f}")
        return hits

    def report_tenants(svc):
        if args.tenants <= 1:
            return
        ten = svc.stats()["tenants"]
        print(json.dumps({"tenants": ten}, indent=1))
        # isolation invariants the live smoke leans on: every tenant's
        # admission ledger saw traffic, and no tenant ever evicted
        # another tenant's entry out of any tier
        assert ten["cross_tenant_evictions"] == 0, (
            f"tenant partition violated: "
            f"{ten['cross_tenant_evictions']} cross-tenant evictions")
        assert all(ten["admission"].get(t, {}).get("assessed", 0) > 0
                   for t in range(args.tenants)), (
            "per-tenant admission ledger not populated: "
            f"{ten['admission']}")

    def report_h2d(svc):
        if not args.page_tokens:
            return
        h2d = svc.stats()["h2d"]
        print(json.dumps({"h2d": h2d}, indent=1))
        if args.device_pool:
            # the whole point of the device-resident pool: rank
            # launches pass the pool by reference, so a single re-ship
            # is a wiring regression
            assert h2d["device_resident"], "device pool not wired"
            assert h2d["launch_reships"] == 0, (
                f"device-pool launch re-shipped the pool "
                f"{h2d['launch_reships']}x")
            assert h2d["bytes_scattered"] > 0

    if args.batched:
        # one shared executor across the pool; warm the (bucket, batch)
        # grid the sampled stream will actually hit
        ex = get_executor("batched")(
            model, store, cost=cost,
            batching=BatchingConfig(max_batch=args.max_batch,
                                    max_wait_ms=args.batch_wait_ms),
            page_tokens=args.page_tokens, segments=args.segments,
            device_pool=args.device_pool)
        arrivals = []
        for i, (t, meta) in enumerate(request_stream(
                store, args.qps, 1e9, refresh_prob=0.2,
                segments=args.segments, tenants=args.tenants)):
            if i >= args.requests:
                break
            arrivals.append((t, meta))
        pool_pages = 0
        if args.page_tokens:
            # the executor owns the page geometry; deriving the pool
            # size from ITS layout warms rank_with_pages at the serving
            # store's pool shape
            pool_pages = (int(relay_cfg.cluster.hbm_cache_bytes)
                          // ex.page_layout.page_bytes)
        warmed = ex.warmup([m.prefix_len for _, m in arrivals],
                           batch_sizes=range(1, args.max_batch + 1),
                           incr_len=store.cfg.incr_len,
                           n_items=store.cfg.n_items,
                           pool_pages=pool_pages)
        print(f"warmed {len(warmed)} (bucket, batch) launch shapes: "
              f"{sorted({k[:2] for k in warmed})}")
        svc = RelayGRService(relay_cfg, cost,
                             executor_factory=lambda name: ex)
        results = []
        rt = svc.runtime
        for t, meta in arrivals:
            rt.schedule(t, "arrival", meta=meta, sink=results.append)
        rt.drain()
        hits = report(results)
        batch = {n: i.batcher.stats for n, i in svc.instances.items()
                 if i.batcher is not None and i.batcher.stats["requests"]}
        print(json.dumps({"batch": batch}, indent=1))
        report_tenants(svc)
        report_h2d(svc)
        return hits
    svc = RelayGRService(
        relay_cfg, cost,
        executor_factory=lambda name: LiveExecutor(
            model, store, page_tokens=args.page_tokens,
            segments=args.segments, device_pool=args.device_pool))
    results = []
    for i, (t, meta) in enumerate(request_stream(
            store, args.qps, 1e9, refresh_prob=0.2,
            segments=args.segments, tenants=args.tenants)):
        if i >= args.requests:
            break
        results.append(svc.submit(meta, now=t))
    hits = report(results)
    print(json.dumps(svc.stats()["trigger"], indent=1))
    if args.prefill_hosts:
        print(json.dumps({"shipping": svc.stats()["shipping"]}, indent=1))
    if args.cold_budget:
        print(json.dumps({"cold": svc.stats()["cold"]}, indent=1))
    report_tenants(svc)
    report_h2d(svc)
    return hits


if __name__ == "__main__":
    main()
