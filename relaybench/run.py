#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 relaybench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Set-up builds what ``python -m repro_torch.launch.serve --no-smoke
--batched --device-pool`` builds (a ``RelayGRService`` over one shared
``BatchedLiveExecutor``, with CUDA graphs or, where the configuration's
``relay.graphs`` is false, eager launches as ``--no-graphs`` gives them),
with the relay settings of the cell's configuration file and weights
drawn from the seed on the card, and warms every launch shape the
cell's traffic uses.  The window then runs the traffic on the host's
monotonic clock: each arrival is dispatched at its due time and no
runtime event before its timestamp.
A request's rank latency runs from its rank request's due time (the
arrival plus the pipeline's retrieval and pre-processing) to the moment
its scores reach the sink on the host.

After the window every answer due in it is awaited (``drain_s`` at most),
the device's peak memory is read, the program is freed, and a sample of
the answers drawn from the seed (the longest prefix among them) is
compared with the plain reference (``reference.py``).

With ``--trace 1`` the window runs under ``torch.profiler`` and the run
reports the cell's per-layer metrics; with ``--trace 0`` its end-to-end
metrics.  The last line on standard output is the result; the last
lines on standard error give each number compared beside its limit.

Options the check never passes, for the benchmark's own tools:
``--rate`` (the open loop's rate, for the knee sweep), ``--control
tf32`` (the control: the reference in TF32 put in the program's place,
its scores judged as the program's answers are, so that a sound harness
reports the run not correct), ``--out FILE`` (the run's details as
JSON).
"""

from __future__ import annotations

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import heapq  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SAMPLE = 12          # answers compared with the reference a run
SAMPLE_MISSES = 3    # of which full ranks, where the run has them


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--out", default=None)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    kernel library itself builds into ``build/kernels``)."""
    base = root / "build" / "relaybench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Run:
    """What a run leaves for the metric readers (``metrics/*.py``)."""

    def __init__(self, cfg, traffic, seed, seconds, trace):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.setup_parts = {}
        self.requests = []          # dicts, one per request of the window
        self.counters = {}          # "open" / "close" snapshots
        self.launches = []          # executor calls (traced runs)
        self.kernels = []           # device operations, copies included:
                                    # (name, start_us, end_us) (traced runs)
        self.busy_s = None          # any device operation running
        self.kernel_busy_s = None   # a kernel running (copies left out)
        self.window_s = None
        self.breakdown = None
        self.checks = {}
        self.correct = False


def counters(svc, runner) -> dict:
    inst = svc.instances.values()
    rank = [i.batcher.stats for i in inst if i.batcher is not None]
    pre = [i.pre_batcher.stats for i in inst
           if getattr(i, "pre_batcher", None) is not None]
    trig = svc.runtime.trigger.stats
    return {
        "rank_batches": sum(s["batches"] for s in rank),
        "rank_requests": sum(s["requests"] for s in rank),
        "pre_batches": sum(s["batches"] for s in pre),
        "pre_requests": sum(s["requests"] for s in pre),
        "assessed": trig["assessed"], "admitted": trig["admitted"],
        "lazy_captures": runner.captures["lazy"] if runner else 0,
        "warmup_captures": runner.captures["warmup"] if runner else 0,
    }


def record_launches(ex, run, flops, max_batch, clock):
    """Spans around the executor's two group entry points (traced runs):
    each call's shapes and its host interval on the runtime's clock,
    inside a ``relay.*`` profiler range."""
    import torch
    pre, rank = ex.pre_infer_group, ex.rank_group

    def pre_group(metas):
        t0 = clock()
        with torch.profiler.record_function("relay.exec.pre_infer_group"):
            out = pre(metas)
        n = flops.grid(max(m.prefix_len for m in metas))
        run.launches.append({
            "kind": "pre", "t0": t0, "t1": clock(), "n": n,
            "members": [n] * len(metas),
            "rows": flops.batch_grid(len(metas), max_batch)})
        return out

    def rank_group(group):
        t0 = clock()
        with torch.profiler.record_function("relay.exec.rank_group"):
            out = rank(group)
        miss = group[0].psi is None
        b = flops.bucket(max(w.prefix_len for w in group))
        members = [b if miss else flops.grid(w.prefix_len) for w in group]
        rows = flops.batch_grid(len(group), max_batch)
        run.launches.append({
            "kind": "full" if miss else "paged", "t0": t0, "t1": clock(),
            "n": b, "members": members,
            "rows_prefix": members + [members[0]] * (rows - len(group)),
            "rows": rows})
        return out

    ex.pre_infer_group, ex.rank_group = pre_group, rank_group


def plant_fault(ex, fault: str):
    """Break the timed path underneath the harness (the harness's own
    tests): ``alter`` changes one answer where it is produced, ``half``
    leaves out the second half of every batch (its rows answered with
    the first member's scores)."""
    rank = ex.rank_group

    def broken(group):
        scores, ms = rank(group)
        if fault == "alter":
            scores = [s.clone() for s in scores]
            scores[0][0] += 1.0 + scores[0].abs().max()
        elif fault == "half":
            keep = max(1, (len(scores) + 1) // 2)
            scores = scores[:keep] + [scores[0]] * (len(scores) - keep)
        return scores, ms

    ex.rank_group = broken


def pump(rt, until: float, late_log=None, labels=False) -> bool:
    """Dispatch the runtime's events on the wall clock until ``until``
    (runtime clock seconds) or until none are left; True when none are
    left.  An event is dispatched at its timestamp or later, never
    before.  ``late_log`` receives (arrival event's due time, dispatch
    time)."""
    import torch
    ev, clock = rt.events, rt.clock
    while ev:
        t = ev[0][0]
        now = clock.now()
        if now >= until:
            return False
        if t > now:
            wait = min(t, until) - now
            if labels:
                with torch.profiler.record_function("relay.wait"):
                    _sleep(wait)
            else:
                _sleep(wait)
            continue
        t, _, kind, kw = heapq.heappop(ev)
        rt.now = t
        rt.clock.advance(t)
        if late_log is not None and kind == "arrival":
            late_log.append((t, now))
        handler = getattr(rt, f"_on_{kind}")
        if labels:
            with torch.profiler.record_function(f"relay.{kind}"):
                handler(t, **kw)
        else:
            handler(t, **kw)
    return True


def _sleep(wait: float) -> None:
    """Sleep to within a millisecond of the target, then spin."""
    if wait > 2e-3:
        time.sleep(wait - 1e-3)


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             trace: bool = False, device: str = "cuda",
             rate: float = None, control: str = None,
             fault: str = None) -> Run:
    import numpy as np
    import torch

    from relaybench import flops, reference, traffic as gen, weights
    from repro_torch.core import (BatchingConfig, ClusterConfig,
                                  GRCostModel, RelayGRService,
                                  TriggerConfig, get_executor, relay_config)
    from repro_torch.core.graphs import resolve_runner
    from repro_torch.core.types import UserMeta
    from repro_torch.models import build_model, get_config

    run = Run(cfg, traffic, seed, seconds, trace)
    parts = run.setup_parts
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t = time.monotonic()
    parts["imports_s"] = t - T_PROCESS
    sizes = cfg["model"]
    relay = cfg["relay"]
    cl = relay["cluster"]
    store, reqs = gen.generate(traffic, seed, seconds, sizes["vocab"],
                               rate=rate,
                               callers_pool=traffic.get("pool", 0))
    parts["traffic_s"] = time.monotonic() - t

    t = time.monotonic()
    mcfg = dataclasses.replace(get_config(sizes["arch"]), **{
        k: v for k, v in sizes.items() if k != "arch"})
    model = build_model(mcfg, device=dev)
    w = weights.make(sizes, seed, dev)
    weights.load(model, w)
    sync()
    parts["weights_s"] = time.monotonic() - t

    t = time.monotonic()
    if cuda:
        from repro_torch.kernels import cuda_lib
        cuda_lib.library()
    parts["kernel_library_s"] = time.monotonic() - t

    t = time.monotonic()
    cost = GRCostModel(mcfg)
    runner = resolve_runner(None if relay.get("graphs", True) else False,
                            dev)
    batching = BatchingConfig(max_batch=cl["max_batch"],
                              max_wait_ms=cl["batch_wait_ms"])
    ex = get_executor("batched")(
        model, store, cost=cost, batching=batching,
        page_tokens=cl["page_tokens"], segments=False,
        device_pool=cl["device_pool"],
        graphs=runner if runner is not None else False)
    svc = RelayGRService(relay_config(
        trigger=TriggerConfig(**relay["trigger"]),
        cluster=ClusterConfig(**cl)), cost,
        executor_factory=lambda name: ex)
    rt = svc.runtime
    parts["service_s"] = time.monotonic() - t

    # warm up: serve.py's call over the traffic's prefix lengths and
    # every batch size, then the prefill at batch 1: with graphs, each
    # prefill shape of the traffic is captured; eager launches build
    # nothing a shape, and one pre-infer at the longest length grows the
    # allocator to its peak
    t = time.monotonic()
    pools = [i.hbm.pool for i in svc.instances.values()
             if hasattr(i.hbm, "pool")]
    lens = [r.prefix_len for r in reqs]
    ex.warmup(lens, batch_sizes=range(1, cl["max_batch"] + 1),
              incr_len=traffic["incr_len"], n_items=traffic["n_items"],
              pools=pools)
    sync()
    parts["warmup_rank_s"] = time.monotonic() - t
    t = time.monotonic()
    grid_lens = sorted({flops.grid(n) for n in lens})
    if runner is None:
        grid_lens = grid_lens[-1:]
    uids = gen.warm_users(store, grid_lens, sizes["vocab"])
    for uid, n in zip(uids, grid_lens):
        ex.pre_infer_group([UserMeta(user_id=uid, prefix_len=n,
                                     incr_len=traffic["incr_len"],
                                     n_items=traffic["n_items"],
                                     dim=sizes["d_model"])])
    sync()
    parts["warmup_prefill_s"] = time.monotonic() - t
    parts["prefill_shapes"] = len(grid_lens)
    if runner is not None:
        parts["graphs"] = runner.captures["warmup"] + runner.captures["lazy"]
    if cuda:
        parts["pool_bytes"] = sum(
            p.device_buffer.numel() * p.device_buffer.element_size()
            for p in pools if getattr(p, "device_buffer", None) is not None)
        torch.cuda.reset_peak_memory_stats(dev)

    if fault:
        plant_fault(ex, fault)
    if trace:
        record_launches(ex, run, flops, cl["max_batch"], rt.clock.now)

    pp = rt.cfg.pipeline
    rank_delay = (pp.retrieval_ms + pp.preprocess_ms) / 1e3
    done = {}

    def meta(r):
        return UserMeta(user_id=r.user_id, prefix_len=r.prefix_len,
                        incr_len=traffic["incr_len"],
                        n_items=traffic["n_items"], dim=sizes["d_model"])

    def sink_for(i):
        def sink(result):
            done[i] = (rt.clock.now(), result)
            if closed:
                issue()
        return sink

    closed = traffic["loop"] == "closed"
    issued = []                          # (request, arrival time)
    late = []

    def issue(at=None):
        now = rt.clock.now()
        if closed and (now >= t_close or len(issued) >= len(reqs)):
            return
        r = reqs[len(issued)]
        ta = now if at is None else at
        issued.append((r, ta))
        rt.schedule(ta, "arrival", meta=meta(r), sink=sink_for(r.index))

    # the window
    prof = None
    if trace:
        from relaybench import trace as tr
        prof = tr.profiler()
        prof.__enter__()
        win = torch.profiler.record_function("relay.window")
        win.__enter__()
    t_open = rt.clock.now() + 0.05
    t_close = t_open + seconds
    run.setup_s = (time.monotonic() - T_PROCESS) + (t_open - rt.clock.now())
    if closed:
        for _ in range(int(traffic["callers"])):
            issue(at=t_open)
    else:
        for r in reqs:
            issue(at=t_open + r.offset_s)
    run.counters["open"] = None
    while rt.clock.now() < t_open:
        pass
    run.counters["open"] = counters(svc, runner)
    pump(rt, t_close, late, labels=trace)
    run.counters["close"] = counters(svc, runner)
    if prof is not None:
        sync()
        win.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    drained = pump(rt, t_close + float(traffic.get("drain_s", 60.0)))
    sync()
    run.drained = drained
    run.t_open, run.t_close = t_open, t_close

    for r, ta in issued:
        d = done.get(r.index)
        run.requests.append({
            "index": r.index, "user_id": r.user_id,
            "prefix_len": r.prefix_len, "arrival": ta,
            "due": ta + rank_delay,
            "done": d[0] if d else None,
            "hit": d[1].hit.value if d else None})
    run.late = [now - due for due, now in late]
    run.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                             if cuda else 0)
    if prof is not None:
        from relaybench import trace as tr
        kernels, host = tr.intervals(prof)
        w0, w1 = next((a, b) for n, a, b in host if n == "relay.window")
        run.kernels = [k for k in kernels if k[2] > w0 and k[1] < w1]
        run.window_s = (w1 - w0) * 1e-6
        run.busy_s = tr.busy_s(run.kernels)
        run.kernel_busy_s = tr.busy_s(
            [k for k in run.kernels if not tr.is_copy(k[0])])
        run.breakdown = {"device_ops": tr.top_ops(run.kernels),
                         "idle_gaps": tr.idle_gaps(run.kernels, host,
                                                   w0, w1)}
        del prof

    # the sample, its inputs and the program's answers, then the program
    # is freed before the reference runs
    rng = gen.seed_rng(seed, 5)
    ok = [q for q in run.requests if q["done"] is not None]
    sample = []
    if ok:
        sample.append(max(ok, key=lambda q: (q["prefix_len"], q["index"])))
        for want, k in ((lambda q: q["hit"] == "miss", SAMPLE_MISSES),
                        (lambda q: True, SAMPLE)):
            pool = [q for q in ok if want(q) and q not in sample]
            take = rng.permutation(len(pool))[:max(0, min(
                k, SAMPLE - len(sample)))]
            sample += [pool[i] for i in sorted(take)]
    inputs = []
    for q in sample:
        uid, plen = q["user_id"], q["prefix_len"]
        n = flops.bucket(plen) if q["hit"] == "miss" else flops.grid(plen)
        inputs.append((np.resize(store.long_term(uid), n),
                       flops.bucket(plen), store.short_term(uid),
                       store.candidates(uid),
                       done[q["index"]][1].scores.float().cpu()))
    del svc, rt, ex, model, runner, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # with a control, its scores take the program's place
    t = time.monotonic()
    ref = reference.Reference(w, sizes)
    low = reference.Reference(w, sizes, precision=control) \
        if control else None
    gaps = []
    for prefix, rank_pos, incr, items, got in inputs:
        args = [torch.as_tensor(a, device=dev)
                for a in (prefix, incr, items)]
        want = ref.scores(args[0], rank_pos, *args[1:]).cpu()
        if low is not None:
            got = low.scores(args[0], rank_pos, *args[1:]).cpu()
        gaps.append(reference.gap(got, want))
    run.reference_s = time.monotonic() - t
    run.sample = [(q["prefix_len"], q["hit"], g)
                  for q, g in zip(sample, gaps)]
    limits = cfg["limits"]
    failed = sum(q["done"] is None for q in run.requests)
    run.checks = {
        "score_gap": {"value": max(gaps, default=float("inf")),
                      "limit": limits["score_gap"]},
        "unanswered": {"value": failed, "limit": 0},
        "compared": {"value": len(inputs), "limit_at_least": 1},
    }
    run.correct = (bool(inputs) and failed == 0
                   and run.checks["score_gap"]["value"]
                   <= limits["score_gap"])
    run.attempted, run.failed = len(run.requests), failed
    return run


def result(run: Run, metrics, device_info: dict) -> dict:
    from relaybench import spec
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": spec.read_metrics(metrics, run),
           "device": device_info}
    if run.trace:
        out["device"]["busy_s"] = run.busy_s
        out["device"]["window_s"] = run.window_s
        out["breakdown"] = run.breakdown
    out["checks"] = run.checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    from relaybench import spec
    bench = spec.benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    cfg = spec.config(cell["config"])
    # the allocator's settings are the deployment's: set before torch
    for var, val in cfg.get("env", {}).items():
        os.environ[var] = val
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"relaybench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    traffic = spec.traffic(cell["traffic"])
    metrics = spec.metrics_of(bench, args.workload, bool(args.trace))
    run = run_cell(cfg, traffic, args.seed, args.seconds,
                   trace=bool(args.trace), rate=args.rate,
                   control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"relaybench: the run loaded {bad}", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = result(run, metrics, info)
    print(json.dumps({"setup_parts": run.setup_parts,
                      "reference_s": run.reference_s,
                      "sample": run.sample,
                      "drained": run.drained,
                      "control": args.control}))
    if args.out:
        details = {"requests": run.requests, "late": run.late,
                   "window": [run.t_open, run.t_close],
                   "counters": run.counters, "launches": run.launches,
                   "result": out, "setup_parts": run.setup_parts,
                   "sample": run.sample}
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(details))
    for name, c in run.checks.items():
        lim = c.get("limit", c.get("limit_at_least"))
        print(f"check {name} {c['value']} limit {lim}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
