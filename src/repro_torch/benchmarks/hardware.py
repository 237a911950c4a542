"""An H100 ``HardwareModel``: the accelerator terms of the cost model,
fitted to the port's executors as measured on the card.

    python -m repro_torch.benchmarks.hardware [--device cuda] [--no-smoke]
        [--lens 1024,2048,...] [--out build/h100_hardware.json]

The reference prices every simulated latency with a ``HardwareModel``
whose constants mirror an Ascend 910C-class instance
(``core/costmodel.py``).  This module measures the card instead:

* ``measure`` times ``LiveExecutor.pre_infer`` (``pre_infer_ms``),
  ``rank_cached`` (``rank_on_cache_ms``) and ``rank_full``
  (``full_rank_ms``: prefill + rank) at the simulator's request shape —
  64 incr tokens and 512 items (``data/synthetic.WorkloadConfig``) — and
  prefix lengths ``LENS`` (Fig. 11a's).  The launches replay CUDA graphs,
  the serve default; each time is the median of ``turns`` device-
  synchronized calls after a warm-up call and the capture.  It also
  times a pinned host-to-device copy of a psi at ``H2D_LENS`` tokens.
* ``fit`` sets ``h2d_bw`` from the copies and ``eff_flops`` by least
  squares through the origin, ``t - h2d_ms(n) = forward_flops /
  eff_flops``, over every op and length, on the relative error of the
  predicted time; it reports each point's error.  The model has no
  per-launch term, so short prefixes, where launches dominate, may miss.
  ``host_feature_ms`` is not subtracted: the live executor does no CPU
  feature processing, and the model adds it on top.
* Every other term — host, fabric and cold store (``KEPT``) — keeps the
  reference's value: those are the host's and the network's, not the
  card's.  ``hbm_bw`` prices nothing the simulator runs.

The table (``build/h100_hardware.json`` unless ``--out``) records the
device; ``load`` returns its ``HardwareModel`` and refuses a table
measured on the CPU or on the smoke model unless ``allow_cpu``.  A CPU
run (``--device cpu``, the smoke model) exercises the path, not the
numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import BUILD
from repro_torch.benchmarks._card import describe, sync
from repro_torch.core.costmodel import GRCostModel, HardwareModel

LENS = (1024, 2048, 3072, 4096, 6144, 8192, 12288, 16384)  # LENS_11A
N_INCR, N_ITEMS = 64, 512
H2D_LENS = (2048, 16384)
OPS = ("pre_infer", "rank_cached", "rank_full")
FITTED = ("eff_flops", "h2d_bw")
KEPT = ("hbm_bw", "net_bw", "net_rtt_ms", "nic_bw", "cold_bw",
        "cold_rtt_ms", "host_feature_ms", "embed_bytes_per_token")
OUT = BUILD / "h100_hardware.json"


def _model(device, smoke: bool):
    from repro_torch.models import build_model, get_config
    cfg = get_config("hstu_gr", smoke=smoke)
    return build_model(cfg, device=device).init(
        torch.Generator().manual_seed(0))


def measure_h2d(device, cost: GRCostModel, lens: Sequence[int] = H2D_LENS,
                turns: int = 5) -> List[Dict]:
    """Host-to-device copy of a psi of each length from pinned memory:
    bytes and the median ms of ``turns`` synchronized copies."""
    out = []
    for L in lens:
        nbytes = cost.kv_bytes(L)
        host = torch.empty(nbytes, dtype=torch.uint8,
                           pin_memory=device.type == "cuda")
        host.fill_(1)
        dst = torch.empty(nbytes, dtype=torch.uint8, device=device)
        times = []
        for _ in range(turns + 1):              # the first warms the path
            sync(device)
            t0 = time.perf_counter()
            dst.copy_(host, non_blocking=True)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({"L": int(L), "bytes": int(nbytes),
                    "ms": statistics.median(times[1:])})
    return out


def measure(device="cuda", smoke: bool = False,
            lens: Sequence[int] = LENS, turns: int = 5) -> Dict:
    """Time the three executor ops at each prefix length and the psi
    copies; returns ``{"points", "h2d", "meta"}`` for ``fit``."""
    from repro_torch.core import LiveExecutor, UserMeta
    from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig

    device = resolve_device(device)
    model = _model(device, smoke)
    store = UserBehaviorStore(WorkloadConfig(
        vocab=model.cfg.vocab, incr_len=N_INCR, n_items=N_ITEMS))
    ex = LiveExecutor(model, store)
    points = []
    for i, L in enumerate(lens):
        meta = UserMeta(user_id=1000 + i, prefix_len=int(L),
                        incr_len=N_INCR, n_items=N_ITEMS)
        psi = ex.pre_infer(meta)[0]
        calls = {"pre_infer": lambda: ex.pre_infer(meta)[2],
                 "rank_cached": lambda: ex.rank_cached(meta, psi)[1],
                 "rank_full": lambda: ex.rank_full(meta)[1]}
        for op in OPS:                          # warm-up, then the capture
            calls[op]()
            calls[op]()
        times = {op: [] for op in OPS}
        for t in range(turns):                  # in turns, order alternating
            for op in (OPS if t % 2 == 0 else OPS[::-1]):
                times[op].append(calls[op]())
        for op in OPS:
            points.append({"op": op, "L": int(L),
                           "ms": statistics.median(times[op]),
                           "turns": times[op]})
        del psi
    h2d = measure_h2d(device, GRCostModel(model.cfg), turns=turns)
    return {"points": points, "h2d": h2d, "meta": {
        "device": describe(device), "model": model.cfg.name,
        "smoke": smoke, "graphs": ex.graphs is not None,
        "incr_len": N_INCR, "n_items": N_ITEMS, "turns": turns}}


def _terms(cost: GRCostModel, op: str, L: int) -> Tuple[float, float]:
    """(forward FLOPs, H2D ms) of one op as ``GRCostModel`` prices it."""
    q = N_INCR + N_ITEMS
    if op == "pre_infer":
        return cost.forward_flops(L), cost.h2d_ms(L)
    if op == "rank_cached":
        return cost.forward_flops(q, n_ctx=L + q), cost.h2d_ms(q)
    if op == "rank_full":
        return cost.forward_flops(L + q), cost.h2d_ms(L + q)
    raise ValueError(f"unknown op {op!r}; known: {OPS}")


def _origin_fit(x: Sequence[float], y: Sequence[float],
                t: Sequence[float]) -> float:
    """The slope a of y = a x that minimizes sum(((a x - y) / t)^2)."""
    x, y, w = (np.asarray(v, dtype=np.float64) for v in (x, y, t))
    w = 1.0 / w ** 2
    return float((w * x * y).sum() / (w * x * x).sum())


def fit(points: Sequence[Dict], h2d: Sequence[Dict], cfg=None
        ) -> Tuple[HardwareModel, List[Dict]]:
    """The ``HardwareModel`` whose ``h2d_bw`` and ``eff_flops`` fit the
    measured copies and op times of ``cfg`` (default: full ``hstu-gr``),
    every other term the reference's; and each op point's measured and
    predicted ms (the model's op time less ``host_feature_ms``, which
    the measurement does not contain) with its relative error."""
    if cfg is None:
        from repro_torch.models import get_config
        cfg = get_config("hstu_gr")
    ms = [p["ms"] for p in h2d]
    h2d_bw = 1e3 / _origin_fit([p["bytes"] for p in h2d], ms, ms)
    hw = dataclasses.replace(HardwareModel(), h2d_bw=h2d_bw)
    cost = GRCostModel(cfg, hw)
    terms = [_terms(cost, p["op"], p["L"]) for p in points]
    ts = [p["ms"] for p in points]
    inv = _origin_fit([f for f, _ in terms],
                      [t - h for (_, h), t in zip(terms, ts)], ts)
    hw = dataclasses.replace(hw, eff_flops=1e3 / inv)
    rows = []
    for p, (flops, h) in zip(points, terms):
        pred = flops / hw.eff_flops * 1e3 + h
        rows.append({"op": p["op"], "L": p["L"], "ms": p["ms"],
                     "pred_ms": pred, "rel_err": (pred - p["ms"]) / p["ms"]})
    return hw, rows


def table(measured: Dict) -> Dict:
    """The table ``load`` reads: the fitted model, the fit's points and
    the measurement's record."""
    from repro_torch.models import get_config
    cfg = get_config("hstu_gr", smoke=measured["meta"]["smoke"])
    hw, rows = fit(measured["points"], measured["h2d"], cfg)
    meta = dict(measured["meta"])
    meta.update(fitted=list(FITTED), kept=list(KEPT), note=(
        "eff_flops and h2d_bw are fitted to this device; the kept terms "
        "are the host's, the fabric's and the cold store's, and keep the "
        "reference's values (hbm_bw prices nothing the simulator runs)"))
    return {"hardware": dataclasses.asdict(hw), "fit": rows,
            "h2d": measured["h2d"], "points": measured["points"],
            "meta": meta}


def read(path) -> Dict:
    with open(path) as f:
        tab = json.load(f)
    if "hardware" not in tab or "meta" not in tab:
        raise ValueError(f"{path}: not a hardware table (python -m "
                         "repro_torch.benchmarks.hardware writes one)")
    return tab


def load(path, allow_cpu: bool = False) -> HardwareModel:
    """The ``HardwareModel`` of a table ``main`` wrote.  A table measured
    on the CPU, or on the smoke model, prices nothing real: refused
    unless ``allow_cpu``."""
    tab = read(path)
    meta = tab["meta"]
    if (meta["device"]["platform"] != "gpu" or meta["smoke"]) \
            and not allow_cpu:
        raise ValueError(
            f"{path} was measured on {meta['device']['name']} with the "
            f"{meta['model']} model; a HardwareModel must be measured on "
            "the card at full width (--no-smoke; allow_cpu=True only to "
            "exercise the path)")
    return HardwareModel(**tab["hardware"])


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (cuda or cpu)")
    ap.add_argument("--no-smoke", dest="smoke", action="store_false",
                    help="the full-width hstu-gr (default: the smoke model)")
    ap.add_argument("--lens", default=",".join(map(str, LENS)),
                    help="comma-separated prefix lengths")
    ap.add_argument("--turns", type=int, default=5)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    lens = [int(x) for x in args.lens.split(",")]
    tab = table(measure(args.device, args.smoke, lens, args.turns))
    print(json.dumps({"device": tab["meta"]["device"],
                      "eff_flops": tab["hardware"]["eff_flops"],
                      "h2d_bw": tab["hardware"]["h2d_bw"]}))
    print("op,L,ms,pred_ms,rel_err")
    for r in tab["fit"]:
        print(f"{r['op']},{r['L']},{r['ms']:.4f},{r['pred_ms']:.4f},"
              f"{r['rel_err']:+.4f}")
    for r in tab["h2d"]:
        print(f"h2d,{r['L']},{r['ms']:.4f},bytes={r['bytes']}")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(tab, indent=1, sort_keys=True))
    print(f"# wrote {out}")
    return tab


if __name__ == "__main__":
    main()
