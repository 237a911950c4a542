#!/usr/bin/env python3
"""Sweep a cell's open-loop traffic over a list of rates, one fresh
process a probe, and report where the backlog starts to grow.

    python3 relaybench/knee.py --workload relay-over.hstu-gr \
        --rates 6,8,10,12 --seconds 20 --seed 1000 --out knee.json

Each probe runs ``run.py`` with ``--rate`` and reads its details: the
median and 95th percentile of rank latency, the requests still in
flight when the window closed (``backlog``), and the median latency of
the window's last quarter of arrivals over its first (``trend``).  A
rate is sustained when every answer came, the trend stays under 1.5
and the backlog under half a second of arrivals; the knee is the highest
sustained rate, and ``p95_ok`` says whether its 95th percentile met the
50 ms rank budget too.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from relaybench import readers  # noqa: E402


def probe(workload: str, rate: float, seconds: float, seed: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "probe.json"
        p = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload", workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace", "0",
             "--rate", str(rate), "--out", str(out)],
            capture_output=True, text=True)
        if p.returncode != 0 or not out.exists():
            return {"rate": rate, "seed": seed, "error": p.stderr[-2000:]}
        d = json.loads(out.read_text())
    reqs = d["requests"]
    close = d["window"][1]
    lat = [(q["done"] - q["due"]) * 1e3 for q in reqs
           if q["done"] is not None]
    quarter = max(1, len(reqs) // 4)

    def med(qs):
        v = [(q["done"] - q["due"]) * 1e3 for q in qs
             if q["done"] is not None]
        return statistics.median(v) if v else float("inf")

    backlog = sum(q["arrival"] < close and (q["done"] is None
                                            or q["done"] >= close)
                  for q in reqs)
    trend = med(reqs[-quarter:]) / max(med(reqs[:quarter]), 1e-9)
    unanswered = sum(q["done"] is None for q in reqs)
    return {
        "rate": rate, "seed": seed, "requests": len(reqs),
        "p50_ms": readers.percentile(lat, 0.5),
        "p95_ms": readers.percentile(
            lat + [float("inf")] * unanswered, 0.95),
        "backlog": backlog, "trend": trend, "unanswered": unanswered,
        "sustained": (unanswered == 0 and trend < 1.5
                      and backlog <= rate * 0.5 + 2),
        "correct": d["result"]["correct"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    probes = []
    for i, r in enumerate(float(x) for x in args.rates.split(",")):
        p = probe(args.workload, r, args.seconds, args.seed + i)
        probes.append(p)
        print(json.dumps(p), flush=True)
    ok = [p for p in probes if p.get("sustained")]
    knee = max(ok, key=lambda p: p["rate"]) if ok else None
    summary = {"workload": args.workload, "seconds": args.seconds,
               "knee_per_s": knee and knee["rate"],
               "p95_ok": bool(knee and knee["p95_ms"] <= 50.0),
               "probes": probes}
    print(json.dumps({k: v for k, v in summary.items() if k != "probes"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
