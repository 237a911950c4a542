# Port of benchmarks/check_regression.py: module paths renamed repro ->
# repro_torch, benchmarks -> repro_torch.benchmarks; the committed files
# the defaults name are found at the repository root, and only read.
"""Serving-perf regression gate: candidate run vs the committed headline.

``python -m repro_torch.benchmarks.check_regression --candidate
build/BENCH_relay.json`` compares a fresh ``repro_torch.benchmarks.run``
headline against the committed ``BENCH_relay.json`` per mode and FAILS
(exit 1) with a readable per-mode diff when any metric regresses past
its stated tolerance:

  * latency  — ``p99_ms`` / ``rank_p99_ms`` may rise at most
    ``--latency-tol`` (default 5%): the fixed-point run (L=2048,
    60 QPS) is a seeded virtual-clock sim at full duration even under
    ``--quick``, so this bound is tight;
  * hit rates — ``hbm_hit`` / ``dram_hit`` / ``miss`` must stay within
    ``--hit-tol`` (default 0.02) absolute of the committed values;
  * throughput — ``slo_qps`` must reach ``--qps-floor`` of the
    committed value.  The full-precision bisection warrants the default
    0.85; ``--quick`` lowers it to 0.55 because the CI smoke bisects
    coarsely (~30% tolerance) over 4 s sims;
  * cross-mode — ``relay_paged`` must keep ``relay_batched``'s HBM hit
    rate (same trigger, same byte budget: paging may not cost
    admissions) and the COMMITTED file must hold their ``slo_qps``
    within 5% of each other, the paged-window acceptance bound;
  * cold tier — ``relay_cold`` must strictly beat ``relay_segments``
    on the tail-probe reuse fraction (hbm + dram + cold at 1.15x the
    segments knee) and hold >= 95% of its committed ``slo_qps``; on
    the committed capacity matrix every skewed POISSON cell's
    ``relay_cold`` knee must be >= the ``relay_batched`` knee (the
    Zipf-tail lift; MMPP knees carry burst-phase noise larger than
    the lift and are gated by the knee floor only);
  * multi-tenant — ``relay_tenants`` must keep ``relay_batched``'s
    hit rates within 2% absolute (the equal-share partition of a
    symmetric trace is near-free) and its committed ``slo_qps``
    within 10%; the capacity headline's ``isolation`` record must
    show tenant B's MMPP burst moving neither tenant A's hit rate
    (``--hit-tol``) nor A's SLO knee (``--iso-knee-tol``, 10%).

Replaces the old sanity-only ``slo_qps >= 0.8 * relay`` check: every
mode is now gated against its own committed trajectory, so a perf
regression in any deployment flavour fails CI instead of rotting
silently in an artifact.

Capacity gating (``--capacity-candidate``): a fresh
``python -m repro_torch.benchmarks.capacity`` headline is diffed against the
committed ``BENCH_capacity.json`` over the intersection of matrix
cells — per-cell knee QPS must reach ``--qps-floor`` of the committed
knee, and every POISSON cell's goodput must rise monotonically up to
its knee (a goodput dip below the knee means admission is collapsing
before saturation — a scheduler bug, not a tolerance matter; under
MMPP the dip inference doesn't hold, see ``compare_capacity``).

Both gates refuse (exit 2, distinct from a regression's exit 1) to
diff headlines produced under different workloads: the meta blocks
must agree on provenance (seed/horizon/arrival/workload for the relay
headline; seed/population/slo_ms for capacity), a ``--quick``
capacity file is never accepted as the committed reference, and a
capacity candidate whose meta lacks the ``quick`` flag entirely is
refused as schema drift (the gate cannot pick tolerances for a file
that won't say whether it is a smoke run).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.benchmarks import ROOT

GATED_LATENCY = ("p99_ms", "rank_p99_ms")
GATED_HITS = ("hbm_hit", "dram_hit", "cold_hit", "miss")

#: BENCH_relay.json meta fields that pin the workload a headline was
#: measured under; two headlines disagreeing on any of these are
#: different experiments, and diffing them is refused outright
RELAY_PROVENANCE = ("L", "offered_qps", "slo_ms", "seed", "horizon",
                    "arrival", "workload")


class ProvenanceMismatch(Exception):
    """Raised when two headlines were measured under different
    workloads — the diff would compare apples to oranges."""


def check_provenance(reference: dict, candidate: dict,
                     fields=RELAY_PROVENANCE, *, label: str = "") -> None:
    """Refuse to diff headlines with mismatched workload provenance.

    Only fields the *reference* meta actually carries are enforced, so
    the gate stays usable against pre-provenance committed files; a
    field the reference has but the candidate lacks IS a mismatch.
    """
    ref_meta = reference.get("meta", {})
    cand_meta = candidate.get("meta", {})
    bad = [f for f in fields if f in ref_meta
           and cand_meta.get(f) != ref_meta[f]]
    if bad:
        detail = ", ".join(
            f"{f}: committed={ref_meta[f]!r} candidate="
            f"{cand_meta.get(f, '<absent>')!r}" for f in bad)
        raise ProvenanceMismatch(
            f"{label}workload provenance mismatch — refusing to diff "
            f"({detail}); regenerate the candidate under the committed "
            f"workload or recommit the reference")


def _fmt(v) -> str:
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def compare(reference: dict, candidate: dict, *, latency_tol: float,
            hit_tol: float, qps_floor: float) -> list:
    """Return [(mode, field, ref, cand, limit_desc, ok), ...]."""
    rows = []
    for mode in sorted(k for k in reference if k != "meta"):
        ref, cand = reference[mode], candidate.get(mode)
        if cand is None:
            rows.append((mode, "<mode>", "present", "MISSING", "required",
                         False))
            continue
        for f in GATED_LATENCY:
            lim = ref[f] * (1 + latency_tol)
            rows.append((mode, f, ref[f], cand.get(f),
                         f"<= {lim:.3f} (+{latency_tol:.0%})",
                         cand.get(f) is not None and cand[f] <= lim))
        for f in GATED_HITS:
            if f not in ref:
                continue   # pre-cold-tier committed file: nothing to gate
            rows.append((mode, f, ref[f], cand.get(f),
                         f"± {hit_tol}",
                         cand.get(f) is not None
                         and abs(cand[f] - ref[f]) <= hit_tol))
        lim = ref["slo_qps"] * qps_floor
        rows.append((mode, "slo_qps", ref["slo_qps"], cand.get("slo_qps"),
                     f">= {lim:.1f} ({qps_floor:.0%} of committed)",
                     cand.get("slo_qps") is not None
                     and cand["slo_qps"] >= lim))

    # paged-window acceptance: relay_paged rides relay_batched's cache
    if "relay_paged" in reference and "relay_batched" in reference:
        rb, rp = candidate.get("relay_batched"), candidate.get("relay_paged")
        if rb and rp:
            rows.append(("relay_paged", "hbm_hit == relay_batched",
                         rb["hbm_hit"], rp["hbm_hit"], "± 0.005",
                         abs(rp["hbm_hit"] - rb["hbm_hit"]) <= 0.005))
        rb, rp = reference["relay_batched"], reference["relay_paged"]
        rows.append(("relay_paged", "slo_qps vs relay_batched (committed)",
                     rb["slo_qps"], rp["slo_qps"], "within 5%",
                     abs(rp["slo_qps"] - rb["slo_qps"])
                     <= 0.05 * rb["slo_qps"]))

    # device-pool acceptance: relay_devpool is relay_paged with the
    # device-resident data plane — a pure launch-path property that is
    # byte-free in the simulator, so its sim trace must ride
    # relay_paged's (hit rates tight, committed slo within 5%); the
    # live h2d win itself is gated by the CI smoke's
    # ``launch_reships == 0`` assert, not this table
    if "relay_devpool" in reference and "relay_paged" in reference:
        rp = candidate.get("relay_paged")
        rd = candidate.get("relay_devpool")
        if rp and rd:
            rows.append(("relay_devpool", "hbm_hit == relay_paged",
                         rp["hbm_hit"], rd["hbm_hit"], "± 0.005",
                         abs(rd["hbm_hit"] - rp["hbm_hit"]) <= 0.005))
        rp = reference["relay_paged"]
        rd = reference["relay_devpool"]
        rows.append(("relay_devpool", "slo_qps vs relay_paged (committed)",
                     rp["slo_qps"], rd["slo_qps"], "within 5%",
                     abs(rd["slo_qps"] - rp["slo_qps"])
                     <= 0.05 * rp["slo_qps"]))

    # beyond-prefix acceptance: relay_segments is relay_paged with
    # candidate-independent interior segments cached alongside the
    # prefix — the point of the mode is MORE reused tokens per hit, so
    # its reused-token fraction must strictly exceed relay_paged's
    # (candidate and committed), and the committed slo_qps may not fall
    # below relay_paged (segment reuse shortens critical-path ranking;
    # one-sided: faster is success)
    if "relay_segments" in reference and "relay_paged" in reference:
        rp = candidate.get("relay_paged")
        rs = candidate.get("relay_segments")
        if rp and rs and "reused_frac" in rp and "reused_frac" in rs:
            rows.append(("relay_segments", "reused_frac > relay_paged",
                         rp["reused_frac"], rs["reused_frac"],
                         "strictly greater",
                         rs["reused_frac"] > rp["reused_frac"]))
        rp = reference["relay_paged"]
        rs = reference["relay_segments"]
        if "reused_frac" in rp and "reused_frac" in rs:
            rows.append(("relay_segments",
                         "reused_frac > relay_paged (committed)",
                         rp["reused_frac"], rs["reused_frac"],
                         "strictly greater",
                         rs["reused_frac"] > rp["reused_frac"]))
        rows.append(("relay_segments",
                     "slo_qps vs relay_paged (committed)",
                     rp["slo_qps"], rs["slo_qps"],
                     ">= relay_paged",
                     rs["slo_qps"] >= rp["slo_qps"]))

    # multi-host acceptance: striping the pools over two hosts moves
    # WHERE producer and consumer rendezvous, never whether they do —
    # affinity hit rates must stay within 2% absolute of single-host
    # (the acceptance bound), and the committed slo_qps
    # within 10% (the owner-map hop is free in the model; the spread
    # covers per-host load-skew effects on the bisected headline)
    if "relay_multihost" in reference and "relay_batched" in reference:
        rb = candidate.get("relay_batched")
        rm = candidate.get("relay_multihost")
        if rb and rm:
            for f in ("hbm_hit", "dram_hit", "miss"):
                rows.append(("relay_multihost", f"{f} == relay_batched",
                             rb[f], rm[f], "± 0.02",
                             abs(rm[f] - rb[f]) <= 0.02))
        rb = reference["relay_batched"]
        rm = reference["relay_multihost"]
        rows.append(("relay_multihost",
                     "slo_qps vs relay_batched (committed)",
                     rb["slo_qps"], rm["slo_qps"], "within 10%",
                     abs(rm["slo_qps"] - rb["slo_qps"])
                     <= 0.10 * rb["slo_qps"]))

    # disaggregated-prefill acceptance: carving the side path onto a
    # dedicated host must not cost rendezvous — hit rates within 2%
    # absolute of relay_multihost (the shipment lands inside the
    # retrieval slack at the reference point) — and the committed
    # slo_qps may not fall more than 10% below relay_multihost (the
    # freed ranking slots should pay for the NIC hop, not the reverse;
    # one-sided: being FASTER is success, not drift)
    if "relay_disagg" in reference and "relay_multihost" in reference:
        rm = candidate.get("relay_multihost")
        rd = candidate.get("relay_disagg")
        if rm and rd:
            for f in ("hbm_hit", "dram_hit", "miss"):
                rows.append(("relay_disagg", f"{f} == relay_multihost",
                             rm[f], rd[f], "± 0.02",
                             abs(rd[f] - rm[f]) <= 0.02))
        rm = reference["relay_multihost"]
        rd = reference["relay_disagg"]
        rows.append(("relay_disagg",
                     "slo_qps vs relay_multihost (committed)",
                     rm["slo_qps"], rd["slo_qps"],
                     ">= 90% of relay_multihost",
                     rd["slo_qps"] >= 0.90 * rm["slo_qps"]))

    # cold-tier acceptance: relay_cold is relay_segments with a bounded
    # DRAM tier and a host-local cold store under it.  The tier's point
    # is the TAIL: past the admission knee, rate-limited returning
    # users must be served out of the hierarchy, so relay_cold's
    # tail-probe reuse fraction (hbm + dram + cold at 1.15x
    # relay_segments' slo_qps) must strictly exceed relay_segments'
    # (candidate and committed), and the committed slo_qps may not fall
    # below 95% of relay_segments (the disk path must not tax the
    # knee)
    if "relay_cold" in reference and "relay_segments" in reference:
        rs = candidate.get("relay_segments")
        rc = candidate.get("relay_cold")
        if rs and rc and "tail_reuse_frac" in rs \
                and "tail_reuse_frac" in rc:
            rows.append(("relay_cold",
                         "tail_reuse_frac > relay_segments",
                         rs["tail_reuse_frac"], rc["tail_reuse_frac"],
                         "strictly greater",
                         rc["tail_reuse_frac"] > rs["tail_reuse_frac"]))
        rs = reference["relay_segments"]
        rc = reference["relay_cold"]
        if "tail_reuse_frac" in rs and "tail_reuse_frac" in rc:
            rows.append(("relay_cold",
                         "tail_reuse_frac > relay_segments (committed)",
                         rs["tail_reuse_frac"], rc["tail_reuse_frac"],
                         "strictly greater",
                         rc["tail_reuse_frac"] > rs["tail_reuse_frac"]))
        rows.append(("relay_cold",
                     "slo_qps vs relay_segments (committed)",
                     rs["slo_qps"], rc["slo_qps"],
                     ">= 95% of relay_segments",
                     rc["slo_qps"] >= 0.95 * rs["slo_qps"]))

    # multi-tenant acceptance: relay_tenants is relay_batched with the
    # fleet split into two equal-share tenants (per-tenant byte quotas
    # on every tier + per-tenant admission buckets) over the IDENTICAL
    # arrival trace (tenant = user_id % 2, no RNG draw).  Partitioning
    # symmetric traffic must be near-free: hit rates within 2% absolute
    # of relay_batched and the committed slo_qps within 10% (each
    # tenant's bucket is half the pool rate — never binding below the
    # untenanted ceiling for a symmetric split).  The isolation
    # property itself (one tenant bursting must not move the other) is
    # gated on the capacity headline's ``isolation`` record.
    if "relay_tenants" in reference and "relay_batched" in reference:
        rb = candidate.get("relay_batched")
        rt = candidate.get("relay_tenants")
        if rb and rt:
            for f in ("hbm_hit", "dram_hit", "miss"):
                rows.append(("relay_tenants", f"{f} == relay_batched",
                             rb[f], rt[f], "± 0.02",
                             abs(rt[f] - rb[f]) <= 0.02))
        rb = reference["relay_batched"]
        rt = reference["relay_tenants"]
        rows.append(("relay_tenants",
                     "slo_qps vs relay_batched (committed)",
                     rb["slo_qps"], rt["slo_qps"], "within 10%",
                     abs(rt["slo_qps"] - rb["slo_qps"])
                     <= 0.10 * rb["slo_qps"]))
    return rows


def _curve_below_knee(cell: dict) -> list:
    knee = cell.get("knee_qps", 0.0)
    return [r for r in cell.get("curve", ())
            if r.get("offered_qps", 0.0) <= knee + 1e-9]


def _goodput_monotone(cell: dict, tol: float) -> bool:
    """Goodput must rise with offered load up to the knee: each point
    may dip at most ``tol`` (relative) below the running maximum."""
    best = 0.0
    for row in _curve_below_knee(cell):
        g = row.get("goodput_qps", 0.0)
        if g < best * (1 - tol):
            return False
        best = max(best, g)
    return True


def compare_isolation(reference: dict, candidate: dict, *,
                      hit_tol: float, knee_tol: float) -> list:
    """Gate the two-tenant burst-isolation record (the ``isolation``
    block of ``BENCH_capacity.json``): tenant B's MMPP burst must move
    neither tenant A's hit rate (within ``hit_tol`` absolute) nor A's
    SLO knee (within ``knee_tol`` relative).  Both the committed record
    and — when present — the candidate's fresh record are gated, so a
    partition regression fails CI from either side."""
    rows = []
    for label, head in (("committed", reference),
                        ("candidate", candidate)):
        iso = (head or {}).get("isolation")
        if not iso:
            continue
        solo, burst = iso.get("solo", {}), iso.get("burst", {})
        name = f"isolation[{label}]"
        hs, hb = solo.get("hit_rate"), burst.get("hit_rate")
        rows.append((name, "tenant A hit_rate under B burst",
                     hs, hb, f"± {hit_tol}",
                     hs is not None and hb is not None
                     and abs(hb - hs) <= hit_tol))
        ks, kb = solo.get("knee_qps"), burst.get("knee_qps")
        rows.append((name, "tenant A knee_qps under B burst",
                     ks, kb, f"within {knee_tol:.0%}",
                     ks is not None and kb is not None and ks > 0
                     and abs(kb - ks) <= knee_tol * ks))
    if not rows:
        rows.append(("isolation", "<record>", "present", "MISSING",
                     "committed isolation record required", False))
    return rows


def compare_capacity(reference: dict, candidate: dict, *,
                     knee_floor: float, curve_tol: float) -> list:
    """Gate a fresh capacity headline against the committed one over
    the intersection of matrix cells (the CI smoke runs a subset of
    the committed full matrix, keyed by the same cell names)."""
    ref_cells = reference.get("cells", {})
    cand_cells = candidate.get("cells", {})
    shared = sorted(set(ref_cells) & set(cand_cells))
    rows = []
    if not shared:
        rows.append(("capacity", "<cells>", len(ref_cells), 0,
                     "cell-key intersection non-empty", False))
        return rows
    for name in shared:
        ref, cand = ref_cells[name], cand_cells[name]
        lim = ref["knee_qps"] * knee_floor
        rows.append((name, "knee_qps", ref["knee_qps"],
                     cand.get("knee_qps"),
                     f">= {lim:.1f} ({knee_floor:.0%} of committed)",
                     cand.get("knee_qps") is not None
                     and cand["knee_qps"] >= lim))
        # goodput monotonicity is a Poisson-only inference: under MMPP
        # the burst phase realigns with every offered-rate rescale (the
        # stream is re-seeded per probe), so goodput below the knee
        # legitimately swings tens of percent between adjacent probes —
        # a dip there is burst alignment, not admission collapse.
        # Bursty cells stay gated by the knee floor above.
        if ref.get("workload", {}).get("arrival", "poisson") != "poisson":
            continue
        rows.append((name, "goodput monotone to knee",
                     "monotone", "monotone" if
                     _goodput_monotone(cand, curve_tol) else "DIP",
                     f"no >{curve_tol:.0%} dip below running max",
                     _goodput_monotone(cand, curve_tol)))

    # cold-tier acceptance (committed matrix): on every skewed
    # (Zipf-tail) POISSON cell the full hierarchy must LIFT the knee
    # over the DRAM-less batched deployment — returning tail users
    # revived off the cold store instead of re-prefilled is the whole
    # point of the tier.  MMPP cells are excluded for the same reason
    # as the monotonicity gate: their knees carry burst-phase noise
    # larger than the lift itself on 12 s sims (they remain gated by
    # the per-cell knee floor).
    for name, ref in sorted(ref_cells.items()):
        if not name.startswith("relay_cold/"):
            continue
        wl = ref.get("workload", {})
        if wl.get("skew", 0.0) <= 0.0:
            continue
        if wl.get("arrival", "poisson") != "poisson":
            continue
        peer = "relay_batched/" + name.split("/", 1)[1]
        pr = ref_cells.get(peer)
        if pr is None:
            continue
        rows.append((name, f"knee_qps >= {peer} (committed)",
                     pr["knee_qps"], ref["knee_qps"],
                     "cold tier lifts the Zipf-tail knee",
                     ref["knee_qps"] >= pr["knee_qps"]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fail CI when the serving perf headline regresses "
                    "past tolerance vs the committed BENCH_relay.json")
    ap.add_argument("--candidate", default=None,
                    help="headline json from a fresh "
                         "repro_torch.benchmarks.run")
    ap.add_argument("--reference", default=str(ROOT / "BENCH_relay.json"),
                    help="committed trajectory to gate against")
    ap.add_argument("--capacity-candidate", default=None,
                    help="headline json from a fresh "
                         "repro_torch.benchmarks.capacity run")
    ap.add_argument("--capacity-reference",
                    default=str(ROOT / "BENCH_capacity.json"),
                    help="committed capacity matrix to gate against")
    ap.add_argument("--latency-tol", type=float, default=0.05)
    ap.add_argument("--hit-tol", type=float, default=0.02)
    ap.add_argument("--curve-tol", type=float, default=None,
                    help="max relative goodput dip below the knee "
                         "(default 0.02, or 0.10 with --quick)")
    ap.add_argument("--qps-floor", type=float, default=None,
                    help="min fraction of committed slo_qps / knee_qps "
                         "(default 0.85, or 0.55 with --quick)")
    ap.add_argument("--iso-knee-tol", type=float, default=None,
                    help="max relative shift of tenant A's knee under "
                         "tenant B's burst (default 0.10, or 0.35 with "
                         "--quick: the coarse bisection alone carries "
                         "~30% bracket slack)")
    ap.add_argument("--quick", action="store_true",
                    help="candidate came from a --quick run: coarse "
                         "4 s-sim bisection, so widen the slo_qps floor")
    args = ap.parse_args(argv)
    if args.qps_floor is None:
        args.qps_floor = 0.55 if args.quick else 0.85
    if args.curve_tol is None:
        args.curve_tol = 0.10 if args.quick else 0.02
    if args.iso_knee_tol is None:
        args.iso_knee_tol = 0.35 if args.quick else 0.10
    if not args.candidate and not args.capacity_candidate:
        ap.error("need --candidate and/or --capacity-candidate")

    rows = []
    try:
        if args.candidate:
            with open(args.reference) as f:
                reference = json.load(f)
            with open(args.candidate) as f:
                candidate = json.load(f)
            check_provenance(reference, candidate, RELAY_PROVENANCE,
                             label="relay: ")
            rows += compare(reference, candidate,
                            latency_tol=args.latency_tol,
                            hit_tol=args.hit_tol,
                            qps_floor=args.qps_floor)
        if args.capacity_candidate:
            from repro_torch.benchmarks.capacity import PROVENANCE_FIELDS
            with open(args.capacity_reference) as f:
                cap_ref = json.load(f)
            with open(args.capacity_candidate) as f:
                cap_cand = json.load(f)
            if cap_ref.get("meta", {}).get("quick"):
                raise ProvenanceMismatch(
                    "capacity: committed reference "
                    f"{args.capacity_reference} is a --quick run — "
                    "refusing to gate against a smoke matrix; commit a "
                    "full run")
            # the candidate must SAY whether it is a smoke run: a
            # headline whose meta lacks the ``quick`` flag is schema
            # drift (or a hand-rolled file) and the knee tolerances
            # below would be meaningless against it
            if "quick" not in cap_cand.get("meta", {}):
                raise ProvenanceMismatch(
                    f"capacity: candidate {args.capacity_candidate} "
                    "has no meta.quick flag — cannot tell a smoke "
                    "matrix from a full run; regenerate the candidate "
                    "with python -m repro_torch.benchmarks.capacity")
            check_provenance(cap_ref, cap_cand, PROVENANCE_FIELDS,
                             label="capacity: ")
            rows += compare_capacity(cap_ref, cap_cand,
                                     knee_floor=args.qps_floor,
                                     curve_tol=args.curve_tol)
            rows += compare_isolation(cap_ref, cap_cand,
                                      hit_tol=args.hit_tol,
                                      knee_tol=args.iso_knee_tol)
    except ProvenanceMismatch as exc:
        print(f"REFUSED: {exc}", file=sys.stderr)
        return 2

    width = max(len(r[0]) + len(r[1]) for r in rows) + 3
    print(f"perf regression gate: candidate="
          f"{args.candidate or args.capacity_candidate} "
          f"vs committed="
          f"{args.reference if args.candidate else args.capacity_reference}"
          f"{' [quick tolerances]' if args.quick else ''}")
    failures = []
    for mode, field, ref, cand, limit, ok in rows:
        tag = "ok  " if ok else "FAIL"
        print(f"  {tag} {(mode + '.' + field).ljust(width)} "
              f"committed={_fmt(ref).ljust(9)} got={_fmt(cand).ljust(9)} "
              f"limit: {limit}")
        if not ok:
            failures.append(f"{mode}.{field}")
    if failures:
        print(f"REGRESSION: {len(failures)} metric(s) out of tolerance: "
              f"{', '.join(failures)}", file=sys.stderr)
        return 1
    print(f"all {len(rows)} gated metrics within tolerance")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
