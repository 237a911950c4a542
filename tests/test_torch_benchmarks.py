"""The port's simulator benchmarks against the reference's, on the CPU.

``repro_torch.benchmarks`` carries copies of the reference's
``benchmarks/`` (capacity harness, figures, ablations, regression gate,
entry point).  The relay core underneath is a copy too, so every number
must equal the reference's exactly, not within a tolerance:

* ``run_point`` in each of the 11 serving modes, the quick capacity
  matrix with its report and the isolation cell, the Fig. 11a / 11d / 12
  and Table 1 rows, the ablations and ``find_knee``;
* the regression gate's rows and exit codes on the committed
  ``BENCH_relay.json`` / ``BENCH_capacity.json`` and on perturbed copies;
* ``run``: ``--quick`` writes nothing, the full headline defaults to
  ``build/``, ``--hardware`` prices the headline figures with a table's
  ``HardwareModel`` and records its device;
* ``hardware``: ``fit`` recovers the model it is given, ``load`` refuses
  a table measured on the CPU or the smoke model unless ``allow_cpu``,
  and a loaded model prices ``pre_infer_ms`` as the reference's formula.

The measured H100 table itself comes only from the card
(``python -m repro_torch.benchmarks.hardware --no-smoke``).
"""

import copy
import dataclasses
import json

import pytest
import torch

import benchmarks.ablations as jabl
import benchmarks.capacity as jcap
import benchmarks.check_regression as jgate
import benchmarks.figures as jfig
from repro_torch.benchmarks import BUILD, ROOT
from repro_torch.benchmarks import ablations as tabl
from repro_torch.benchmarks import capacity as tcap
from repro_torch.benchmarks import check_regression as tgate
from repro_torch.benchmarks import figures as tfig
from repro_torch.benchmarks import hardware, roofline, run

torch.set_num_threads(1)


def _same(a, b):
    """Equal as JSON, key for key and number for number."""
    assert json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


# --- the capacity harness ----------------------------------------------------------


@pytest.mark.parametrize("mode", jcap.ALL_MODES)
def test_run_point_equals_reference(mode):
    assert tcap.ALL_MODES == jcap.ALL_MODES
    want = jcap.run_point(mode, 2048, 60, dur=4.0, distribution=True)
    got = tcap.run_point(mode, 2048, 60, dur=4.0, distribution=True)
    assert got["n"] > 0
    _same(got, want)


def test_quick_matrix_report_and_isolation_equal_reference():
    spec_j, spec_t = jcap.MatrixSpec.quick_spec(), tcap.MatrixSpec.quick_spec()
    assert spec_t.to_dict() == spec_j.to_dict()
    cells_j, cells_t = jcap.run_matrix(spec_j), tcap.run_matrix(spec_t)
    _same(cells_t, cells_j)
    kw = dict(dur=spec_j.duration_s, slo_ms=spec_j.slo_ms, seed=spec_j.seed,
              coarse=True)
    iso_j, iso_t = jcap.isolation_cell(**kw), tcap.isolation_cell(**kw)
    _same(iso_t, iso_j)
    _same(tcap.headline(cells_t, spec_t, iso_t),
          jcap.headline(cells_j, spec_j, iso_j))
    assert tcap.curves_csv(cells_t) == jcap.curves_csv(cells_j)
    assert tcap.render(cells_t) == jcap.render(cells_j)
    assert tcap.PROVENANCE_FIELDS == jcap.PROVENANCE_FIELDS


@pytest.mark.parametrize("capacity", [3.0, 437.0, 5e6])
@pytest.mark.parametrize("coarse", [False, True])
def test_find_knee_equals_reference(capacity, coarse):
    def measure(q):
        return {"goodput_qps": 0.99 * q, "ok": q <= capacity}

    def ok(s):
        return s["ok"]

    a = jcap.find_knee(measure, ok, coarse=coarse)
    b = tcap.find_knee(measure, ok, coarse=coarse)
    assert (b.best, b.knee_qps, b.capped, b.hard_cap) == \
        (a.best, a.knee_qps, a.capped, a.hard_cap)
    assert [(q, o) for q, o, _ in b.probes] == [(q, o) for q, o, _ in a.probes]


# --- figures and ablations ----------------------------------------------------------


@pytest.fixture(scope="module")
def ref_fig11a():
    return jfig.fig11a_max_seq_len()


def test_figure_rows_equal_reference(ref_fig11a):
    for name in ("fig12_local_vs_remote", "table1_kv_footprint",
                 "fig11c_breakdown", "fig11d_slo_throughput"):
        assert getattr(tfig, name)() == getattr(jfig, name)(), name
    assert tfig.fig11a_max_seq_len() == ref_fig11a
    assert [f.__name__ for f in tfig.ALL_FIGURES] == \
        [f.__name__ for f in jfig.ALL_FIGURES]


def test_figures_take_a_cost_model(ref_fig11a):
    """Another cost model prices every run of the figure (the default,
    the harness's COST, gives the reference's rows: above)."""
    fast = tcap.COST.__class__(tcap.HSTU, dataclasses.replace(
        tcap.COST.hw, eff_flops=40e12))
    rows = {n: us for n, us, _ in tfig.fig11a_max_seq_len(cost=fast)}
    ref = {n: us for n, us, _ in ref_fig11a}
    assert rows.keys() == ref.keys()
    assert rows["fig11a/baseline/L16384"] < ref["fig11a/baseline/L16384"]


def test_ablations_equal_reference():
    assert [f.__name__ for f in tabl.ALL_ABLATIONS] == \
        [f.__name__ for f in jabl.ALL_ABLATIONS]
    for a, b in zip(tabl.ALL_ABLATIONS, jabl.ALL_ABLATIONS):
        assert a() == b(), a.__name__


# --- the regression gate -------------------------------------------------------------


def _committed(name):
    return json.loads((ROOT / name).read_text())


def _relay_candidates():
    ref = _committed("BENCH_relay.json")
    slow = copy.deepcopy(ref)
    slow["relay"]["p99_ms"] *= 1.2
    slow["relay_batched"]["slo_qps"] *= 0.5
    missing = copy.deepcopy(ref)
    del missing["relay_cold"]
    hits = copy.deepcopy(ref)
    hits["relay_paged"]["hbm_hit"] -= 0.1
    reseeded = copy.deepcopy(ref)
    reseeded["meta"]["seed"] = 7
    return {"same": ref, "slow": slow, "missing": missing, "hits": hits,
            "reseeded": reseeded}


def _capacity_candidates():
    ref = _committed("BENCH_capacity.json")
    slow = copy.deepcopy(ref)
    for cell in slow["cells"].values():
        cell["knee_qps"] *= 0.5
    no_flag = copy.deepcopy(ref)
    del no_flag["meta"]["quick"]
    quick = copy.deepcopy(ref)
    quick["meta"]["quick"] = True
    burst = copy.deepcopy(ref)
    burst["isolation"]["burst"]["hit_rate"] -= 0.2
    return {"same": ref, "slow": slow, "no_flag": no_flag, "quick": quick,
            "burst": burst}


def test_gate_rows_equal_reference():
    ref = _committed("BENCH_relay.json")
    kw = dict(latency_tol=0.05, hit_tol=0.02, qps_floor=0.85)
    for name, cand in _relay_candidates().items():
        assert tgate.compare(ref, cand, **kw) == \
            jgate.compare(ref, cand, **kw), name
        outcome = []
        for gate in (jgate, tgate):
            try:
                gate.check_provenance(ref, cand, gate.RELAY_PROVENANCE)
                outcome.append("ok")
            except (jgate.ProvenanceMismatch, tgate.ProvenanceMismatch) as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1], name
    cap = _committed("BENCH_capacity.json")
    for name, cand in _capacity_candidates().items():
        assert tgate.compare_capacity(cap, cand, knee_floor=0.55,
                                      curve_tol=0.1) == \
            jgate.compare_capacity(cap, cand, knee_floor=0.55,
                                   curve_tol=0.1), name
        assert tgate.compare_isolation(cap, cand, hit_tol=0.02,
                                       knee_tol=0.35) == \
            jgate.compare_isolation(cap, cand, hit_tol=0.02,
                                    knee_tol=0.35), name


@pytest.mark.parametrize("kind", ["relay", "capacity"])
def test_gate_exit_codes_equal_reference(tmp_path, capsys, kind):
    """The gate's ``main`` on the committed files and on perturbed
    copies: the same exit code and the same printed rows as the
    reference's, the committed files only read."""
    cands = _relay_candidates() if kind == "relay" else \
        _capacity_candidates()
    flag = "--candidate" if kind == "relay" else "--capacity-candidate"
    before = {n: (ROOT / n).read_bytes()
              for n in ("BENCH_relay.json", "BENCH_capacity.json")}
    codes = {}
    for name, cand in cands.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(cand))
        got = []
        for gate in (jgate, tgate):
            args = [flag, str(path), "--quick"]
            if gate is jgate:      # the reference's defaults are cwd-relative
                args += ["--reference", str(ROOT / "BENCH_relay.json"),
                         "--capacity-reference",
                         str(ROOT / "BENCH_capacity.json")]
            rc = gate.main(args)
            got.append((rc, capsys.readouterr()))
        assert got[0][0] == got[1][0], name
        assert got[0][1].out == got[1][1].out, name
        codes[name] = got[1][0]
    if kind == "relay":
        assert codes == {"same": 0, "slow": 1, "missing": 1, "hits": 1,
                         "reseeded": 2}
    else:
        assert codes == {"same": 0, "slow": 1, "no_flag": 2, "quick": 0,
                         "burst": 1}
    assert before == {n: (ROOT / n).read_bytes() for n in before}


# --- run -----------------------------------------------------------------------------


def _stamps(*paths):
    return {str(p): p.stat().st_mtime_ns if p.exists() else None
            for p in paths}


def test_run_quick_writes_nothing_and_full_runs_write_to_build(
        tmp_path, monkeypatch, capsys):
    assert run.RELAY_JSON == BUILD / "BENCH_relay.json"
    assert run.RELAY_JSON_H100 == BUILD / "BENCH_relay_h100.json"
    assert BUILD == ROOT / "build" and (ROOT / "BENCH_relay.json").exists()
    assert hardware.OUT.parent == BUILD
    # the quick run's one bisection is exercised by the figure test above
    monkeypatch.setattr(tfig, "fig11d_slo_throughput", lambda: [])
    monkeypatch.chdir(tmp_path)
    outputs = (ROOT / "BENCH_relay.json", run.RELAY_JSON,
               run.RELAY_JSON_H100)
    before = _stamps(*outputs)
    # no dry-run artifacts: no roofline row, as the reference's load()
    # returns [] (the rows themselves: the next test)
    monkeypatch.setattr(roofline, "ARTIFACTS", tmp_path / "dryrun")
    run.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert any(r.startswith("fig12/L") for r in out)
    assert not any(r.startswith("roofline") for r in out)
    assert _stamps(*outputs) == before
    assert list(tmp_path.iterdir()) == []


def test_run_prints_the_roofline_of_dry_run_records(tmp_path, monkeypatch,
                                                    capsys):
    """With dry-run records in the artifact directory ``run`` prints one
    ``roofline/<arch>/<shape>`` row per 16 x 16 record, as the
    reference's does: the bound in microseconds at the H100's peak for
    the config's type (float32 for hstu_gr: 67e12 FLOP/s) and HBM rate
    (3.35e12 B/s), the dominant term and the useful share."""
    def rec(shape, mesh, flops, nbytes, status="ok"):
        r = {"arch": "hstu_gr", "shape": shape, "mesh": mesh,
             "status": status, "n_chips": 256, "jaxpr_flops_global": flops,
             "memory": {"argument_size_in_bytes": nbytes,
                        "output_size_in_bytes": 0,
                        "temp_size_in_bytes": None}}
        (tmp_path / f"baseline__hstu_gr__{shape}__{mesh}.json").write_text(
            json.dumps(r))

    rec("train_4k", "16x16", 256 * 67e12, 3.35e9)
    rec("decode_32k", "16x16", 256 * 67e9, 2 * 3.35e12)
    rec("prefill_32k", "1x1", 1e12, 1e9)
    rec("long_500k", "16x16", 0, 0, status="skipped")
    monkeypatch.setattr(roofline, "ARTIFACTS", tmp_path)
    run.print_roofline()
    out = capsys.readouterr().out.splitlines()
    assert [r.split(",")[:2] for r in out] == [
        ["roofline/hstu_gr/decode_32k", "2000000.0"],
        ["roofline/hstu_gr/train_4k", "1000000.0"]]
    assert out[0].endswith("dominant=memory useful=" + str(round(
        roofline.model_flops(*_hstu_decode()) / (256 * 67e9), 3)))
    assert "dominant=compute" in out[1]


def _hstu_decode():
    from repro_torch.models import INPUT_SHAPES, get_config
    return get_config("hstu_gr"), INPUT_SHAPES["decode_32k"]


def _synthetic_points(hw, cfg, lens=(1024, 4096, 16384)):
    """Op and copy times exactly as ``hw`` prices them."""
    from repro_torch.core.costmodel import GRCostModel
    cost = GRCostModel(cfg, hw)
    q = hardware.N_INCR + hardware.N_ITEMS
    ops = {"pre_infer": lambda L: cost.pre_infer_ms(L),
           "rank_cached": lambda L: cost.rank_on_cache_ms(
               L, hardware.N_INCR, hardware.N_ITEMS),
           "rank_full": lambda L: cost.full_rank_ms(
               L, hardware.N_INCR, hardware.N_ITEMS)}
    points = [{"op": op, "L": L, "ms": ops[op](L) - hw.host_feature_ms}
              for L in lens for op in hardware.OPS]
    h2d = [{"L": L, "bytes": cost.kv_bytes(L),
            "ms": cost.kv_bytes(L) / hw.h2d_bw * 1e3}
           for L in hardware.H2D_LENS]
    assert q == 576
    return points, h2d


def _hw_of(tab):
    from repro_torch.core.costmodel import HardwareModel
    return HardwareModel(**tab["hardware"])


def _table(tmp_path, platform, smoke=False, name="hw.json"):
    from repro_torch.core.costmodel import HardwareModel
    from repro_torch.models import get_config
    true = dataclasses.replace(HardwareModel(), eff_flops=37.5e12,
                               h2d_bw=41e9)
    points, h2d = _synthetic_points(true, get_config("hstu_gr", smoke=smoke))
    device = {"platform": platform, "name": "a card" if platform == "gpu"
              else "cpu", "card": None}
    tab = hardware.table({"points": points, "h2d": h2d, "meta": {
        "device": device, "model": "hstu-gr", "smoke": smoke,
        "graphs": platform == "gpu"}})
    path = tmp_path / name
    path.write_text(json.dumps(tab))
    return true, tab, path


def test_hardware_fit_recovers_the_model():
    from repro_torch.core.costmodel import HardwareModel
    from repro_torch.models import get_config
    cfg = get_config("hstu_gr")
    true = dataclasses.replace(HardwareModel(), eff_flops=55e12,
                               h2d_bw=24e9)
    points, h2d = _synthetic_points(true, cfg)
    hw, rows = hardware.fit(points, h2d, cfg)
    assert hw.eff_flops == pytest.approx(true.eff_flops, rel=1e-12)
    assert hw.h2d_bw == pytest.approx(true.h2d_bw, rel=1e-12)
    for f in hardware.KEPT:
        assert getattr(hw, f) == getattr(HardwareModel(), f), f
    assert len(rows) == len(points)
    assert max(abs(r["rel_err"]) for r in rows) < 1e-12
    # a launch-bound short prefix: slower than the FLOPs say, and it shows
    slow = [dict(p, ms=p["ms"] + 1.0) if p["L"] == 1024 else p
            for p in points]
    hw2, rows2 = hardware.fit(slow, h2d, cfg)
    assert hw2.eff_flops < true.eff_flops
    assert all(r["rel_err"] < -0.3 for r in rows2 if r["L"] == 1024)


def test_hardware_load_refuses_cpu_and_smoke_tables(tmp_path):
    true, tab, gpu = _table(tmp_path, "gpu")
    assert hardware.load(gpu) == _hw_of(tab)
    for platform, smoke in (("cpu", False), ("gpu", True)):
        _, _, path = _table(tmp_path, platform, smoke, f"{platform}.json")
        with pytest.raises(ValueError, match="measured on"):
            hardware.load(path)
        assert hardware.load(path, allow_cpu=True).eff_flops > 0
    assert tab["meta"]["kept"] == list(hardware.KEPT)
    (tmp_path / "junk.json").write_text(json.dumps({"buckets": {}}))
    with pytest.raises(ValueError, match="not a hardware table"):
        hardware.load(tmp_path / "junk.json")


def test_loaded_model_prices_ops_by_the_reference_formula(tmp_path):
    from repro_torch.core.costmodel import GRCostModel
    true, _, path = _table(tmp_path, "gpu")
    hw = hardware.load(path)
    assert hw.eff_flops == pytest.approx(true.eff_flops, rel=1e-12)
    cost = GRCostModel(tcap.HSTU, hw)
    for L in (1024, 2048, 16384):
        want = (cost.forward_flops(L) / hw.eff_flops * 1e3
                + L * hw.embed_bytes_per_token / hw.h2d_bw * 1e3
                + hw.host_feature_ms)
        assert cost.pre_infer_ms(L) == pytest.approx(want, rel=1e-12)


def test_hardware_measures_on_the_cpu(tmp_path, capsys):
    """The CLI's path end to end at the smoke size: three ops per length,
    the psi copies, a table ``load`` refuses without ``allow_cpu``."""
    out = tmp_path / "hw.json"
    tab = hardware.main(["--device", "cpu", "--lens", "64", "--turns", "1",
                         "--out", str(out)])
    assert [(p["op"], p["L"]) for p in tab["points"]] == \
        [(op, 64) for op in hardware.OPS]
    assert all(p["ms"] > 0 for p in tab["points"])
    assert [r["L"] for r in tab["h2d"]] == list(hardware.H2D_LENS)
    assert tab["meta"]["device"]["platform"] == "cpu"
    assert tab["meta"]["graphs"] is False
    assert json.loads(out.read_text()) == tab
    with pytest.raises(ValueError):
        hardware.load(out)
    assert hardware.load(out, allow_cpu=True).eff_flops == \
        tab["hardware"]["eff_flops"]
    assert "op,L,ms,pred_ms,rel_err" in capsys.readouterr().out


def test_run_hardware_prices_the_headline_figures(tmp_path, monkeypatch,
                                                  capsys):
    """``--hardware`` runs Fig. 11a, Fig. 11d and the headline with the
    table's model (and ``--calibration``'s factors), and records the
    table's device in the headline's ``meta``."""
    _, tab, path = _table(tmp_path, "gpu")
    cal = tmp_path / "cal.json"
    cal.write_text(json.dumps({"default": 0.07, "buckets": {
        "2048": {"2": 0.1}}}))
    seen = []

    def fig(name):
        def f(cost=None):
            seen.append((name, cost))
            return [(f"{name}/x", 1.0, "y")]
        f.__name__ = name
        return f

    def summary(quick=False, cost=None):
        seen.append(("headline", cost))
        return {"meta": {"L": 2048}, **{m: {"slo_qps": 1.0, "p99_ms": 1.0}
                                        for m in run.RELAY_MODES}}

    for name in ("fig11a_max_seq_len", "fig11d_slo_throughput"):
        monkeypatch.setattr(tfig, name, fig(name))
    monkeypatch.setattr(tfig, "bench_relay_summary", summary)
    out = tmp_path / "h100.json"
    run.main(["--hardware", str(path), "--calibration", str(cal),
              "--relay-json", str(out)])
    assert [n for n, _ in seen] == ["fig11a_max_seq_len",
                                    "fig11d_slo_throughput", "headline"]
    for _, cost in seen:
        assert cost.hw == _hw_of(tab)
        assert cost.batch_calibration["default"] == 0.07
    head = json.loads(out.read_text())
    assert head["meta"]["device"] == tab["meta"]["device"]
    assert head["meta"]["hardware"] == str(path)
    printed = capsys.readouterr().out
    assert "fig11a_max_seq_len/x" in printed and "fig12" not in printed
