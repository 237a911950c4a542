"""Every cell of BENCHMARK.json resolves from its files by name."""

import json

import pytest

from relaybench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_from_its_files(workload):
    cell = spec.cell(BENCH, workload)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    assert cfg["name"] == cell["config"]
    assert cfg["limits"]["score_gap"] > 0
    assert traffic["loop"] in ("open", "closed")
    e2e = spec.metrics_of(BENCH, workload, trace=False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = spec.metrics_of(BENCH, workload, trace=True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names, (m["name"], names)
    for m in e2e + per_layer:
        assert callable(spec.reader(m["name"]))


def test_config_entries_name_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"relaybench/configs/{c['name']}.json"
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
