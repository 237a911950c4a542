"""Nothing the benchmark runs has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``repro`` (each name compared whole: ``repro_torch``
passes), and nothing reads the repository's older benchmark data."""

import ast
import subprocess
import sys

import pytest

from relaybench import run, spec

SOURCES = sorted(spec.HERE.rglob("*.py"))


def imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_sources_import_no_jax_and_no_reference_package(path):
    roots = set(imported_roots(path))
    assert not roots & set(run.FORBIDDEN), (path, roots)
    text = path.read_text()
    if path.name != "test_relaybench_isolation.py":
        assert "BENCH_" not in text and "benchmarks/" not in text


def test_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert run.forbidden_modules() == ["repro"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import relaybench.run as r\n"
            "from relaybench import flops, readers, reference, spec, trace,"
            " traffic, weights\n"
            "from repro_torch.core import RelayGRService, get_executor\n"
            "from repro_torch.core.graphs import resolve_runner\n"
            "from repro_torch.models import build_model\n"
            "b = spec.benchmark()\n"
            "for m in b['end_to_end'] + b['per_layer']:\n"
            "    spec.reader(m['name'])\n"
            "print(r.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
