"""The port stands alone: ``repro_torch`` imports neither JAX nor ``repro``.

Every module of the package is imported in a fresh interpreter in which
``import jax`` fails (``sys.modules["jax"] = None``), and afterwards no
``jax`` or ``repro`` module may be loaded; a sharded model's prefill
under a meta process mesh then runs there too.  A second check reads the
sources: no file under ``src/repro_torch`` imports either.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"

PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and (k == "jax" or k.startswith("jax.")
                                      or k == "repro"
                                      or k.startswith("repro.")))
print(len(names), "modules;", "leaked:", leaked)
assert not leaked, leaked
assert {"repro_torch.training.optimizer", "repro_torch.training.checkpoint",
        "repro_torch.launch.train", "repro_torch.launch.mesh",
        "repro_torch.models.partitioning"} <= set(names), names
# the sharded path without JAX: a meta process mesh counts the
# collectives of a sharded model's step
import dataclasses, torch
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models import build_model, get_config
from repro_torch.models.partitioning import logical_rules
mesh = ProcessMesh.meta((2, 2))
with logical_rules(mesh):
    m = build_model(get_config("qwen3_4b", smoke=True), device="meta")
    m.prefill({"tokens": torch.zeros((2, 8), dtype=torch.long,
                                     device="meta")})
assert mesh.collectives()["all-reduce"]["count"] == 1 + 2 * m.cfg.n_layers
leaked = sorted(k for k, v in sys.modules.items() if v is not None and (
    k in ("jax", "repro") or k.startswith(("jax.", "repro."))))
assert not leaked, leaked
"""


def test_every_module_imports_without_jax_or_repro():
    out = subprocess.run(
        [sys.executable, "-c", PROBE],
        env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n = int(out.stdout.split()[0])
    assert n >= 30, out.stdout          # the whole tree was walked


def test_no_source_file_imports_jax_or_repro():
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)[.\s])",
                     re.M)
    for line in ("import jax", "  import jax.numpy as jnp", "from jax import x",
                 "from repro.core import y", "import repro.models"):
        assert bad.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import y",
                 "from .hstu import HSTUModel"):
        assert not bad.search(line), line
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 30
    offenders = [str(f.relative_to(SRC)) for f in files
                 if bad.search(f.read_text())]
    assert not offenders, offenders
