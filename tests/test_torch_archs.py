"""Every architecture of the reference builds in the port, and the
port's two relay examples run, on the CPU.

``repro_torch.models`` carries the reference's ``ARCH_IDS`` and
``ALIASES`` and its ``get_model``; each id's smoke config builds through
``get_model(id, smoke=True, device="cpu")`` and prefills 2 x 16 tokens
(numpy-made from a seed; a VLM's frontend and an enc-dec's frames
random) to finite logits of the reference's shape.  The examples are
run as ``python -m`` would run them, with ``--device cpu``.
"""

import ast
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from repro.models import ALIASES as JALIASES
from repro.models import ARCH_IDS as JARCH_IDS
from repro.models import get_model as jget_model
from repro_torch import models

torch.set_num_threads(1)


def test_arch_ids_and_aliases_are_the_references():
    assert models.ARCH_IDS == JARCH_IDS
    assert models.ALIASES == JALIASES


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_every_id_builds_and_prefills(arch):
    model = models.get_model(arch, smoke=True, device="cpu")
    assert type(model).__name__ == type(jget_model(arch, smoke=True)).__name__
    model.init(torch.Generator().manual_seed(0))
    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))}
    extra = {"vlm": "frontend", "encdec": "frames"}.get(cfg.family)
    if extra:
        batch[extra] = torch.as_tensor(rng.normal(
            size=(2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    logits, _ = model.prefill(batch)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_padded)
    assert torch.isfinite(logits.float()).all()


def _run_example(name, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_module(f"repro_torch.examples.{name}", run_name="__main__")


def test_quickstart_example_runs(monkeypatch, capsys):
    """The relay through an ``HBMCacheStore``: |relay - full| < 1e-4
    (the example asserts it), and the window's ledger."""
    _run_example("quickstart", ["--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert "eps-bound holds" in out
    assert "'inserts': 1, 'hits': 1" in out


def test_serve_relay_example_runs(monkeypatch, capsys):
    """``launch.serve.main`` over a short CPU stream: every request is
    served, some of them from psi relayed through the HBM window, and
    the trigger's ledger is printed."""
    _run_example("serve_relay", ["--device", "cpu", "--requests", "12",
                                 "--qps", "150"], monkeypatch)
    out = capsys.readouterr().out
    hits = re.search(r"requests=12 hits=(\{.*\})", out)
    assert hits, out[-2000:]
    hits = ast.literal_eval(hits.group(1))
    assert sum(hits.values()) == 12 and hits.get("hbm_hit", 0) > 0, hits
    assert '"admitted"' in out


@pytest.mark.parametrize("chunk", [256, 4000, 1 << 24])
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_bounded_draw_keeps_the_stacked_draw(arch, chunk, monkeypatch):
    """``init`` draws each weight in flat chunks of at most
    ``arch.DRAW_CHUNK`` elements (whole rows of its trailing dims), and
    every smoke weight equals the stacked draw (each ``ParamSpec.
    initialise`` of the whole tensor, in sorted-name order) bit for bit,
    at chunk sizes that cut every stacked weight, some rows, and none."""
    from repro_torch.models import arch as parch
    monkeypatch.setattr(parch, "DRAW_CHUNK", chunk)
    model = models.get_model(arch, smoke=True, device="cpu").init(
        torch.Generator().manual_seed(3))
    specs = parch.flat_specs(model.param_specs())
    g = torch.Generator().manual_seed(3)
    own = dict(model.named_parameters())
    for name in sorted(specs):
        assert torch.equal(own[name], specs[name].initialise(g)), name
