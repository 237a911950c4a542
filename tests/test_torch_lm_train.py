"""LM training in the port, the Transformer families and HSTU, on the CPU,
held against the JAX package; the launcher for a VLM; bf16 LM
checkpoints across the two packages.

Weights and inputs as ``tests/_lm_train.py`` makes them (one JAX init,
numpy noise that keeps every term live and the attention logits O(1),
numpy-made tokens and frontend embeddings), in float32.

Tolerances (both sides float32, summed in other orders): the loss, its
CE and the MoE's aux 1e-5 relative; a step's grad_norm 1e-5 relative;
each gradient leaf, and the step's new AdamW moments, 1e-4 of the
leaf's largest |value|; the updated parameters 1e-6 of each leaf's
largest |p| against the reference's ``apply_updates`` given the port's
gradients (why not against the jitted step's parameters: see
``_lm_train.check_train_step``).  Checkpoints are compared bit for bit.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train as lt
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.launch import train
from repro_torch.models.convert import (export_params, load_jax_opt_state,
                                        load_jax_params, param_tree,
                                        state_from_tree)
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt
from repro_torch import tree as ptree

torch.set_num_threads(1)

ARCHS = ["qwen3_4b", "yi_9b", "starcoder2_7b", "starcoder2_15b",
         "internvl2_2b", "deepseek_moe_16b", "dbrx_132b", "hstu_gr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_train_step_match_reference(arch):
    """``loss`` and one ``make_train_step`` step at the smoke config,
    B 2 x S 64 (a VLM's frontend in front)."""
    m = lt.check_train_step(arch, 2, 64)
    assert math.isfinite(float(m["loss"]))
    if arch.startswith(("deepseek", "dbrx")):
        assert float(m["aux"]) > 0
        assert float(m["loss"]) == pytest.approx(
            float(m["ce"]) + float(m["aux"]), rel=1e-6)


@pytest.mark.parametrize("arch,S", [
    ("qwen3_4b", 64),            # dense
    ("starcoder2_7b", 160),      # the sliding window (64) masks the prefill
    ("deepseek_moe_16b", 64),    # MoE: the aux loss's gradient included
    ("internvl2_2b", 64),        # VLM: the projector, frontend dropped
])
def test_every_gradient_matches_reference(arch, S):
    jcfg = lt.cfgs(arch)[0]
    if arch.startswith("starcoder2"):
        assert 0 < jcfg.sliding_window < S
    m = lt.check_gradients(arch, 2, S)
    if arch.startswith("deepseek"):
        assert m["aux"].item() > 0


def test_chunked_ce_path_matches_reference():
    """S 1024 > ``CE_CHUNK`` (512): the CE in two rematerialised chunks
    on both sides, the loss and every gradient."""
    lt.check_gradients("qwen3_4b", 1, 1024)


def test_launcher_trains_a_vlm(capsys):
    """The VLM's batch gets zero frontend embeddings, as the
    reference's launcher gives them."""
    last = train.main(["--arch", "internvl2-2b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--batch", "2", "--seq", "64",
                       "--log-every", "1"])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", out)]
    assert "family=vlm" in out and len(losses) == 3
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] == pytest.approx(last, abs=1e-4)


def test_bf16_lm_checkpoints_restore_across_packages(tmp_path):
    """qwen3_4b's smoke config in its own bf16: parameters and AdamW
    state written by each package restore bit for bit in the other."""
    jm, params, port = lt.pair("qwen3_4b", dtype="bfloat16")
    tm = port()
    assert tm.tok.dtype == torch.bfloat16
    rng = np.random.default_rng(7)
    moments = lambda: jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    state = {"mu": moments(), "nu": moments(), "step": np.int32(9)}
    # written by the reference, restored by the port
    jckpt.save(tmp_path / "ref", jax.tree.map(jnp.asarray, params),
               jax.tree.map(jnp.asarray, state), step=9)
    other = lt.build_model(tm.cfg, device="cpu")
    tparams = param_tree(other)
    got, step = checkpoint.restore(
        tmp_path / "ref", {"params": tparams, "opt": opt.init_state(tparams)})
    assert step == 9
    load_jax_params(other, ptree.tree_map(lambda t: t.float().numpy(),
                                          got["params"]))
    for name, want in state_from_tree(params).items():
        mine = other.state_dict()[name]
        assert mine.dtype == tm.state_dict()[name].dtype, name
        assert np.array_equal(mine.float().numpy(),
                              np.asarray(want, np.float32)), name
    theirs = load_jax_opt_state(other, state)
    for key in ("mu", "nu"):
        for a, b in zip(ptree.leaves(got["opt"][key]),
                        ptree.leaves(theirs[key])):
            assert torch.equal(a, b)
    # written by the port, restored by the reference
    tstate = load_jax_opt_state(tm, state)
    checkpoint.save(tmp_path / "port", param_tree(tm), tstate, step=4)
    template = jax.jit(jm.init)(jax.random.PRNGKey(1))
    jgot, step = jckpt.restore(tmp_path / "port", {
        "params": template, "opt": jopt.init_state(template)})
    assert step == 4
    for want, have in ((export_params(tm), jgot["params"]),
                       (state, jgot["opt"])):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                                jax.tree.leaves(have)):
            assert np.array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32)), path
    for a, b in zip(jax.tree.leaves(template), jax.tree.leaves(jgot["params"])):
        assert a.dtype == b.dtype
    assert jgot["params"]["tok"].dtype == jnp.bfloat16
