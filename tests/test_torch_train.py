"""The port's training path and HSTU's LM-style entry points on the CPU,
held against the JAX package.

Weights come from ``jax.random`` once and go into the port through the
bridge (``repro_torch.models.convert``); inputs and optimizer states are
numpy-made.  The config is the smoke config (2 layers, d 64, 2 x 32,
RoPE on) with vocab 500, so the padded ids 500..511 are masked in every
loss here.

Tolerances (both sides float32, summed in different orders):
cross-entropy 1e-6 of the largest value; the loss 1e-5 relative; each
gradient leaf 1e-4 of its largest |g|; one AdamW step 1e-6 relative;
a 5-step trajectory's losses 1e-4 relative; decode logits 1e-5 of the
largest |logit|.  The attention backward (``kernels.hstu_attn``) is held
against float64 autograd over the plain version to 1e-10 of the largest
|g| (both float64).
"""

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import arch as jarch
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.models import layers as jlayers
from repro.models.config import InputShape
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
from repro_torch.kernels import hstu_attn as hk
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import arch, build_model, get_config, layers
from repro_torch.models.convert import (export_params, load_jax_opt_state,
                                        load_jax_params, param_tree,
                                        state_from_tree)
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt
from repro_torch import tree as ptree

torch.set_num_threads(1)

VOCAB = 500


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _pair(**over):
    jcfg = dataclasses.replace(jget("hstu-gr", smoke=True), vocab=VOCAB, **over)
    tcfg = dataclasses.replace(get_config("hstu-gr", smoke=True), vocab=VOCAB,
                               **over)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert jcfg.vocab_padded > VOCAB and not jcfg.use_flash_kernels
    jm = jbuild(jcfg)
    params = jm.init(jax.random.PRNGKey(1))
    tm = build_model(tcfg, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _batch(seed, B, S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --- losses ------------------------------------------------------------------


def test_cross_entropy_masks_the_padded_vocab():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 8, 512)).astype(np.float32) * 3
    logits[..., VOCAB:] = 50.0      # would dominate the logsumexp unmasked
    labels = rng.integers(0, VOCAB, (2, 8)).astype(np.int32)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 VOCAB)
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), VOCAB)
    assert got.dtype == torch.float32
    _close(got, want, 1e-6)
    assert float(want.max()) < 20          # the 50s were masked
    f64 = layers.cross_entropy(torch.from_numpy(logits).double(),
                               torch.from_numpy(labels), VOCAB)
    assert f64.dtype == torch.float64
    _close(f64, want, 1e-6)


def test_ce_loss_chunked_matches_reference_and_unchunked(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, tm.cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (2, 64)).astype(np.int32)
    want = jarch.ce_loss(params, jnp.asarray(x), jnp.asarray(labels),
                         jm.cfg, chunk=16)
    xs = [torch.tensor(x, requires_grad=True) for _ in range(2)]
    lab = torch.from_numpy(labels)
    chunked = arch.ce_loss(tm.final_norm, tm.unembed, xs[0], lab, VOCAB,
                           chunk=16)
    whole = arch.ce_loss(tm.final_norm, tm.unembed, xs[1], lab, VOCAB)
    _close(chunked, want, 1e-6)
    _close(whole, want, 1e-6)
    chunked.backward()
    whole.backward()
    _close(xs[0].grad, xs[1].grad.numpy(), 1e-6)
    # S not a multiple of the chunk: computed unchunked, same value
    _close(arch.ce_loss(tm.final_norm, tm.unembed, xs[1][:, :40], lab[:, :40],
                        VOCAB, chunk=16),
           jarch.ce_loss(params, jnp.asarray(x[:, :40]),
                         jnp.asarray(labels[:, :40]), jm.cfg, chunk=16), 1e-6)


def test_loss_and_every_gradient_match_jax(pair):
    """S 1024: two 512-token CE chunks, both sides rematerialised."""
    jm, params, tm = pair
    batch = _batch(2, 2, 1024)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, jax.tree.map(jnp.asarray, batch))[0])(params)
    tm.requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    loss, metrics = tm.loss(batch)
    loss.backward()
    assert metrics["ce"] is loss
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    want = state_from_tree(jax.tree.map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        mine = got[name].grad
        if mine is None:             # not on the loss's path: jax.grad's zeros
            assert name.startswith("task_tower") and not np.abs(g).any()
            continue
        _close(mine, g, 1e-4)
    tm.requires_grad_(False)


# --- the attention backward --------------------------------------------------


@pytest.mark.parametrize("S,elems", [(1, 1 << 26), (17, 1 << 26),
                                     (130, 2 * 3 * 64 * 130)])
def test_hstu_attn_backward_matches_float64_autograd(S, elems, monkeypatch):
    """``hstu_attn_backward`` (one block, and 64-row blocks that split
    S 130 in three) against autograd over the plain version."""
    monkeypatch.setattr(hk, "BWD_BLOCK_ELEMS", elems)
    g = torch.Generator().manual_seed(S)
    q, k, v, dout = (torch.randn(2, 3, S, 32, generator=g, dtype=torch.float64)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    hk.hstu_attn_plain(*leaves, n_total=S + 5).backward(dout)
    got = hk.hstu_attn_backward(q, k, v, dout, S + 5)
    for mine, want in zip(got, leaves):
        _close(mine, want.grad.numpy(), 1e-10)


def test_attention_function_wires_the_backward(monkeypatch):
    """``HSTUAttnFunction`` with the kernel launch swapped for the plain
    version (the CPU has no card): ``gradcheck`` in float64, one counted
    forward per call, and the CPU wrapper never enters it."""
    monkeypatch.setattr(hk, "_launch", lambda q, k, v, n: ref.hstu_attn_ref(
        q, k, v, n_total=n))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 9, 4, generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: hk.HSTUAttnFunction.apply(a, b, c, 11.0), (q, k, v))
    out = hk.hstu_attn(q, k, v)       # CPU tensors: plain, ordinary autograd
    assert out.grad_fn is not None and "HSTUAttn" not in type(
        out.grad_fn).__name__


# --- AdamW -------------------------------------------------------------------


def test_schedule_matches_reference():
    cfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    jcfg = jopt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=50)
    for step in (0, 1, 10, 30, 50, 60):
        got = opt.schedule(cfg, step)
        want = jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)
    assert float(opt.schedule(cfg, 50)) == pytest.approx(1e-4, rel=1e-6)


def test_apply_updates_matches_reference():
    """One step from identical params, grads and state (step 6, the
    gradient clipped, 1-d leaves not decayed, a leaf with no gradient)."""
    rng = np.random.default_rng(3)
    like = {"w": np.empty((6, 5)), "b": np.empty(5),
            "layers": {"ln": np.empty((2, 5)), "s": np.empty((3, 2, 4))},
            "idle": np.empty((4, 4))}
    tree = lambda f: ptree.tree_map(lambda a: f(a.shape), like)
    p = tree(lambda s: rng.normal(size=s).astype(np.float32))
    g = tree(lambda s: 3 * rng.normal(size=s).astype(np.float32))
    g["idle"] = np.zeros((4, 4), np.float32)
    mu = tree(lambda s: 0.1 * rng.normal(size=s).astype(np.float32))
    nu = tree(lambda s: 0.01 * rng.random(size=s).astype(np.float32))
    cfg = opt.AdamWConfig(warmup_steps=3, total_steps=20)
    jp, js, jm = jopt.apply_updates(
        jopt.AdamWConfig(warmup_steps=3, total_steps=20),
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"mu": jax.tree.map(jnp.asarray, mu), "nu": jax.tree.map(jnp.asarray, nu),
         "step": jnp.asarray(6, jnp.int32)})
    tp = ptree.tree_map(torch.tensor, p)
    tg = ptree.tree_map(torch.tensor, g)
    tg["idle"] = None
    state = {"mu": ptree.tree_map(torch.tensor, mu),
             "nu": ptree.tree_map(torch.tensor, nu),
             "step": torch.tensor(6, dtype=torch.int32)}
    tp2, state2, m = opt.apply_updates(cfg, tp, tg, state)
    assert tp2 is tp and state2 is state and int(state["step"]) == 7
    assert float(jm["grad_norm"]) > 1            # the clip is active
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-6)
    assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    for got, want in ((tp, jp), (state["mu"], js["mu"]),
                      (state["nu"], js["nu"])):
        for a, b in zip(ptree.leaves(got), ptree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_train_trajectory_matches_reference():
    """Five ``make_train_step`` steps on ``train_batches`` against the
    reference's jitted step from the same weights."""
    jm, params, tm = _pair()
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep, _, _ = jmake_train_step(jm, InputShape("t", 64, 4, "train"),
                                   jopt.AdamWConfig(**adamw))
    jstep = jax.jit(jstep)
    jstate = jopt.init_state(params)
    step = make_train_step(tm, opt.AdamWConfig(**adamw))
    state = opt.init_state(step.params)
    store = UserBehaviorStore(WorkloadConfig(vocab=VOCAB))
    batches = store.train_batches(4, 64)
    losses = []
    for _ in range(5):
        batch = next(batches)
        params, jstate, jmet = jstep(params, jstate,
                                     jax.tree.map(jnp.asarray, batch))
        m = step(state, batch)
        assert float(m["loss"]) == pytest.approx(float(jmet["loss"]),
                                                 rel=1e-4)
        assert float(m["ce"]) == float(m["loss"])
        assert m["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
        losses.append(float(m["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 5
    assert all(math.isfinite(x) for x in losses)


# --- decode_step / init_cache -------------------------------------------------


def test_decode_step_and_init_cache_match_reference(pair):
    """Against the reference's plain ``mask=None`` decode (ROADMAP Queue
    3, item 3: its flash branch reads key 0 only), with per-row
    positions; then against a zero cache from ``init_cache``."""
    jm, params, tm = pair
    rng = np.random.default_rng(4)
    pre = rng.integers(0, VOCAB, (2, 48))
    token = rng.integers(0, VOCAB, (2, 1)).astype(np.int32)
    pos = np.array([48, 31], np.int32)
    _, kv = tm.prefill({"tokens": torch.as_tensor(pre)})
    jl, jc = jm.decode_step(params, tuple(jnp.asarray(t.numpy()) for t in kv),
                            {"token": jnp.asarray(token),
                             "pos": jnp.asarray(pos)})
    tl, tc = tm.decode_step(kv, {"token": torch.as_tensor(token),
                                 "pos": torch.as_tensor(pos)})
    assert tc is kv and tl.shape == (2, 1, tm.cfg.vocab_padded)
    _close(tl, jl, 1e-5)
    # per-row positions reach RoPE: row 1 at 48 differs from row 1 at 31
    moved, _ = tm.decode_step(kv, {"token": torch.as_tensor(token),
                                   "pos": torch.tensor([48, 48])})
    assert torch.equal(moved[0], tl[0]) and not torch.equal(moved[1], tl[1])
    zero = tm.init_cache(2, 16)
    jzero = jm.init_cache(2, 16)
    for a, b in zip(zero, jzero):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
        assert not a.any()
    jl, _ = jm.decode_step(params, jzero, {"token": jnp.asarray(token),
                                           "pos": jnp.asarray(pos)})
    tl, _ = tm.decode_step(zero, {"token": torch.as_tensor(token),
                                  "pos": torch.as_tensor(pos)})
    _close(tl, jl, 1e-5)


# --- checkpoints ----------------------------------------------------------------


def _trees(tm, seed):
    """(params, opt state) numpy trees in the reference's layout, and a
    small tree with a bfloat16 leaf."""
    rng = np.random.default_rng(seed)
    params = export_params(tm)
    moments = lambda: jax.tree.map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
    state = {"mu": moments(), "nu": moments(), "step": np.int32(seed)}
    small = {"a": rng.normal(size=(3, 4)).astype(np.float32),
             "h": np.asarray(jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16))}
    return params, state, small


def test_checkpoints_restore_across_packages(pair, tmp_path):
    jm, _, tm = pair
    # written by the reference, restored by the port
    params, state, small = _trees(tm, 5)
    jckpt.save(tmp_path / "ref", jax.tree.map(jnp.asarray, params),
               jax.tree.map(jnp.asarray, state), step=11)
    jckpt.save(tmp_path / "ref_small", jax.tree.map(jnp.asarray, small))
    other = build_model(tm.cfg, device="cpu")
    template = {"params": param_tree(other),
                "opt": opt.init_state(param_tree(other))}
    got, step = checkpoint.restore(tmp_path / "ref", template)
    assert step == 11
    load_jax_params(other, ptree.tree_map(lambda t: t.numpy(), got["params"]))
    for name, want in state_from_tree(params).items():
        assert np.array_equal(other.state_dict()[name].numpy(), want), name
    theirs = load_jax_opt_state(other, state)
    for key in ("mu", "nu"):
        for a, b in zip(ptree.leaves(got["opt"][key]),
                        ptree.leaves(theirs[key])):
            assert torch.equal(a, b)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == int(theirs["step"]) == 5
    tsmall = {"a": torch.zeros(3, 4), "h": torch.zeros(5, dtype=torch.bfloat16)}
    gs = checkpoint.restore(tmp_path / "ref_small", {"params": tsmall})[0][
        "params"]
    assert gs["h"].dtype == torch.bfloat16
    assert np.array_equal(gs["h"].float().numpy(), small["h"].astype(np.float32))
    assert np.array_equal(gs["a"].numpy(), small["a"])
    # written by the port, restored by the reference
    params, state, small = _trees(tm, 6)
    tstate = load_jax_opt_state(tm, state)
    checkpoint.save(tmp_path / "port", param_tree(tm), tstate, step=3)
    checkpoint.save(tmp_path / "port_small",
                    {"a": torch.from_numpy(small["a"]),
                     "h": torch.from_numpy(small["h"].astype(np.float32)).to(
                         torch.bfloat16)})
    jtemplate = {"params": jm.init(jax.random.PRNGKey(0)),
                 "opt": jopt.init_state(jm.init(jax.random.PRNGKey(0)))}
    jgot, step = jckpt.restore(tmp_path / "port", jtemplate)
    assert step == 3
    for want, have in ((params, jgot["params"]), (state, jgot["opt"])):
        for (path, a), b in zip(
                jax.tree_util.tree_flatten_with_path(want)[0],
                jax.tree.leaves(have)):
            assert np.array_equal(np.asarray(a), np.asarray(b)), path
    jsmall = jckpt.restore(tmp_path / "port_small", {"params": small})[0][
        "params"]
    assert jsmall["h"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(jsmall["h"]), small["h"])


# --- the launcher ------------------------------------------------------------------


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    ck = tmp_path / "ck" / "hstu"
    last = train.main(["--device", "cpu", "--smoke", "--steps", "20",
                       "--batch", "4", "--seq", "64", "--lr", "3e-3",
                       "--log-every", "5", "--ckpt", str(ck)])
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=([0-9.]+)", out)]
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    assert losses[-1] == pytest.approx(last, abs=1e-4)
    assert losses[-1] < losses[0] - 0.05, losses
    assert re.search(r"grad_norm=\S+ lr=\S+ \(\d+\.\d+s/step\)", out)
    assert ck.with_suffix(".npz").exists() and ck.with_suffix(".json").exists()
    model = build_model(get_config("hstu-gr", smoke=True), device="cpu")
    tree, step = checkpoint.restore(ck, {"params": param_tree(model)})
    assert step == 20 and tree["params"]["tok"].shape == model.tok.shape
    with pytest.raises(NotImplementedError, match="Queue 1, item 11"):
        train.main(["--device", "cpu", "--arch", "zamba2-1.2b", "--smoke"])
