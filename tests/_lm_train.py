"""Shared by ``tests/test_torch_lm_train.py`` and
``tests/test_torch_lm_train_ssm.py``: reference / port pairs of an LM
config from one JAX init, numpy-made batches, and the checks of a loss,
its gradients and one train step against the JAX package.

Weights: ``jax.random`` once, then numpy noise on the leaves whose init
leaves a term dead, trivial or near one-hot (below), and the same tree
into the port through ``convert.load_jax_params``:

* every norm scale (ones at init) becomes 1 + 0.1 N(0, 1);
* every attention's ``wq`` / ``wk`` is rescaled to fan-in d_model: the
  reference's init rule takes the fan-in of a (d, heads, hd) weight
  from the head count, so its attention logits reach ~100 at smoke
  width and a near one-hot softmax turns float32 reorderings (1e-7)
  into gradient differences of ~1e-4 (and MoE routing flips);
* the hybrid's zero ``lora_b``, Mamba2's ``A_log``, ``dt_bias`` and
  ``D``, RWKV6's ``mu``, ``w0``, ``u`` and zero ``w_lora_b`` get noise,
  as ``tests/test_torch_{hybrid,ssm}.py`` give them, but with ``A_log``
  centred at -2 (decay rates ~0.14 a unit of dt): a chunk's log-decay
  span then stays below 88, where the reference's plain SSD still has a
  finite gradient (beyond it the reference's is NaN and the port's is
  not: ROADMAP Queue 3, item 24, held in
  ``tests/test_torch_lm_train_ssm.py``).

Everything runs in float32 on both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import build_model as jbuild
from repro.models import get_config as jget
from repro.models.config import InputShape
from repro.training import optimizer as jopt
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, get_config
from repro_torch.models.convert import load_jax_params, state_from_tree
from repro_torch.training import optimizer as opt
from repro_torch import tree as ptree

LOSS_REL = 1e-5          # the loss (and its CE and aux), relative
NORM_REL = 1e-5          # the step's grad_norm, relative
GRAD_REL = 1e-4          # each gradient leaf (and the step's moments), of its largest
STEP_REL = 1e-6          # the updated parameters, of each leaf's largest |p|
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)

NORMS = {"ln", "ln1", "ln2", "lnx", "ln_attn", "ln_out", "norm", "q_norm",
         "k_norm", "final_norm", "enc_norm"}
# leaf: (scale, offset; None keeps the drawn value as the offset)
NOISE = {"lora_b": (0.1, 0.0), "w_lora_b": (0.1, 0.0), "A_log": (0.5, -2.0),
         "dt_bias": (0.5, 0.0), "D": (0.5, 1.0), "mu": (0.2, None),
         "w0": (0.5, None), "u": (0.3, None)}


def cfgs(arch, **kw):
    """(reference config, port config) of ``arch``'s smoke config, equal
    field for field; "ssm_mamba2" is zamba2_1p2b's with the family
    replaced, as ``tests/test_torch_ssm.py`` builds it."""
    if arch == "ssm_mamba2":
        arch, kw = "zamba2_1p2b", dict(kw, family="ssm_mamba2")
    jcfg = dataclasses.replace(jget(arch, smoke=True), **kw)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


def live(tree, rng, parent=""):
    """The noise of the module docstring, in place, in sorted-key order."""
    for key in sorted(tree):
        w = tree[key]
        if isinstance(w, dict):
            live(w, rng, key)
            continue
        w32 = np.asarray(w, np.float32)
        if key in NORMS:
            new = w32 + 0.1 * rng.normal(size=w.shape)
        elif key in ("wq", "wk") and parent in ("attn", "xattn"):
            new = w32 * np.sqrt(w.shape[-2] / w.shape[-3])
        elif key in NOISE:
            scale, offset = NOISE[key]
            new = (w32 if offset is None else offset) \
                + scale * rng.normal(size=w.shape)
        else:
            continue
        tree[key] = new.astype(w.dtype)
    return tree


_PAIRS = {}


def pair(arch, seed=0, **kw):
    """(reference model, its numpy tree, a function that builds the
    port's model on the CPU with the same weights), cached per
    arguments."""
    key = (arch, seed, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        kw.setdefault("dtype", "float32")
        jcfg, tcfg = cfgs(arch, **kw)
        jm = jbuild(jcfg)
        params = live(jax.tree.map(np.asarray,
                                   jax.jit(jm.init)(jax.random.PRNGKey(seed))),
                      np.random.default_rng(seed))

        def port():
            tm = build_model(tcfg, device="cpu")
            load_jax_params(tm, params)
            return tm

        _PAIRS[key] = (jm, params, port)
    return _PAIRS[key]


def batch(cfg, B, S, seed=0):
    """numpy tokens / labels (B, S), plus a VLM's ``frontend`` or an
    enc-dec's ``frames`` (B, F, d) drawn N(0, 1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    stub = {"vlm": "frontend", "encdec": "frames"}.get(cfg.family)
    if stub:
        out[stub] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def close(got, want, rel):
    """``got`` within ``rel`` of the largest |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def check_gradients(arch, B, S, seed=0, **kw):
    """The port's ``loss`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's: the loss (and each
    metric) to LOSS_REL, each leaf to GRAD_REL of its largest |g|.  A
    leaf off the loss's path has no gradient in the port and jax.grad's
    zeros in the reference.  Returns the port's metrics."""
    jm, params, port = pair(arch, seed, **kw)
    data = batch(jm.cfg, B, S, seed)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jax.tree.map(jnp.asarray, params),
                                jax.tree.map(jnp.asarray, data))
    tm = port().requires_grad_(True)
    loss, metrics = tm.loss({k: torch.as_tensor(v) for k, v in data.items()})
    loss.backward()
    assert abs(loss.item() / float(jloss) - 1) <= LOSS_REL
    assert set(metrics) == set(jmet)
    for k, v in metrics.items():
        close(v, jmet[k], LOSS_REL)
    want = state_from_tree(jax.tree.map(np.asarray, jgrads))
    got = dict(tm.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        if got[name].grad is None:
            assert not np.abs(g).any(), name
            continue
        close(got[name].grad, g, GRAD_REL)
    return metrics


def check_train_step(arch, B, S, seed=0, **kw):
    """One ``make_train_step`` step against the reference's jitted step
    from the same weights and batch: loss, CE (and aux) to LOSS_REL,
    grad_norm to NORM_REL, lr exactly, the step counter, and the new
    moments to GRAD_REL of each leaf's largest (they are the clipped
    gradient and its square, scaled).  The updated parameters are held
    to STEP_REL of each leaf's largest |p| against the reference's
    ``apply_updates`` given the port's own gradients: AdamW's first
    update is lr g / (|g| + eps) per element, so a 1e-9 gradient
    difference at |g| ~ eps would move it by ~lr, and the jitted step's
    parameters are held through the moments instead."""
    jm, params, port = pair(arch, seed, **kw)
    data = batch(jm.cfg, B, S, seed)
    jstep, _, _ = jmake_train_step(jm, InputShape("t", S, B, "train"),
                                   jopt.AdamWConfig(**ADAMW))
    _, jstate, jmet = jax.jit(jstep)(jax.tree.map(jnp.asarray, params),
                                     jopt.init_state(params),
                                     jax.tree.map(jnp.asarray, data))
    tm = port()
    step = make_train_step(tm, opt.AdamWConfig(**ADAMW))
    state = opt.init_state(step.params)
    m = step(state, {k: torch.as_tensor(v) for k, v in data.items()})
    assert set(m) == set(jmet)
    for k in m:
        if k == "lr":
            assert m[k] == float(jmet[k])
        elif k == "grad_norm":
            assert abs(float(m[k]) / float(jmet[k]) - 1) <= NORM_REL
        else:
            close(m[k], jmet[k], LOSS_REL)
    assert int(state["step"]) == int(jstate["step"]) == 1
    for key in ("mu", "nu"):
        for (path, want), got in zip(
                jax.tree_util.tree_flatten_with_path(jstate[key])[0],
                ptree.leaves(state[key])):
            close(got, want, GRAD_REL)
    grads = ptree.tree_map(
        lambda p: np.zeros(p.shape, np.float32) if p.grad is None
        else p.grad.numpy(), step.params)
    want, _, _ = jax.jit(functools.partial(
        jopt.apply_updates, jopt.AdamWConfig(**ADAMW)))(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, grads), jopt.init_state(params))
    own = tm.state_dict()
    for name, w in state_from_tree(jax.tree.map(np.asarray, want)).items():
        close(own[name], w, STEP_REL)
    return m
