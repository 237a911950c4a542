"""FSDP (ZeRO-3 over "data") and ZeRO-2 under a process mesh, on the
CPU, held against the JAX package's unsharded results, against one
process, and against the reference's own sharded train step.

Five gloo spawns of 4 ranks (``tests/_dist_workers.py``), one per mesh,
each carrying every family: the smoke configs of qwen3_4b (dense),
deepseek_moe_16b (MoE), hstu_gr, zamba2_1p2b (hybrid), rwkv6_1p6b and
seamless_m4t_large_v2 (enc-dec).

* FSDP (``logical_rules(mesh, fsdp=True)``: every weight's "embed"
  dimension on "data") on (2, 2), (4, 1) and (2, 2, 1) over ("pod",
  "data", "model"), the last a mesh whose gradients must be summed over
  "pod" alone once the gathers' backward has summed them over "data":
  the prefill's logits and cache, HSTU's ``rank_with_cache`` scores and
  3 decode steps against the reference's (2e-5 of the largest |value|),
  then 2 AdamW steps against one process;
* ZeRO-2 (``make_train_step(..., zero2=True)``: the moments' "embed"
  dimension on "data", the weights replicated) on (2, 2) and (4, 1):
  the same 2 AdamW steps, and every parameter the same bits on every
  data rank.

The train rule is ``tests/test_torch_dist.py``'s: loss, CE and
grad_norm within 1e-5 relative, both moments within 1e-4 of each leaf's
largest, every parameter within 1e-5 of its leaf's largest |p| except
where AdamW's eps makes an update jump (second moment below (100 eps)^2,
at most 2 lr a step, at most one element in 10^4).  Every rank's shards
of the weights and moments have the local shape of their rules and put
back together; every rank's live collectives of each step equal the meta
dry-run's (``trace_collectives(..., fsdp=, zero2=)``).

The MoE on (2, 2) is expert-parallel: each data shard's tokens take the
capacity of that shard (the reference's shard_map rule), which the
unsharded run does not share, so its values are held on the other
meshes (data only, or a model axis of 1: the global capacity), and its
tallies and shards on all five.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _dist_workers as W
import _lm_train as lm
from repro_torch.launch.dryrun import trace_collectives
from repro_torch.models import build_model, get_config
from repro_torch.models.arch import flat_specs
from repro_torch.models.config import InputShape
from repro_torch.models.convert import load_jax_params
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models.partitioning import (Rules, local_shape,
                                             logical_rules, make_mesh)
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten, tree_map

REL = 2e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ARCHS = ["qwen3_4b", "deepseek_moe_16b", "hstu_gr", "zamba2_1p2b",
         "rwkv6_1p6b", "seamless_m4t_large_v2"]
# mode: (mesh sizes, fsdp, zero2)
MODES = {"fsdp22": ((2, 2), True, False), "fsdp41": ((4, 1), True, False),
         "fsdp221": ((2, 2, 1), True, False),
         "zero22": ((2, 2), False, True), "zero41": ((4, 1), False, True)}
FSDP = [m for m in MODES if MODES[m][1]]
ZERO2 = [m for m in MODES if MODES[m][2]]
EXPERT_PARALLEL = {("deepseek_moe_16b", "fsdp22"),
                   ("deepseek_moe_16b", "zero22")}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _tcfg(arch):
    return lm.cfgs(arch, dtype="float32")[1]


def _inputs(arch, B=4, S=16):
    """A prompt (an enc-dec's with its frames), 3 decode steps, HSTU's
    rank rows (incr, items) and 2 train batches, from numpy."""
    cfg = _tcfg(arch)
    seed = 60 + ARCHS.index(arch)
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        prompt["frames"] = rng.normal(size=(B, cfg.n_frontend_tokens,
                                            cfg.d_model)).astype(np.float32)
    steps = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
              (S + i + np.arange(B) * 3).astype(np.int32)) for i in range(3)]
    rows = (tuple(rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
                  for n in (4, 8)) if cfg.hstu else None)
    batches = [lm.batch(cfg, B, S, seed + 10 * i) for i in (1, 2)]
    return prompt, steps, rows, batches


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn per mode, every family in it (ZeRO-2 changes the train
    step alone: its spawns run no serve part)."""
    tmp = tmp_path_factory.mktemp("dist_fsdp")
    out = {}
    for mode, (sizes, fsdp, zero2) in MODES.items():
        jobs = []
        for a in ARCHS:
            prompt, steps, rows, batches = _inputs(a)
            serve = (prompt, steps) if fsdp else (None, None)
            jobs.append((W.fsdp_worker, (_tcfg(a), lm.pair(a)[1]) + serve + (
                batches, ADAMW, fsdp, zero2, rows if fsdp else None)))
        if mode == "fsdp22":
            jobs.append((W.gather_dim_worker, ()))
        if mode == "fsdp41":
            jobs.append((W.fsdp_one_sequence_worker,
                         (_tcfg("rwkv6_1p6b"), lm.pair("rwkv6_1p6b")[1])
                         + _one_sequence_inputs()))
        res = W.spawn(W.jobs_worker, sizes, tmp, jobs)
        out[mode] = {a: [r[i] for r in res] for i, a in enumerate(ARCHS)}
        if mode == "fsdp22":
            out["gather_dim"] = [r[len(ARCHS)] for r in res]
        if mode == "fsdp41":
            out["one_sequence"] = [r[len(ARCHS)] for r in res]
    return out


def _one_sequence_inputs():
    """RWKV6's state for one sequence (wkv, token shift; numpy, N(0, 1))
    and 3 decode steps."""
    cfg = _tcfg("rwkv6_1p6b")
    rng = np.random.default_rng(70)
    specs = build_model(cfg, device="meta").cache_specs(1, 16)
    cache = tuple(rng.normal(size=sd[0]).astype(np.float32) for sd in specs)
    steps = [(rng.integers(0, cfg.vocab, (1, 1)).astype(np.int32),
              np.array([16 + i], np.int32)) for i in range(3)]
    return cache, steps


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The JAX package's prefill logits and cache, HSTU's scores, decode
    logits and the cache after them (one device), as numpy leaves."""
    jm, params, _ = lm.pair(arch)
    prompt, steps, rows, _ = _inputs(arch)
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jax.jit(jm.prefill)(jp, jax.tree.map(jnp.asarray, prompt))
    out = {"prefill": np.asarray(jl),
           "cache_prefill": [np.asarray(t) for t in jax.tree.leaves(jc)],
           "decode": []}
    if rows is not None:
        out["scores"] = np.asarray(jax.jit(jm.rank_with_cache)(
            jp, jc, *map(jnp.asarray, rows)))
    jstep = jax.jit(jm.decode_step)
    for tok, pos in steps:
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(pos)})
        out["decode"].append(np.asarray(jl))
    out["cache"] = [np.asarray(t) for t in jax.tree.leaves(jc)]
    return out


@functools.lru_cache(maxsize=None)
def _world1(arch):
    """One process's 2 AdamW steps of ``_inputs``' batches: each step's
    metrics, the parameters and moments after each, and each leaf's
    smallest second moment over the steps."""
    cfg = _tcfg(arch)
    model = build_model(cfg, device="cpu")
    load_jax_params(model, lm.pair(arch)[1])
    step = lm.make_train_step(model, opt.AdamWConfig(**ADAMW))
    state = opt.init_state(step.params)
    out, low = [], {}
    for b in _inputs(arch)[3]:
        m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for name, v in flatten(state["nu"], ".").items():
            low[name] = torch.minimum(low.get(name, v), v).clone()
        out.append(dict(metrics={k: float(v) for k, v in m.items()}, **{
            key: {k: v.detach().numpy().copy()
                  for k, v in flatten(tree, ".").items()}
            for key, tree in (("params", step.params), ("mu", state["mu"]),
                              ("nu", state["nu"]))}))
    return out, {k: v.sqrt().numpy() for k, v in low.items()}


def _axes_leaves(axes):
    """The logical axes of a cache's leaves, in ``tree.leaves`` order."""
    if isinstance(axes, dict):
        return [a for k in sorted(axes) for a in _axes_leaves(axes[k])]
    if all(isinstance(a, (str, type(None))) for a in axes):
        return [axes]
    return [a for t in axes for a in _axes_leaves(t)]


def _param_axes(arch):
    return flatten(build_model(_tcfg(arch), device="meta").param_axes(), ".")


def _cases(modes):
    """(arch, mode) pairs whose values one device reproduces."""
    return [(a, m) for a in ARCHS for m in modes
            if (a, m) not in EXPERT_PARALLEL]


@pytest.mark.parametrize("arch,mode", _cases(FSDP))
def test_fsdp_serve_matches_reference(runs, arch, mode):
    """Prefill logits and every cache leaf, HSTU's ``rank_with_cache``
    scores, 3 decode steps' logits and the cache after them, each rank's
    shards put back together, against the reference on one device."""
    sizes = MODES[mode][0]
    outs = runs[mode][arch]
    want = _reference(arch)
    tm = build_model(_tcfg(arch), device="meta")
    lg = ("batch", None, "vocab")
    _close(W.assemble([o["prefill"] for o in outs], lg,
                      want["prefill"].shape, sizes), want["prefill"])
    for i, w in enumerate(want["decode"]):
        _close(W.assemble([o["decode"][i] for o in outs], lg, w.shape,
                          sizes), w)
    if "scores" in want:
        _close(W.assemble([o["scores"] for o in outs], ("batch", None, None),
                          want["scores"].shape, sizes), want["scores"])
    specs = tm.cache_specs(4, 16)
    axes = _axes_leaves(specs[1] if tm.cfg.hstu else tm.cache_axes(4, 16))
    for key in ("cache_prefill", "cache"):
        assert len(want[key]) == len(outs[0][key]) == len(axes)
        for j, (w, ax) in enumerate(zip(want[key], axes)):
            _close(W.assemble([o[key][j] for o in outs], ax, w.shape,
                              sizes, fsdp=True), w)


def _moment_axes(arch, mode):
    return flatten(opt.state_axes(build_model(_tcfg(arch), device="meta")
                                  .param_axes(), MODES[mode][2])["mu"], ".")


@pytest.mark.parametrize("arch,mode", _cases(MODES))
def test_two_train_steps_equal_world_one(runs, arch, mode):
    """2 AdamW steps against one process's: each step's loss, CE (and a
    Transformer's aux) and grad_norm within 1e-5 relative (the global
    norm sums each shard's squares over the axes its rules shard it on,
    FSDP's "data" included), both moments within GRAD_REL of each leaf's
    largest after each step, every parameter within 1e-5 of its leaf's
    largest |p| but for AdamW's eps jumps (the module's rule)."""
    sizes, fsdp, _ = MODES[mode]
    outs = runs[mode][arch]
    want, low = _world1(arch)
    p_axes, m_axes = _param_axes(arch), _moment_axes(arch, mode)
    eps = opt.AdamWConfig().eps
    for i, w in enumerate(want):
        for o in outs:
            got = o["train"][i]["metrics"]
            assert set(got) == set(w["metrics"])
            for k in ("loss", "ce", "grad_norm"):
                assert abs(got[k] / w["metrics"][k] - 1) <= LOSS_REL, (
                    k, i, got, w["metrics"])
            assert got["lr"] == w["metrics"]["lr"]
        for key in ("mu", "nu"):
            for name, m in w[key].items():
                _close(W.assemble([o["train"][i][key][name] for o in outs],
                                  m_axes[name], m.shape, sizes, fsdp=fsdp),
                       m, GRAD_REL)
        loose, total = 0, 0
        for name, p in w["params"].items():
            got = W.assemble([o["train"][i]["params"][name] for o in outs],
                             p_axes[name], p.shape, sizes, fsdp=fsdp)
            err = np.abs(got - p)
            off = err > 1e-5 * np.abs(p).max()
            assert not (off & (low[name] >= 100 * eps)).any(), name
            assert (err[off] <= 2 * ADAMW["lr"] * (i + 1)).all(), name
            loose += int(off.sum())
            total += p.size
        assert loose <= 1e-4 * total, (loose, total)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS for m in MODES])
def test_shards_have_the_local_shapes_of_their_rules(runs, arch, mode):
    """Every rank's weights and moments after the steps: each leaf at
    ``local_shape`` under ``Rules(mesh, fsdp=...)`` of its logical axes
    (the moments' under ZeRO-2 ``state_axes(zero2=True)``), and the
    ranks' shards put back together (``assemble`` holds both, and that
    ranks holding one slice hold the same bits); FSDP cuts at least the
    top-level weights and each layer's norms over "data", ZeRO-2 cuts
    the moments and not the weights."""
    sizes, fsdp, zero2 = MODES[mode]
    outs = runs[mode][arch]
    tm = build_model(_tcfg(arch), device="meta")
    shapes = {k: tuple(sd[0]) for k, sd in
              flatten(tm.abstract_params(), ".").items()}
    p_axes, m_axes = _param_axes(arch), _moment_axes(arch, mode)
    further = {"params": 0, "mu": 0}
    mesh = ProcessMesh.meta(sizes, W.AXES[-len(sizes):])
    for key, axes in (("params", p_axes), ("mu", m_axes), ("nu", m_axes)):
        for name, shape in shapes.items():
            parts = [o["train"][-1][key][name] for o in outs]
            W.assemble(parts, axes[name], shape, sizes, fsdp=fsdp)
            plain = local_shape(shape, Rules(mesh).spec(p_axes[name], shape),
                                mesh)
            if key in further:
                further[key] += parts[0].size < np.prod(plain)
    # the leaves whose "embed" dimension "data" divides, cut further than
    # the same mesh's plain rules cut them
    data = sizes[-2]
    embed = sum(1 for k, shape in shapes.items() if any(
        a == "embed" and n % data == 0 for a, n in zip(p_axes[k], shape)))
    assert embed > 3
    if fsdp:
        assert further == {"params": embed, "mu": embed}, (further, embed)
    if zero2:
        assert further == {"params": 0, "mu": embed}, (further, embed)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS for m in ZERO2])
def test_zero2_parameters_are_the_same_bits_on_every_data_rank(runs, arch,
                                                              mode):
    """After each ZeRO-2 step every rank of a model coordinate holds its
    parameters with the same bits as every other data rank: each
    updated its part alone and the all-gather put the parts together."""
    sizes = MODES[mode][0]
    outs = runs[mode][arch]
    for i in range(2):
        for r, o in enumerate(outs):
            peer = r % sizes[-1]               # data 0, the same model rank
            for name, p in o["train"][i]["params"].items():
                q = outs[peer]["train"][i]["params"][name]
                assert p.dtype == q.dtype and p.tobytes() == q.tobytes(), (
                    name, r)


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS for m in MODES])
def test_live_collectives_equal_the_meta_tally(runs, arch, mode):
    """Every rank's live collectives of a prefill, a decode step (FSDP)
    and each train step equal the meta dry-run's at the same shape, mesh
    and rules (``trace_collectives(..., fsdp=, zero2=)``); FSDP's steps
    gather and reduce-scatter, ZeRO-2's gathers the parameters once a
    type."""
    sizes, fsdp, zero2 = MODES[mode]
    cfg = _tcfg(arch)
    mesh = make_mesh(sizes, W.AXES[-len(sizes):])
    meta = lambda kind: trace_collectives(cfg, InputShape(kind, 16, 4, kind),
                                          mesh, fsdp=fsdp, zero2=zero2)
    train = meta("train")
    for o in runs[mode][arch]:
        for t in o["train"]:
            assert t["tally"] == train, (t["tally"], train)
        if fsdp:
            assert o["tally_prefill"] == meta("prefill")
            assert o["tally_decode"] == meta("decode")
    assert train["all-gather"]["count"] > 0
    if fsdp:
        assert train["reduce-scatter"]["count"] >= 3
        assert meta("decode")["all-gather"]["count"] >= 3
    else:
        plain = trace_collectives(cfg, InputShape("t", 16, 4, "train"), mesh)
        gathers = train["all-gather"]["count"] - plain["all-gather"]["count"]
        assert gathers == len({p.dtype for p in build_model(
            cfg, device="meta").parameters()}), (train, plain)


def test_gather_dim_and_its_reduce_scatter(runs):
    """``gather_dim`` along dimension 1 over "data" (2 ranks): the ranks'
    parts in coordinate order; its backward with ``partial`` the
    gradient summed over the axis and this rank's part kept (the
    reduce-scatter, counted once as one), without it this rank's part of
    its own gradient."""
    outs = runs["gather_dim"]
    x = [np.arange(24.0).reshape(2, 3, 4) + 100 * r for r in range(2)]
    w = [np.arange(48.0).reshape(2, 6, 4) * (r + 1) for r in range(2)]
    for rank, o in enumerate(outs):
        r = ProcessMesh.meta((2, 2), rank=rank).coords["data"]
        for partial in (True, False):
            np.testing.assert_array_equal(o[partial]["y"],
                                          np.concatenate(x, axis=1))
            g = (w[0] + w[1]) if partial else w[r]
            np.testing.assert_array_equal(o[partial]["g"],
                                          g[:, 3 * r:3 * r + 3])
        assert o["tally"]["all-gather"]["count"] == 2
        assert o["tally"]["reduce-scatter"] == {"count": 1,
                                                "bytes": 2 * 6 * 4 * 8}


def test_checkpoint_and_opt_state_round_trip_under_fsdp_and_zero2(tmp_path):
    """(2, 2), the qwen3 smoke: one process's checkpoint of whole tensors
    (the weights and the moments of one AdamW step) restored into each
    rank's shards under fsdp and under ZeRO-2 (``checkpoint.restore``
    with the axes): each shard at its template's shape and the shards
    put back together equal to the whole, bit for bit; the same moments
    through ``load_jax_opt_state``; each rank's own shards saved and
    restored bit for bit."""
    cfg = _tcfg("qwen3_4b")
    params = lm.pair("qwen3_4b")[1]
    model = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    step = lm.make_train_step(model, opt.AdamWConfig(**ADAMW))
    state = opt.init_state(step.params)
    step(state, {k: torch.as_tensor(v)
                 for k, v in _inputs("qwen3_4b")[3][0].items()})
    path = tmp_path / "whole"
    checkpoint.save(path, step.params, state, 1)
    whole = {k: v.detach().numpy() for k, v in flatten(
        {"params": step.params, "opt": state}, "/").items()}
    numpy = lambda t: tree_map(lambda v: v.detach().numpy(), t)
    full_opt = {"mu": numpy(state["mu"]), "nu": numpy(state["nu"]),
                "step": np.asarray(1, np.int32)}
    axes = {"params": model.param_axes()}
    for fsdp, zero2 in ((True, False), (False, True)):
        own = tmp_path / f"own_{fsdp}"
        outs = [r[0] for r in W.spawn(W.jobs_worker, (2, 2), tmp_path, [
            (W.checkpoint_worker, (cfg, params, str(path), full_opt, fsdp,
                                   zero2, str(own)))])]
        axes["opt"] = opt.state_axes(model.param_axes(), zero2)
        flat_axes = flatten(axes, "/")
        for o in outs:
            assert o["steps"] == (1, 1)
            for key, got in o["restored"].items():
                assert got.shape == o["template"][key], key
                np.testing.assert_array_equal(o["again"][key], got)
                if key in o["loaded"] and key != "opt/step":
                    np.testing.assert_array_equal(o["loaded"][key], got)
        for key, want in whole.items():
            if key == "opt/step":
                continue
            got = W.assemble([o["restored"][key] for o in outs],
                             flat_axes[key], want.shape, (2, 2), fsdp=fsdp)
            np.testing.assert_array_equal(got, want)
        cut = sum(outs[0]["restored"][k].shape != w.shape
                  for k, w in whole.items() if k.startswith("opt/mu/"))
        assert cut > 0


REF_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.launch.steps import make_train_step
from repro.models import build_model, get_config
from repro.models.config import InputShape
from repro.models.partitioning import logical_rules
from repro.training import optimizer as jopt
d = np.load(sys.argv[1])
mode = sys.argv[3]
params = {}
for k in d.files:
    if k.startswith("p/"):
        node, path = params, k[2:].split("/")
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = d[k]
batch = {"tokens": d["tokens"], "labels": d["labels"]}
cfg = dataclasses.replace(get_config("qwen3_4b", smoke=True), dtype="float32")
model = build_model(cfg)
shape = InputShape("t", batch["tokens"].shape[1], batch["tokens"].shape[0],
                   "train")
adamw = jopt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
leaf = lambda x: isinstance(x, tuple) and all(
    isinstance(e, (str, type(None))) for e in x)
with logical_rules(mesh, fsdp=mode == "fsdp") as rules:
    fn, sds, axes = make_train_step(model, shape, adamw,
                                    zero2=mode == "zero2")
    shard = jax.tree.map(
        lambda ax, s: jax.NamedSharding(mesh, rules.spec(ax, s.shape)),
        axes, sds, is_leaf=leaf)
    with mesh:
        new, state, met = jax.jit(fn, in_shardings=shard)(
            params, jopt.init_state(params), batch)
flat = jax.tree_util.tree_flatten_with_path(new)[0]
out = {"p/" + "/".join(str(k.key) for k in path): np.asarray(v)
       for path, v in flat}
out.update(loss=np.asarray(met["loss"]), grad_norm=np.asarray(met["grad_norm"]))
np.savez(sys.argv[2], **out)
"""


@functools.lru_cache(maxsize=None)
def _reference_sharded(tmp, mode):
    """The reference's jitted train step of the qwen3 smoke on 4 forced
    host devices under ``logical_rules(mesh, fsdp=True)`` ("fsdp") or
    with ZeRO-2's state axes ("zero2"), (2, 2), from the weights and the
    first batch of the spawns: the new parameters, loss and grad_norm."""
    params = lm.pair("qwen3_4b")[1]
    b = _inputs("qwen3_4b")[3][0]
    src = os.path.join(tmp, f"ref_{mode}_in.npz")
    dst = os.path.join(tmp, f"ref_{mode}.npz")
    np.savez(src, tokens=b["tokens"], labels=b["labels"],
             **{"p/" + k: np.asarray(v) for k, v in flatten(params, "/")
                .items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REF_SCRIPT, src, dst, mode],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(dst))


@pytest.mark.parametrize("mode", ["fsdp22", "zero22"])
def test_one_step_matches_the_reference_sharded_step(runs, mode,
                                                     tmp_path_factory):
    """The reference's own sharded train step (its jit under the rules,
    GSPMD's gathers and reduce-scatters) against the port's first step
    on the same mesh and rules, qwen3 smoke: loss and grad_norm within
    1e-5 relative, every parameter within 1e-5 of its leaf's largest
    |p| but for AdamW's eps jumps (second moment below (100 eps)^2 after
    the step, at most 2 lr)."""
    kind = "fsdp" if MODES[mode][1] else "zero2"
    ref = _reference_sharded(str(tmp_path_factory.mktemp("ref")), kind)
    outs = runs[mode]["qwen3_4b"]
    sizes, fsdp, _ = MODES[mode]
    for o in outs:
        got = o["train"][0]["metrics"]
        for k in ("loss", "grad_norm"):
            assert abs(got[k] / float(ref[k]) - 1) <= LOSS_REL, (k, got, ref)
    nu = _world1("qwen3_4b")[0][0]["nu"]
    p_axes = _param_axes("qwen3_4b")
    eps, loose, total = opt.AdamWConfig().eps, 0, 0
    for name, axes in p_axes.items():
        want = ref["p/" + name.replace(".", "/")]
        got = W.assemble([o["train"][0]["params"][name] for o in outs],
                         axes, want.shape, sizes, fsdp=fsdp)
        err = np.abs(got - want)
        off = err > 1e-5 * np.abs(want).max()
        assert not (off & (np.sqrt(nu[name]) >= 100 * eps)).any(), name
        assert (err[off] <= 2 * ADAMW["lr"]).all(), name
        loose += int(off.sum())
        total += want.size
    assert loose <= 1e-4 * total, (loose, total)


def test_one_sequence_under_fsdp_cuts_the_token_shift_on_embed(runs):
    """rwkv6 smoke, one sequence, FSDP on (4, 1): the batch of one stays
    whole, so its token shift state is cut on "embed" (d / 4 a rank);
    the decode gathers it, and 3 steps' logits and the state after them,
    put back together, match the reference's decode of the same state
    (2e-5 of the largest); the collectives equal the meta dry-run's."""
    outs = runs["one_sequence"]
    cfg = _tcfg("rwkv6_1p6b")
    cache, steps = _one_sequence_inputs()
    jm, params, _ = lm.pair("rwkv6_1p6b")
    jp = jax.tree.map(jnp.asarray, params)
    jc = jax.tree.map(jnp.asarray, cache)
    jstep = jax.jit(jm.decode_step)
    want = []
    for tok, pos in steps:
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(pos)})
        want.append(np.asarray(jl))
    axes = build_model(cfg, device="meta").cache_axes(1, 16)
    for o in outs:
        assert o["shapes"][1][-1] == cfg.d_model // 4
        for got, w in zip(o["logits"], want):
            _close(got, w)
    for j, (w, ax) in enumerate(zip(jax.tree.leaves(jc), axes)):
        _close(W.assemble([o["cache"][j] for o in outs], ax, w.shape,
                          (4, 1), fsdp=True), np.asarray(w))
    meta = trace_collectives(cfg, InputShape("d", 16, 1, "decode"),
                             make_mesh((4, 1), ("data", "model")), fsdp=True)
    assert all(o["tally"] == meta for o in outs)
    assert meta["all-gather"]["count"] >= 3 + 2 * cfg.n_layers


@pytest.mark.parametrize("sizes", [(2, 2), (4, 1), (2, 2, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_drawn_weights_are_fsdp_shards_of_the_one_device_draw(arch, sizes):
    """Each rank's model drawn from seed 0 under fsdp (built under a meta
    ProcessMesh at its coordinates: ``arch.draw_params`` cuts by
    ``Rules.spec``) holds every parameter at its fsdp local shape, and
    the shards put back together equal the one-device draw bit for bit;
    every weight whose "embed" dimension the data axis divides is cut."""
    cfg = get_config(arch, smoke=True)
    whole = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    full = {k: v.detach().float().numpy()
            for k, v in whole.named_parameters()}
    specs = flat_specs(whole.param_specs())
    names = W.AXES[-len(sizes):]
    parts = {k: [] for k in full}
    for r in range(4):
        mesh = ProcessMesh.meta(sizes, names, rank=r)
        with logical_rules(mesh, fsdp=True) as rules:
            m = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
        for k, p in m.named_parameters():
            s = specs[k]
            assert tuple(p.shape) == local_shape(
                s.shape, rules.spec(s.axes, shape=s.shape), mesh), k
            parts[k].append(p.detach().float().numpy())
    data = sizes[-2]
    for k, want in full.items():
        got = W.assemble(parts[k], specs[k].axes, want.shape, sizes,
                         fsdp=True)
        assert np.array_equal(got, want), k
        embed = any(a == "embed" and n % data == 0
                    for a, n in zip(specs[k].axes, want.shape))
        assert (parts[k][0].size < want.size) >= embed, k
