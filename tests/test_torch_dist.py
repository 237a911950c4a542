"""The port under a process mesh, on the CPU, held against the JAX
package's unsharded results (and, for the expert-parallel MoE, against
the reference's own sharded path).

Every sharded run is a gloo world of 4 ranks on the CPU
(``tests/_dist_workers.py``: ``torch.multiprocessing`` spawns joined by
a ``file://`` store), each rank holding its shard of the weights and
its rows of the batch under ``logical_rules(mesh)``; its results are put
back together (``assemble``) and compared with the reference's.  Three
spawns carry every sharded check: (2, 2), (1, 4) and (4, 1).

Weights: the reference's init with ``tests/_lm_train.py``'s noise
(norm scales 1 + 0.1 N(0, 1), wq / wk at fan-in d), loaded whole into
each rank, which keeps its shard.  Tolerances (of the largest |value|
of the tensor compared): 2e-5 for logits, caches, psi and scores, 1e-4
for gradients; the loss 1e-5 relative.  Each rank sums the products of
its shard and the all-reduce adds the ranks' partial sums, an order of
float32 additions the reference does not use: observed within 1.2e-5
(the MoE's shared experts) of the largest value.
"""

import dataclasses
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
from repro_torch.launch.mesh import ProcessMesh, axis_groups
from repro_torch.launch.steps import make_serve_step, make_step
from repro_torch.models import arch, build_model, get_config, moe
from repro_torch.models.config import InputShape
from repro_torch.models.convert import state_from_tree
from repro_torch.models.partitioning import (local_shape, logical_rules,
                                             make_mesh)
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten

REL = 2e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-5
ADAMW = dict(lr=1e-3, warmup_steps=1, total_steps=10)
MOE_KW = dict(n_experts=8, top_k=1, dtype="float32")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _rng_inputs(cfg, seed, B=4):
    rng = np.random.default_rng(seed)
    prompt = {"tokens": rng.integers(0, cfg.vocab, (B, 16)).astype(np.int32)}
    steps = [(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
              (16 + i + np.arange(B) * 3).astype(np.int32)) for i in range(3)]
    return prompt, steps, lm.batch(cfg, B, 16, seed)


def _moe_inputs():
    """The smoke deepseek_moe_16b MoE with 8 experts, top-1, and a router
    skewed to expert 0 (x shifted by +0.5, router column 0 raised), so
    that expert 0's capacity binds: 64 tokens, 32 a data shard."""
    cfg = dataclasses.replace(get_config("deepseek_moe_16b", smoke=True),
                              **MOE_KW)
    g = torch.Generator().manual_seed(5)
    p = {k: s.initialise(g).numpy() for k, s in
         sorted(moe.moe_specs(cfg).items())}
    p["router"][:, 0] += 0.05
    x = (np.random.default_rng(5).normal(size=(4, 16, cfg.d_model))
         + 0.5).astype(np.float32)
    return cfg, p, x


EP_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.models import get_config, moe
from repro.models.partitioning import logical_rules
d = np.load(sys.argv[1])
cfg = dataclasses.replace(get_config("deepseek_moe_16b", smoke=True),
                          n_experts=8, top_k=1, dtype="float32")
p = {k[2:]: d[k] for k in d.files if k.startswith("p_")}
def f(p, x):
    y, aux = moe.moe_ffn(p, x, cfg)
    return y + moe.shared_expert_ffn(p, x, cfg), aux
# two jitted functions: a trace does not see the rules in its cache key
y1, aux1 = jax.jit(f)(p, d["x"])
with logical_rules(jax.make_mesh((2, 2), ("data", "model"))):
    y, aux = jax.jit(lambda p, x: f(p, x))(p, d["x"])
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux),
         y1=np.asarray(y1), aux1=np.asarray(aux1))
"""


def _reference_moe(tmp, p, x):
    """The reference's MoE on 4 forced host devices under a (2, 2) mesh
    (its expert-parallel shard_map) and on one device."""
    src, dst = os.path.join(tmp, "moe_in.npz"), os.path.join(tmp, "ref.npz")
    np.savez(src, x=x, **{f"p_{k}": v for k, v in p.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", EP_SCRIPT, src, dst],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(dst))


QWEN = dict(dtype="float32")


def _tcfg(arch_id):
    """The port's smoke config of ``lm.pair(arch_id)``'s models."""
    return lm.cfgs(arch_id, dtype="float32")[1]


TALLY_SHAPES = [InputShape("p", 16, 4, "prefill"),
                InputShape("d", 16, 4, "decode"),
                InputShape("t", 16, 4, "train")]
TALLY_ARCHS = ["qwen3_4b", "hstu_gr", "deepseek_moe_16b"]


def _tally_cases():
    return [(dataclasses.replace(get_config(a, smoke=True), dtype="float32"),
             s) for a in TALLY_ARCHS for s in TALLY_SHAPES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three spawns: (2, 2) with every workload, (1, 4) with the
    qwen3 smoke (2 kv heads on 4 ranks: replicated) and (4, 1) with the
    MoE's global rule."""
    tmp = tmp_path_factory.mktemp("dist")
    jq, qparams, _ = lm.pair("qwen3_4b", **QWEN)
    jh, hparams, _ = lm.pair("hstu_gr")
    qin = _rng_inputs(jq.cfg, 1)
    rng = np.random.default_rng(2)
    hin = ({"tokens": rng.integers(0, 512, (4, 32)).astype(np.int32)},
           rng.integers(0, 512, (4, 4)).astype(np.int32),
           rng.integers(0, 512, (4, 8)).astype(np.int32),
           lm.batch(jh.cfg, 4, 16, 3))
    mcfg, mp, mx = _moe_inputs()
    tcfg = _tcfg("qwen3_4b")
    train_batches = [lm.batch(tcfg, 4, 16, 10 + i) for i in range(2)]
    out22 = W.spawn(W.jobs_worker, (2, 2), tmp, [
        (W.lm_worker, (_tcfg("qwen3_4b"), qparams) + qin),
        (W.hstu_worker, (_tcfg("hstu_gr"), hparams) + hin),
        (W.moe_worker, (mcfg, mp, mx)),
        (W.train_worker, (tcfg, qparams, train_batches, ADAMW)),
        (W.gradient_worker, ()),
        (W.collectives_worker, (_tally_cases(),)),
        (W.multi_axis_worker, ()),
    ])
    out14 = W.spawn(W.lm_worker, (1, 4), tmp, _tcfg("qwen3_4b"), qparams,
                    *qin)
    out41 = W.spawn(W.moe_worker, (4, 1), tmp, mcfg, mp, mx)
    return {"22": out22, "14": out14, "41": out41, "qin": qin, "hin": hin,
            "moe": (mcfg, mp, mx), "train": (tcfg, qparams, train_batches),
            "tmp": tmp}


def _job(runs, i):
    return [r[i] for r in runs["22"]]


def _check_lm(outs, sizes, qin):
    jm, params, port = lm.pair("qwen3_4b", **QWEN)
    prompt, steps, train = qin
    tm = port()
    jp = jax.tree.map(jnp.asarray, params)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt["tokens"])})
    lg_ax = ("batch", None, "vocab")
    _close(W.assemble([o["prefill"] for o in outs], lg_ax, jl.shape, sizes),
           jl)
    jstep = jax.jit(jm.decode_step)
    for i, (tok, pos) in enumerate(steps):
        jl, jc = jstep(jp, jc, {"token": jnp.asarray(tok),
                                "pos": jnp.asarray(pos)})
        _close(W.assemble([o["decode"][i] for o in outs], lg_ax, jl.shape,
                          sizes), jl)
    for j, (want, ax) in enumerate(zip(jc, tm.cache_axes(4, 16))):
        _close(W.assemble([o["cache"][j] for o in outs], ax, want.shape,
                          sizes), want)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, train))
    for o in outs:
        assert abs((o["metrics"]["ce"] + o["metrics"]["aux"])
                   / float(jloss) - 1) <= LOSS_REL
        assert abs(o["metrics"]["ce"] / float(jmet["ce"]) - 1) <= LOSS_REL
    axes = W.param_axes_flat(tm)
    want = state_from_tree(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(outs[0]["grads"])
    for name, g in want.items():
        _close(W.assemble([o["grads"][name] for o in outs], axes[name],
                          g.shape, sizes), g, GRAD_REL)
    return outs[0]


def test_dense_on_data_and_model_axes_matches_reference(runs):
    """qwen3 smoke on (2, 2): 4 q and 1 kv head a rank, the vocab and the
    FFN halved, the batch halved; prefill logits, 3 decode steps, the
    cache, the loss and every gradient."""
    o = _check_lm(_job(runs, 0), (2, 2), runs["qin"])
    # one all-reduce for the embedding, two a layer (attention, FFN)
    L = get_config("qwen3_4b", smoke=True).n_layers
    assert o["tally_prefill"]["all-reduce"]["count"] == 1 + 2 * L
    assert o["tally_decode"]["all-reduce"]["count"] == 3 * (1 + 2 * L)


def test_dense_with_replicated_kv_heads_matches_reference(runs):
    """qwen3 smoke on (1, 4): 2 q heads a rank and 2 kv heads that 4 do
    not divide, so each rank reads the kv head its q heads use."""
    o = _check_lm(runs["14"], (1, 4), runs["qin"])
    assert set(o["metrics"]) == {"ce", "aux"}   # on every mesh


def test_hstu_matches_reference(runs):
    """hstu-gr smoke on (2, 2): one head a rank; the loss and every
    gradient, prefill logits, psi with its heads reassembled, and
    ``rank_with_cache`` over that psi."""
    outs = _job(runs, 1)
    jm, params, port = lm.pair("hstu_gr")
    tm = port()
    prompt, incr, items, train = runs["hin"]
    jp = jax.tree.map(jnp.asarray, params)
    jl, jpsi = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt["tokens"])})
    _close(W.assemble([o["prefill"] for o in outs], ("batch", None, "vocab"),
                      jl.shape, (2, 2)), jl)
    for j, (want, ax) in enumerate(zip(jpsi, tm.cache_axes(4, 32))):
        _close(W.assemble([o["psi"][j] for o in outs], ax, want.shape,
                          (2, 2)), want)
    js = jax.jit(jm.rank_with_cache)(jp, jpsi, jnp.asarray(incr),
                                     jnp.asarray(items))
    _close(W.assemble([o["scores"] for o in outs], ("batch", None, None),
                      js.shape, (2, 2)), js)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, train))
    assert abs(outs[0]["metrics"]["ce"] / float(jloss) - 1) <= LOSS_REL
    axes = W.param_axes_flat(tm)
    for name, g in state_from_tree(jax.tree.map(np.asarray,
                                                jgrads)).items():
        if name not in outs[0]["grads"]:        # off the loss's path
            assert not np.abs(g).any(), name
            continue
        _close(W.assemble([o["grads"][name] for o in outs], axes[name],
                          g.shape, (2, 2)), g, GRAD_REL)


def test_expert_parallel_moe_matches_the_reference_sharded_path(runs):
    """(2, 2): 4 experts a rank, each data shard's 32 tokens at capacity
    9 (the reference's shard_map rule), against the reference's
    expert-parallel run on 4 host devices; that run differs from the
    one-device run (capacity 17 from all 64 tokens) by more than 0.1,
    so the capacity rule is what the comparison holds."""
    cfg, p, x = runs["moe"]
    ref = _reference_moe(str(runs["tmp"]), p, x)
    assert np.abs(ref["y"] - ref["y1"]).max() > 0.1
    outs = _job(runs, 2)
    _close(W.assemble([o["y"] for o in outs], ("batch", None, None),
                      x.shape, (2, 2)), ref["y"])
    for o in outs:
        assert abs(o["aux"] / float(ref["aux"]) - 1) <= LOSS_REL


def test_moe_on_data_only_keeps_the_global_capacity(runs):
    """(4, 1): no expert parallelism; each rank's 16 tokens take the
    places and the capacity (17) of the whole 64-token batch, as the
    reference's one-device run."""
    cfg, p, x = runs["moe"]
    jcfg = dataclasses.replace(lm.jget("deepseek_moe_16b", smoke=True),
                               **MOE_KW)
    from repro.models import moe as jmoe
    jp = jax.tree.map(jnp.asarray, p)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    jy = jy + jmoe.shared_expert_ffn(jp, jnp.asarray(x), jcfg)
    outs = runs["41"]
    _close(W.assemble([o["y"] for o in outs], ("batch", None, None),
                      x.shape, (4, 1)), jy)
    for o in outs:
        assert abs(o["aux"] / float(jaux) - 1) <= LOSS_REL


def test_two_train_steps_on_data_and_model_axes_equal_world_one(runs):
    """2 AdamW steps of the qwen3 smoke on (2, 2) against the same steps
    on one process: each step's loss, CE and grad_norm (1e-5 relative),
    both moments (the clipped gradients and their squares: GRAD_REL of
    each leaf's largest), then every parameter within 1e-5 of its leaf's
    largest |p|.  Where a gradient is near AdamW's eps (1e-8) the update
    lr m / (sqrt(v) + eps) moves by up to lr for a 1e-9 change of the
    gradient, a change the order of float32 sums makes: the elements
    whose second moment is below (100 eps)^2 after any step may instead
    differ by up to the update's own bound, 2 lr a step, and at most one
    element in 10^4 does."""
    cfg, params, batches = runs["train"]
    model = build_model(cfg, device="cpu")
    lm.load_jax_params(model, params)
    step = lm.make_train_step(model, opt.AdamWConfig(**ADAMW))
    state = opt.init_state(step.params)
    want, low = [], {}
    for b in batches:
        want.append(step(state, {k: torch.as_tensor(v) for k, v in b.items()}))
        for name, v in flatten(state["nu"], ".").items():
            low[name] = torch.minimum(low.get(name, v), v).clone()
    outs = _job(runs, 3)
    for o in outs:
        for got, w in zip(o["metrics"], want):
            for k in ("loss", "ce", "grad_norm"):
                assert abs(got[k] / float(w[k]) - 1) <= 1e-5, (k, got, w)
            assert got["lr"] == w["lr"]
    axes = W.param_axes_flat(model)
    for key in ("mu", "nu"):
        for name, m in flatten(state[key], ".").items():
            _close(W.assemble([o[key][name] for o in outs], axes[name],
                              tuple(m.shape), (2, 2)), m.numpy(), GRAD_REL)
    eps, loose, total = opt.AdamWConfig().eps, 0, 0
    for name, p in flatten(step.params, ".").items():
        p = p.detach().numpy()
        got = W.assemble([o["params"][name] for o in outs], axes[name],
                         p.shape, (2, 2))
        sharp = low[name].sqrt().numpy() >= 100 * eps
        err = np.abs(got - p)
        off = err > 1e-5 * np.abs(p).max()
        assert not (off & sharp).any(), name
        assert (err[off] <= 2 * ADAMW["lr"] * len(batches)).all(), name
        loose += int(off.sum())
        total += p.size
    assert loose <= 1e-4 * total, (loose, total)


def test_enter_and_reduce_pass_gradcheck_and_the_naive_all_reduce_fails(runs):
    """On the model axis (2 ranks): ``enter`` / ``reduce`` pass
    ``gradcheck`` in float64 and give the true gradient of the
    replicated loss; ``torch.distributed.nn.functional.all_reduce`` in
    ``reduce``'s place fails it, its gradient's loss term scaled by the
    axis size."""
    for o in _job(runs, 4):
        assert o["ours_gradcheck"] and not o["naive_gradcheck"]
        np.testing.assert_allclose(o["ours"], o["true"], rtol=1e-12)
        np.testing.assert_allclose(o["naive"] - 1, 2 * (o["true"] - 1),
                                   rtol=1e-12)


def test_live_collectives_equal_the_meta_tally(runs):
    """For the qwen3, hstu-gr and deepseek smoke configs, prefill,
    decode and train: rank 0's live tally of one step equals the meta
    dry-run's (``dryrun.trace_collectives``) at the same shape and
    mesh, and every rank's equals rank 0's."""
    live = _job(runs, 5)
    mesh = make_mesh((2, 2), ("data", "model"))
    for i, (cfg, shape) in enumerate(_tally_cases()):
        want = trace_collectives(cfg, shape, mesh)
        assert want["total_bytes"] > 0
        for r in live:
            assert r[i] == want, (cfg.name, shape.kind, r[i], want)


def test_a_reduction_over_several_axes_is_one_collective(runs):
    """A sum over both axes of (2, 2) is one ``all_reduce`` over a group
    of all four ranks, tallied once, with the sum of every rank's
    value."""
    for o in _job(runs, 6):
        np.testing.assert_array_equal(o["y"], np.full(3, 1.0 + 2 + 3 + 4))
        assert o["calls"] == 1
        assert o["tally"]["all-reduce"] == {"count": 1, "bytes": 12}


def test_axis_groups_of_the_two_pod_mesh():
    """On 2 x 16 x 16 the batch axes (pod, data) group the 32 ranks
    of each model coordinate; the model axis groups 16 consecutive
    ranks."""
    sizes, names = (2, 16, 16), ("pod", "data", "model")
    groups = axis_groups(sizes, names, ("pod", "data"))
    assert len(groups) == 16
    for m, g in enumerate(groups):
        assert g == [p * 256 + d * 16 + m for p in range(2)
                     for d in range(16)]
    assert axis_groups(sizes, names, ("model",))[3] == list(range(48, 64))


# --- in one process: shards, refusals ---------------------------------------


@pytest.mark.parametrize("sizes", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("arch_id", ["hstu_gr", "qwen3_4b",
                                     "deepseek_moe_16b"])
def test_shards_have_the_rule_shapes_and_reassemble(arch_id, sizes):
    """Each rank's model (built under a meta ProcessMesh at its
    coordinates, drawn from seed 0) holds every parameter at the local
    shape ``Rules.spec`` implies, and the ranks' shards put back
    together equal the one-device draw bit for bit."""
    cfg = get_config(arch_id, smoke=True)
    whole = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    full = {k: v.detach().float().numpy() for k, v in
            whole.named_parameters()}
    specs = arch.flat_specs(whole.param_specs())
    parts = {k: [] for k in full}
    for r in range(4):
        mesh = ProcessMesh.meta(sizes, rank=r)
        with logical_rules(mesh) as rules:
            m = build_model(cfg, device="cpu").init(
                torch.Generator().manual_seed(0))
        for k, p in m.named_parameters():
            s = specs[k]
            assert tuple(p.shape) == local_shape(
                s.shape, rules.spec(s.axes, shape=s.shape), mesh), k
            parts[k].append(p.detach().float().numpy())
    sharded = 0
    for k, want in full.items():
        got = W.assemble(parts[k], specs[k].axes, want.shape, sizes)
        assert np.array_equal(got, want), k
        sharded += parts[k][0].shape != want.shape
    assert sharded >= 5 if sizes[1] > 1 else sharded == 0


def test_mesh_refuses_what_it_does_not_port():
    """Under a mesh of more than one device: the SSM, hybrid and enc-dec
    families, fsdp, ZeRO-2, a kv_seq-sharded decode, a CUDA graph, and
    the paged / segment ranks raise ``ValueError``; on a 1 x 1 mesh
    they build."""
    mesh = ProcessMesh.meta((2, 2))
    for a in ("rwkv6_1p6b", "zamba2_1p2b", "seamless_m4t_large_v2"):
        cfg = get_config(a, smoke=True)
        with logical_rules(mesh), pytest.raises(ValueError,
                                                match="item 10"):
            build_model(cfg, device="meta")
        with logical_rules(ProcessMesh.meta((1, 1))):
            build_model(cfg, device="meta")
    q = get_config("qwen3_4b", smoke=True)
    with logical_rules(mesh, fsdp=True), pytest.raises(ValueError,
                                                       match="fsdp"):
        build_model(q, device="meta")
    with logical_rules(mesh):
        model = build_model(q, device="meta")
        with pytest.raises(ValueError, match="ZeRO-2"):
            make_step(model, InputShape("t", 16, 4, "train"), zero2=True)
        with pytest.raises(ValueError, match="graph"):
            make_serve_step(model, graphs=True)
    with logical_rules(mesh, {"kv_seq": "data"}):
        model = build_model(q, device="meta")
        with pytest.raises(ValueError, match="kv_seq"):
            model.init_cache(1, 65536)
    with logical_rules(mesh):
        h = build_model(get_config("hstu_gr", smoke=True), device="meta")
        for fn in (h.rank_with_pages, h.rank_with_segments):
            with pytest.raises(ValueError, match="per instance"):
                fn(*([None] * (6 if fn == h.rank_with_segments else 5)))
