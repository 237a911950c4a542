"""Rank workers of ``tests/test_torch_dist.py`` (no JAX: every spawned
rank imports this module).

``spawn(fn, sizes, tmp, *args)`` runs ``fn(mesh, *args)`` on every rank
of a gloo process mesh of ``sizes`` (data, model; three sizes: pod,
data, model) on the CPU, each rank
a ``torch.multiprocessing`` spawn joined through a ``file://`` store in
``tmp``, under ``logical_rules(mesh)``; each rank's return value comes
back through a file, in rank order.  A rank that raises fails the
spawn.  ``assemble`` puts the ranks' shards of a tensor back together.
"""

import itertools
import math
import os

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.launch.mesh import ProcessMesh, destroy
from repro_torch.launch.steps import (make_serve_step, make_train_step,
                                      sum_over_batch)
from repro_torch.models import build_model, moe
from repro_torch.models.convert import load_jax_params
from repro_torch.models.partitioning import (Rules, current_rules,
                                             logical_rules, shard, shard_batch,
                                             shard_slices, shard_tree,
                                             spec_tree)
from repro_torch.training import optimizer as opt
from repro_torch.tree import flatten, leaves, tree_map

_COUNT = itertools.count()
AXES = ("pod", "data", "model")


def spawn(fn, sizes, tmp, *args):
    world = math.prod(sizes)
    run = os.path.join(str(tmp), f"run{next(_COUNT)}")
    os.makedirs(run)
    mp.spawn(_entry, args=(fn, tuple(sizes), run, args), nprocs=world,
             join=True)
    return [torch.load(os.path.join(run, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, fn, sizes, run, args):
    torch.set_num_threads(1)
    mesh = ProcessMesh.init(sizes, AXES[-len(sizes):], backend="gloo",
                            init_method=f"file://{run}/store", rank=rank,
                            world_size=math.prod(sizes))
    try:
        with logical_rules(mesh):
            out = fn(mesh, *args)
        torch.save(out, os.path.join(run, f"out{rank}.pt"))
    finally:
        destroy()


def assemble(parts, axes, shape, sizes, names=None, overrides=None,
             fsdp=False):
    """The full (shape) array from every rank's shard (rank order) of a
    tensor with logical axes ``axes`` (under the default rules with
    ``overrides`` and ``fsdp``); asserts that each shard has its local
    shape and that ranks holding the same slice hold the same bits."""
    names = names or AXES[-len(sizes):]
    out = np.full(shape, np.nan, np.float64)
    for r, part in enumerate(parts):
        mesh = ProcessMesh.meta(sizes, names, rank=r)
        sl = shard_slices(shape, Rules(mesh, overrides, fsdp).spec(
            axes, shape=shape), mesh)
        part = np.asarray(part, np.float64)
        assert part.shape == out[sl].shape, (axes, part.shape, sl)
        seen = out[sl]
        assert np.isnan(seen).all() or np.array_equal(seen, part), axes
        out[sl] = part
    assert not np.isnan(out).any()
    return out


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else t


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _model(cfg, params):
    model = build_model(cfg, device="cpu")
    load_jax_params(model, params)
    return model


def _grads(model, batch):
    """loss, metrics and this rank's shard of every gradient (summed
    over the batch axes, as the train step does).  The backward runs on
    a thread of its own, as autograd runs a CUDA model's: the rules the
    caller set are not visible there, and the collectives and the
    recompute must not need them."""
    import threading
    model.requires_grad_(True)
    loss, metrics = model.loss(batch)
    err = []

    def backward():
        try:
            loss.backward()
        except BaseException as e:     # re-raised on the rank's thread
            err.append(e)
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    if err:
        raise err[0]
    named = dict(model.named_parameters())
    specs = flatten(spec_tree(current_rules(), model.param_axes(),
                              model.abstract_params()), ".")
    sum_over_batch([p.grad for p in named.values()],
                   [specs[k] for k in named])
    grads = {k: _np(p.grad) for k, p in named.items() if p.grad is not None}
    model.requires_grad_(False)
    return {k: float(v) for k, v in metrics.items()}, grads


def batch_axes(batch):
    """Every entry of a batch sharded on its first (batch) dimension."""
    return {k: ("batch",) + (None,) * (np.ndim(v) - 1)
            for k, v in batch.items()}


def lm_worker(mesh, cfg, params, prompt, steps, train):
    """Any family: the prefill's logits and cache, decode steps'
    logits, the cache after them (a tuple cache's leaves; None for a
    dict), the loss, its metrics and every gradient; the collectives of
    each part."""
    model = _model(cfg, params)
    out = {}
    logits, cache = model.prefill(_tensors(shard_batch(prompt,
                                                       batch_axes(prompt))))
    out["prefill"] = _np(logits)
    out["tally_prefill"] = mesh.collectives()
    mesh.reset_tally()
    out["decode"] = []
    for tok, pos in steps:
        lg, cache = model.decode_step(cache, _tensors(shard_batch(
            {"token": tok, "pos": pos},
            {"token": ("batch", None), "pos": ("batch",)})))
        out["decode"].append(_np(lg))
    out["cache"] = ([_np(c) for c in cache] if isinstance(cache, tuple)
                    else None)
    out["tally_decode"] = mesh.collectives()
    mesh.reset_tally()
    out["metrics"], out["grads"] = _grads(model, _tensors(shard_batch(
        train, batch_axes(train))))
    out["tally_loss"] = mesh.collectives()
    return out


def fsdp_worker(mesh, cfg, params, prompt, steps, batches, adamw, fsdp,
                zero2, rank_rows=None):
    """Under ``logical_rules(mesh, fsdp=fsdp)`` the model from the full
    ``params`` (this rank's shards); unless ``prompt`` is None the
    prefill's logits and cache leaves, HSTU's ``rank_with_cache`` scores
    over its psi (``rank_rows``: the global (incr, items)), the decode
    steps' logits and the cache leaves after them; then
    ``make_train_step(..., zero2=zero2)`` over ``batches``: each step's
    metrics, this rank's parameters and moments after it, and its
    collectives (each serve part's too)."""
    out = {}
    with logical_rules(mesh, fsdp=fsdp):
        model = _model(cfg, params)
        if prompt is not None:
            mesh.reset_tally()
            logits, cache = model.prefill(_tensors(shard_batch(
                prompt, batch_axes(prompt))))
            # copies: a decode step writes the caller's cache in place
            out.update(prefill=_np(logits), tally_prefill=mesh.collectives(),
                       cache_prefill=[_np(t).copy() for t in leaves(cache)])
            if rank_rows is not None:
                rows = shard_batch(dict(zip(("i", "t"), rank_rows)),
                                   {"i": ("batch", None), "t": ("batch", None)})
                out["scores"] = _np(model.rank_with_cache(
                    cache, torch.as_tensor(rows["i"]),
                    torch.as_tensor(rows["t"])))
            out["decode"] = []
            for tok, pos in steps:
                mesh.reset_tally()
                lg, cache = model.decode_step(cache, _tensors(shard_batch(
                    {"token": tok, "pos": pos},
                    {"token": ("batch", None), "pos": ("batch",)})))
                out["decode"].append(_np(lg))
            out.update(tally_decode=mesh.collectives(),
                       cache=[_np(t) for t in leaves(cache)])
        step = make_train_step(model, opt.AdamWConfig(**adamw), zero2=zero2)
        state = opt.init_state(step.params, step.specs, step.moment_specs)
        out["train"] = []
        for b in batches:
            mesh.reset_tally()
            m = step(state, _tensors(shard_batch(b, batch_axes(b))))
            out["train"].append(dict(
                metrics={k: float(v) for k, v in m.items()},
                tally=mesh.collectives(),
                **{key: {k: _np(v).copy()        # the step updates in place
                         for k, v in flatten(tree, ".").items()}
                   for key, tree in (("params", step.params),
                                     ("mu", state["mu"]),
                                     ("nu", state["nu"]))}))
        model.requires_grad_(False)
    return out


def fsdp_one_sequence_worker(mesh, cfg, params, cache, steps):
    """One sequence decoded under ``logical_rules(mesh, fsdp=True)``: the
    batch of one is whole on every rank, so a cache leaf with an "embed"
    dimension (RWKV6's token shift) is cut on it instead; this rank's
    shard of the global ``cache`` (numpy), each step's logits, the
    cache after the steps and the last step's collectives."""
    with logical_rules(mesh, fsdp=True):
        model = _model(cfg, params)
        local = tree_map(lambda a: torch.tensor(np.ascontiguousarray(a)),
                         shard_tree(cache, model.cache_axes(1, 16)))
        serve = make_serve_step(model, graphs=False)
        out = {"logits": [], "shapes": [tuple(t.shape) for t in
                                        leaves(local)]}
        for tok, pos in steps:
            mesh.reset_tally()
            lg, local = serve(local, {"token": torch.as_tensor(tok),
                                      "pos": torch.as_tensor(pos)})
            out["logits"].append(_np(lg))
        out["tally"] = mesh.collectives()
        out["cache"] = [_np(t) for t in leaves(local)]
        return out


def gather_dim_worker(mesh):
    """``gather_dim`` of this rank's (2, 3, 4) part along dimension 1
    over "data", its gradient ``partial`` and not: the forward, the
    gradients of sum(w * y) for a rank-dependent w, and the tally."""
    from repro_torch.models.partitioning import gather_dim
    r = mesh.coords["data"]
    x = torch.arange(24, dtype=torch.float64).reshape(2, 3, 4) + 100 * r
    w = torch.arange(2 * 3 * mesh.shape["data"] * 4, dtype=torch.float64
                     ).reshape(2, -1, 4) * (r + 1)
    out = {}
    for partial in (True, False):
        xx = x.clone().requires_grad_(True)
        y = gather_dim(xx, "data", 1, partial)
        (w * y).sum().backward()
        out[partial] = {"y": y.detach().numpy(), "g": xx.grad.numpy()}
    out["tally"] = mesh.collectives()
    return out


def checkpoint_worker(mesh, cfg, params, path, full_opt, fsdp, zero2,
                      own_dir):
    """Under ``logical_rules(mesh, fsdp=fsdp)``: the checkpoint of whole
    tensors at ``path`` restored into this rank's shards (``axes``), the
    reference optimizer state ``full_opt`` (numpy) loaded by
    ``load_jax_opt_state`` alike, then this rank's shards saved in
    ``own_dir`` and restored: the three flat, and the template's
    shapes."""
    own_path = os.path.join(own_dir, f"rank{mesh.rank}")
    from repro_torch.models.convert import load_jax_opt_state, param_tree
    from repro_torch.training import checkpoint
    with logical_rules(mesh, fsdp=fsdp):
        model = _model(cfg, params)
        step = make_train_step(model, zero2=zero2)
        template = {"params": param_tree(model),
                    "opt": opt.init_state(step.params, step.specs,
                                          step.moment_specs)}
        axes = {"params": model.param_axes(),
                "opt": opt.state_axes(model.param_axes(), zero2)}
        restored, n = checkpoint.restore(path, template, axes)
        loaded = load_jax_opt_state(model, full_opt, zero2)
        checkpoint.save(own_path, restored["params"], restored["opt"], n)
        again, m = checkpoint.restore(own_path, template)
    flat = lambda t: {k: _np(v) for k, v in flatten(t, "/").items()}
    return {"restored": flat(restored), "loaded": flat({"opt": loaded}),
            "again": flat(again), "steps": (n, m),
            "template": {k: tuple(v.shape)
                         for k, v in flatten(template, "/").items()}}


def kv_seq_worker(mesh, cfg, params, cache, seq_len, steps):
    """One sequence decoded under the kv_seq rule ("kv_seq" on "data", as
    the reference's dry-run sets it for a batch of one): this rank's
    shard of the global ``cache`` (a numpy tree), ``make_serve_step``
    over ``steps`` ((token, pos) pairs); each step's logits, the cache
    after them and the collectives of the last step."""
    with logical_rules(mesh, {"kv_seq": "data"}):
        model = _model(cfg, params)
        local = tree_map(lambda a: torch.tensor(np.ascontiguousarray(a)),
                         shard_tree(cache, model.cache_axes(1, seq_len)))
        serve = make_serve_step(model, graphs=False, seq_len=seq_len)
        out = {"logits": []}
        for tok, pos in steps:
            mesh.reset_tally()
            lg, local = serve(local, {"token": torch.as_tensor(tok),
                                      "pos": torch.as_tensor(pos)})
            out["logits"].append(_np(lg))
        out["tally"] = mesh.collectives()
        out["cache"] = tree_map(_np, local)
        return out


def hstu_worker(mesh, cfg, params, prompt, incr, items, train):
    """HSTU: prefill logits and psi, ``rank_with_cache`` over that psi,
    the loss and every gradient."""
    model = _model(cfg, params)
    ax = {"tokens": ("batch", None)}
    logits, psi = model.prefill(_tensors(shard_batch(prompt, ax)))
    rows = shard_batch({"incr": incr, "items": items},
                       {"incr": ("batch", None), "items": ("batch", None)})
    scores = model.rank_with_cache(psi, torch.as_tensor(rows["incr"]),
                                   torch.as_tensor(rows["items"]))
    metrics, grads = _grads(model, _tensors(shard_batch(
        train, {"tokens": ("batch", None), "labels": ("batch", None)})))
    return {"prefill": _np(logits), "psi": [_np(t) for t in psi],
            "scores": _np(scores), "metrics": metrics, "grads": grads}


def moe_worker(mesh, cfg, params, x):
    """``moe_ffn`` and ``moe_aux`` on this rank's rows of x and its
    shard of the MoE weights."""
    axes = {k: s.axes for k, s in moe.moe_specs(cfg).items()}
    p = {k: torch.as_tensor(shard(v, axes[k])) for k, v in params.items()}
    xl = torch.as_tensor(shard(x, ("batch", None, None)))
    y, routing = moe.moe_ffn(p, xl, cfg)
    y = y + moe.shared_expert_ffn(p, xl, cfg)
    return {"y": _np(y), "aux": float(moe.moe_aux(*routing, cfg))}


def train_worker(mesh, cfg, params, batches, adamw):
    """``make_train_step`` over ``batches``: each step's metrics, then
    this rank's shard of every parameter and of both moments."""
    model = _model(cfg, params)
    step = make_train_step(model, opt.AdamWConfig(**adamw))
    state = opt.init_state(step.params)
    ax = {"tokens": ("batch", None), "labels": ("batch", None)}
    metrics = [{k: float(v) for k, v in step(state, _tensors(
        shard_batch(b, ax))).items()} for b in batches]
    return {"metrics": metrics,
            **{key: {k: _np(v) for k, v in flatten(tree, ".").items()}
               for key, tree in (("params", step.params),
                                 ("mu", state["mu"]), ("nu", state["nu"]))}}


def param_axes_flat(model):
    return flatten(model.param_axes(), ".")


def collectives_worker(mesh, cases):
    """For each (cfg, shape) of ``cases``: the model drawn from seed 0,
    its step (``make_step``) run once on zeros of this rank's shards of
    its arguments, and the collectives it called."""
    from repro_torch.launch.steps import local_inputs, make_step, step_inputs
    out = []
    for cfg, shape in cases:
        model = build_model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))
        fn, arg_specs, arg_axes = make_step(model, shape)
        args = step_inputs(shape, local_inputs(arg_specs, arg_axes), "cpu")
        mesh.reset_tally()
        fn(*args)
        out.append(mesh.collectives())
    return out


def gradient_worker(mesh):
    """A replicated loss over "model", L = (sum_r x . w_r)^2 + sum(x)
    with w_r this rank's shard: ``torch.autograd.gradcheck`` in float64
    with respect to the replicated x through ``enter`` and ``reduce``
    (every rank perturbs x alike, so the numerical derivative is the
    replicated loss's), and the same with
    ``torch.distributed.nn.functional.all_reduce`` in ``reduce``'s
    place; the gradients of both against the true one."""
    import torch.distributed.nn.functional as dnn
    from repro_torch.models.partitioning import enter, reduce
    w_all = torch.randn(2, 3, generator=torch.Generator().manual_seed(3),
                        dtype=torch.float64)
    w = w_all[mesh.coords["model"]]
    x0 = torch.randn(3, generator=torch.Generator().manual_seed(4),
                     dtype=torch.float64)
    group = mesh.device_mesh.get_group("model")

    def ours(x):
        y = reduce((enter(x, "model") * w).sum(), "model")
        return y.square() + x.sum()

    def naive(x):
        y = dnn.all_reduce((enter(x, "model") * w).sum(), group=group)
        return y.square() + x.sum()

    out = {}
    for name, fn in (("ours", ours), ("naive", naive)):
        x = x0.clone().requires_grad_(True)
        out[f"{name}_gradcheck"] = torch.autograd.gradcheck(
            fn, (x,), eps=1e-6, atol=1e-8, raise_exception=False)
        fn(x).backward()
        out[name] = x.grad.numpy()
    out["true"] = (2 * (x0 * w_all.sum(0)).sum() * w_all.sum(0)
                   + 1).numpy()
    return out


def multi_axis_worker(mesh):
    """A sum over both axes of the mesh (``psum`` over ("data",
    "model")): its value, the ``dist.all_reduce`` calls it made and its
    tally."""
    import torch.distributed as dist
    from repro_torch.models.partitioning import psum
    calls = []
    real = dist.all_reduce

    def spy(*a, **kw):
        calls.append(kw.get("group"))
        return real(*a, **kw)
    dist.all_reduce = spy
    try:
        y = psum(torch.full((3,), float(mesh.rank + 1)), ("data", "model"))
    finally:
        dist.all_reduce = real
    return {"y": _np(y), "calls": len(calls), "tally": mesh.collectives()}


def jobs_worker(mesh, jobs):
    """Several workers in one spawn: ``[fn(mesh, *args) for fn, args in
    jobs]``, each from an empty tally."""
    out = []
    for fn, args in jobs:
        mesh.reset_tally()
        out.append(fn(mesh, *args))
    return out


def cuda_hstu_worker(mesh, cfg, params, prompt, incr, items):
    """HSTU on the card (every rank on ``cuda:0``): prefill logits and
    psi, ``rank_with_cache`` scores, and this rank's kernel launches."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import prefix_rank_attn as rk
    model = build_model(cfg, device="cuda")
    load_jax_params(model, params)
    ax = {"p": ("batch", None), "i": ("batch", None), "t": ("batch", None)}
    rows = {k: torch.as_tensor(v, device="cuda") for k, v in shard_batch(
        {"p": prompt, "i": incr, "t": items}, ax).items()}
    before = hk.launches, rk.launches
    logits, psi = model.prefill({"tokens": rows["p"]})
    scores = model.rank_with_cache(psi, rows["i"], rows["t"])
    torch.cuda.synchronize()
    return {"logits": _np(logits.cpu()), "scores": _np(scores.cpu()),
            "psi0": _np(psi[0].cpu()), "psi1": _np(psi[1].cpu()),
            "launches": {"hstu_attn": hk.launches - before[0],
                         "prefix_rank_attn": rk.launches - before[1]}}
