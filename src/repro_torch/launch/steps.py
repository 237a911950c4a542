"""Train / serve step factories (port of ``repro.launch.steps``).

``make_train_step(model, adamw)`` returns one AdamW step on a batch;
``make_prefill_step(model)`` and ``make_serve_step(model)`` the
callables a server drives: the prefill of a batch of prompts, and one
decode step against a cache.  The parameters live in the model (an
``nn.Module``), so the steps take the optimizer state, the batch and the
cache only.  ``make_step(model, shape)`` picks the step of an
``InputShape`` and returns it with the (shape, dtype) stand-ins and the
logical axes of its arguments, the dry-run's view
(``repro_torch.launch.dryrun``).

The train step and the prefill run eagerly: at their lengths they keep
the device busy.  The decode step is host-bound, so on a CUDA device it
replays a CUDA graph per (batch, cache) key
(``repro_torch.core.graphs``).
"""

from __future__ import annotations

import torch

from repro_torch.core.graphs import tensor_leaves, resolve_runner
from repro_torch.models.arch import zeros_from_specs
from repro_torch.models.config import InputShape
from repro_torch.models.convert import param_tree
from repro_torch.models.partitioning import (active_axes, batch_axis,
                                             current_rules, local_spec_tree,
                                             psum, refuse_under_mesh,
                                             spec_axes, spec_tree)
from repro_torch.training import optimizer as opt
from repro_torch.tree import leaves, tree_map


def make_train_step(model, adamw: opt.AdamWConfig = None,
                    zero2: bool = False):
    """``train_step(state, batch) -> metrics``: ``model.loss`` on
    {"tokens", "labels"} (plus a VLM's "frontend" or an enc-dec's
    "frames", (B, F, d)), its gradient by autograd, and one
    ``opt.apply_updates`` that changes the model's parameters and
    ``state`` (``opt.init_state(param_tree(model))``) in place.  Metrics:
    ``loss``, ``ce``, a Transformer's ``aux`` (the MoE load-balance loss,
    zero for a dense model), ``grad_norm`` (device scalars) and ``lr``.
    Every family trains through it.  Turns the model's gradients on;
    ``train_step.params`` is its parameter tree.

    Under a process mesh (data- and tensor-parallel) the model holds
    this rank's shards and ``batch`` this rank's rows: ``loss`` is the
    rank's share of the global mean, the gradients are summed over the
    batch axes that do not shard their weight (``sum_over_batch``), the
    clip reads the global norm (``opt.global_norm`` with the weights'
    partition specs under the rules in force, FSDP's included) and the
    metrics are the global batch's (``ce`` summed over the batch axes,
    ``aux`` a global mean already).  ``zero2`` shards the moments over
    "data" (``opt.state_axes``): ``train_step.specs`` and
    ``train_step.moment_specs`` are the partition specs that
    ``opt.init_state`` takes to give the rank its part of them."""
    adamw = adamw or opt.AdamWConfig()
    model.requires_grad_(True)
    params = param_tree(model)
    grads_of = leaves(params)
    rules = current_rules()
    specs = m_specs = flat = None
    if rules is not None and rules.mesh is not None and rules.mesh.size > 1:
        axes, sds = model.param_axes(), model.abstract_params()
        specs = spec_tree(rules, axes, sds)
        flat = opt.leaves_of_specs(specs)
        if zero2:
            m_specs = spec_tree(rules, opt.state_axes(axes, True)["mu"], sds)

    def train_step(state, batch):
        for p in grads_of:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        sum_over_batch(leaves(grads), flat)
        with torch.profiler.record_function("adamw"):
            _, _, om = opt.apply_updates(adamw, params, grads, state,
                                         specs=specs, moment_specs=m_specs)
        metrics = {k: v.detach() for k, v in metrics.items()}
        # every family's loss is its CE plus a Transformer's MoE aux;
        # the metrics are already the global batch's
        return dict(metrics, **om,
                    loss=metrics["ce"] + metrics.get("aux", 0))

    train_step.params = params
    train_step.specs, train_step.moment_specs = specs, m_specs
    return train_step


def sum_over_batch(grads, specs=None):
    """Sum each gradient over the batch axes, in place: one all-reduce
    of the gradients of a (type, axes), flattened into one buffer.
    ``specs``: each gradient's partition spec (its weight's); a weight
    sharded over a batch axis (FSDP's "embed" on "data") had its
    gradient summed over that axis by its gather's backward
    (``arch.whole``), so it is summed over the other batch axes alone.
    Nothing without a process mesh that shards the batch."""
    bx = spec_axes(batch_axis())
    if not active_axes(bx):
        return
    groups = {}
    for i, g in enumerate(grads):
        if g is None:
            continue
        used = {a for m in specs[i] for a in spec_axes(m)} if specs else ()
        axes = tuple(a for a in bx if a not in used)
        if active_axes(axes):
            groups.setdefault((g.dtype, axes), []).append(g)
    for (_, axes), gs in groups.items():
        flat = psum(torch.cat([g.reshape(-1) for g in gs]), axes)
        i = 0
        for g in gs:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def make_prefill_step(model):
    """``prefill_step(batch) -> (logits, cache)``: ``batch`` is the
    model's prefill batch, {"tokens": (B, S)} plus a VLM's "frontend" or
    an enc-dec's "frames" (B, F, d)."""

    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(model, graphs=None, seq_len=None):
    """Decode: ONE new token per sequence against a KV cache / recurrent
    state.  ``serve_step(cache, {"token": (B, 1), "pos": (B,)}) ->
    (logits, cache)``.  ``seq_len``, the cache's global length, goes to
    every ``decode_step``: it tells a ring that the "kv_seq" rule shards
    over the ranks of a mesh (``arch.ring_axis``).

    ``graphs`` as ``LiveExecutor``'s: by default a CUDA device replays a
    CUDA graph per (batch, cache) key, False runs eagerly.  The graph's
    body is ``decode_step`` followed by copying every cache tensor it
    returned anew (the hybrid's recurrent states, an SSM stack's whole
    state, RWKV6's token shift included) into the caller's cache, leaf
    by leaf in ``tensor_leaves`` order (dict keys sorted), so a replay
    updates ``cache`` in place and returns it; what ``decode_step``
    writes in place or returns as it was (the hybrid's attention rings,
    a Transformer's whole cache, (k, v) or the int8 4-tuple, an
    enc-dec's self ring and cross K/V, and HSTU's psi) is left alone.
    The eager step returns what ``decode_step`` returns.  A key holds
    the cache's storage, so another cache of the same shapes is
    captured anew.  Under a process mesh of more than one device the
    step runs eagerly (``graphs=False``): graphs around collectives are
    not ported yet."""
    runner = resolve_runner(graphs, model.device)
    if runner is not None:
        refuse_under_mesh("a CUDA graph around collectives (pass "
                          "graphs=False)", "ROADMAP Queue 1, item 10: CUDA "
                                           "graphs around NCCL")

    def eager_step(cache, batch):
        return model.decode_step(cache, batch, seq_len=seq_len)

    if runner is None:
        return eager_step

    def body(cache, token, pos):
        logits, new = model.decode_step(cache, {"token": token, "pos": pos},
                                        seq_len=seq_len)
        for dst, src in zip(tensor_leaves(cache), tensor_leaves(new)):
            if dst is not src:
                dst.copy_(src)
        return logits

    def serve_step(cache, batch):
        token = torch.as_tensor(batch["token"], device=model.device)
        pos = torch.as_tensor(batch["pos"], device=model.device)
        refs = tensor_leaves(cache)
        key = ("decode", token.shape[0], tuple(token.shape),
               tuple((t.data_ptr(), tuple(t.shape)) for t in refs))
        logits = runner.run(
            key, lambda *a: body(cache, *a[-2:]), (token, pos), refs=refs)
        return logits.clone(), cache

    serve_step.runner = runner
    return serve_step


def cache_specs_and_axes(model, batch: int, seq_len: int):
    """The decode cache's (shape, dtype) tree and its logical axes
    (HSTU's ``cache_specs`` returns both, as the reference's does; the
    other families' return the specs alone, beside ``cache_axes``)."""
    specs = model.cache_specs(batch, seq_len)
    if model.cfg.hstu:
        specs = specs[0]
    return specs, model.cache_axes(batch, seq_len)


def make_step(model, shape: InputShape, zero2: bool = False):
    """The step of ``shape.kind`` with its arguments' stand-ins:
    ``(fn, arg_specs, arg_axes)``.

    ``arg_specs`` are (shape, dtype) trees, ``arg_axes`` the matching
    logical axes, in the reference's order: (params, opt state, batch)
    for train, (params, batch) for prefill, (params, cache, batch) for
    decode, the cache holding ``shape.seq_len`` tokens.  The parameters
    live in the model, so ``fn`` (``make_train_step`` /
    ``make_prefill_step`` / ``make_serve_step``) takes every argument
    but the first: ``fn(*step_inputs(shape, arg_specs, device))``.
    ``zero2`` shards the optimizer moments over "data"
    (``opt.state_axes``; the train step updates them so).  A train step
    turns the model's gradients on.  The stand-ins are global;
    ``local_inputs`` cuts them to one rank's shards under a process
    mesh."""
    p_sds, p_axes = model.abstract_params(), model.param_axes()
    b_sds, b_axes = model.batch_specs(shape), model.batch_axes(shape)
    if shape.kind == "train":
        return (make_train_step(model, zero2=zero2),
                (p_sds, opt.abstract_state(p_sds), b_sds),
                (p_axes, opt.state_axes(p_axes, zero2=zero2), b_axes))
    if shape.kind == "prefill":
        return make_prefill_step(model), (p_sds, b_sds), (p_axes, b_axes)
    c_sds, c_axes = cache_specs_and_axes(model, shape.global_batch,
                                         shape.seq_len)
    return (make_serve_step(model, seq_len=shape.seq_len),
            (p_sds, c_sds, b_sds), (p_axes, c_axes, b_axes))


def input_specs(model, shape: InputShape):
    """(shape, dtype) stand-ins for every argument of the step of
    ``shape``, the parameters first (``make_step``'s ``arg_specs``):
    nothing is allocated."""
    _, arg_specs, _ = make_step(model, shape)
    return arg_specs


def local_inputs(arg_specs, arg_axes):
    """``make_step``'s stand-ins as this rank's shards under the current
    rules (the parameters, optimizer state, batch and cache one device
    holds); the stand-ins themselves outside a process mesh."""
    return tuple(local_spec_tree(s, a) for s, a in zip(arg_specs, arg_axes))


def step_inputs(shape: InputShape, arg_specs, device="meta"):
    """The arguments ``fn`` takes (``arg_specs[1:]``) as zeros on
    ``device`` (on ``meta``: shapes only, nothing allocated).  A train
    step's optimizer step count is a host scalar, where
    ``opt.init_state`` keeps it."""
    args = [zeros_from_specs(s, device) for s in arg_specs[1:]]
    if shape.kind == "train":
        args[0]["step"] = torch.zeros((), dtype=torch.int32)
    return args
