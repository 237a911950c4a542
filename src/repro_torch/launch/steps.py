"""Train / serve step factories (port of ``repro.launch.steps``).

``make_train_step(model, adamw)`` returns one AdamW step on a batch;
``make_prefill_step(model)`` and ``make_serve_step(model)`` the
callables a server drives: the prefill of a batch of prompts, and one
decode step against a cache.  The parameters live in the model (an
``nn.Module``), so the steps take the optimizer state, the batch and the
cache only.  The shape specs for the dry-run are still to port (ROADMAP
Queue 1, item 10).

The train step and the prefill run eagerly: at their lengths they keep
the device busy.  The decode step is host-bound, so on a CUDA device it
replays a CUDA graph per (batch, cache) key
(``repro_torch.core.graphs``).
"""

from __future__ import annotations

import torch

from repro_torch.core.graphs import tensor_leaves, resolve_runner
from repro_torch.models.convert import param_tree
from repro_torch.training import optimizer as opt
from repro_torch.tree import leaves, tree_map


def make_train_step(model, adamw: opt.AdamWConfig = None):
    """``train_step(state, batch) -> metrics``: ``model.loss`` on
    {"tokens", "labels"}, its gradient by autograd, and one
    ``opt.apply_updates`` that changes the model's parameters and
    ``state`` (``opt.init_state(param_tree(model))``) in place.  Metrics:
    ``loss``, ``ce``, ``grad_norm`` (device scalars) and ``lr``.  Turns
    the model's gradients on; ``train_step.params`` is its parameter
    tree."""
    adamw = adamw or opt.AdamWConfig()
    model.requires_grad_(True)
    params = param_tree(model)
    grads_of = leaves(params)

    def train_step(state, batch):
        for p in grads_of:
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        with torch.profiler.record_function("adamw"):
            _, _, om = opt.apply_updates(adamw, params, grads, state)
        return dict({k: v.detach() for k, v in metrics.items()}, **om,
                    loss=loss.detach())

    train_step.params = params
    return train_step


def make_prefill_step(model):
    """``prefill_step(batch) -> (logits, cache)``: ``batch`` is the
    model's prefill batch, {"tokens": (B, S)} plus a VLM's "frontend" or
    an enc-dec's "frames" (B, F, d)."""

    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(model, graphs=None):
    """Decode: ONE new token per sequence against a KV cache / recurrent
    state.  ``serve_step(cache, {"token": (B, 1), "pos": (B,)}) ->
    (logits, cache)``.

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
    captured anew."""
    runner = resolve_runner(graphs, model.device)

    def eager_step(cache, batch):
        return model.decode_step(cache, batch)

    if runner is None:
        return eager_step

    def body(cache, token, pos):
        logits, new = model.decode_step(cache, {"token": token, "pos": pos})
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
