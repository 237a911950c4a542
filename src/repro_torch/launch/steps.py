"""Serve-step factories (port of ``repro.launch.steps``).

``make_prefill_step(model)`` and ``make_serve_step(model)`` return the
callables a server drives: the prefill of a batch of prompts, and one
decode step against the returned cache.  The parameters live in the
model (an ``nn.Module``), so the steps take the batch (and the cache)
only.  The training step and the shape specs for the dry-run are still
to port (ROADMAP Queue 1, items 8 and 10).

The prefill runs eagerly: at the hybrid's prompt lengths it keeps the
device busy (host launch time is a few percent of it).  The decode step
is host-bound, so on a CUDA device it replays a CUDA graph per (batch,
cache) key (``repro_torch.core.graphs``).
"""

from __future__ import annotations

import torch

from repro_torch.core.graphs import tensor_leaves, resolve_runner


def make_prefill_step(model):
    """``prefill_step({"tokens": (B, S)}) -> (logits, cache)``."""

    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(model, graphs=None):
    """Decode: ONE new token per sequence against a KV cache / recurrent
    state.  ``serve_step(cache, {"token": (B, 1), "pos": (B,)}) ->
    (logits, cache)``.

    ``graphs`` as ``LiveExecutor``'s: by default a CUDA device replays a
    CUDA graph per (batch, cache) key, False runs eagerly.  The graph's
    body is ``decode_step`` followed by copying the new recurrent states
    into the caller's cache, so a replay updates ``cache`` in place and
    returns it (the attention rings are written in place either way);
    the eager step returns new state tensors and leaves ``cache["m"]``
    as it was.  A key holds the cache's storage, so another cache of the
    same shapes is captured anew."""
    runner = resolve_runner(graphs, model.device)

    def eager_step(cache, batch):
        return model.decode_step(cache, batch)

    if runner is None:
        return eager_step

    def body(cache, token, pos):
        logits, new = model.decode_step(cache, {"token": token, "pos": pos})
        for dst, src in zip(tensor_leaves(cache["m"]), tensor_leaves(new["m"])):
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
