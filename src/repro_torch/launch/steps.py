"""Serve-step factories (port of ``repro.launch.steps``).

``make_prefill_step(model)`` and ``make_serve_step(model)`` return the
callables a server drives: the prefill of a batch of prompts, and one
decode step against the returned cache.  The parameters live in the
model (an ``nn.Module``), so the steps take the batch (and the cache)
only.  The training step and the shape specs for the dry-run are still
to port (ROADMAP Queue 1, items 8 and 10).
"""

from __future__ import annotations


def make_prefill_step(model):
    """``prefill_step({"tokens": (B, S)}) -> (logits, cache)``."""

    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(model):
    """Decode: ONE new token per sequence against a KV cache / recurrent
    state.  ``serve_step(cache, {"token": (B, 1), "pos": (B,)}) ->
    (logits, cache)``."""

    def serve_step(cache, batch):
        return model.decode_step(cache, batch)

    return serve_step
