"""CUDA graphs for the port's serve entry points: the counterpart of the
reference's ``jax.jit`` + ``warmup`` (``repro.core.executors``).

A ``GraphRunner`` holds one captured ``torch.cuda.CUDAGraph`` per launch
key (entry point, batch, shapes...), with the graph's static inputs and
outputs.  ``run(key, fn, args, refs)`` computes ``fn(*refs, *args)``:

* the first time a key is seen, ``fn`` runs eagerly once on a side
  stream over static copies of ``args`` (this builds and loads the
  kernel library, sets each kernel's shared-memory opt-in and warms
  cuBLAS, as PyTorch's graph recipe asks), and that run's result is the
  answer; then ``fn`` is captured over the same static tensors;
* after that, ``args`` are copied into the static inputs (tensors that
  already are the static ones are skipped) and the graph is replayed.
  The outputs returned are the graph's static outputs: the next replay
  of that key overwrites them, and the replay of another key may too
  (every graph of a runner allocates from one memory pool), so a caller
  clones what it keeps right after the call.

``refs`` are captured by reference, never copied: a page pool that
rank launches read in place, a decode cache that the step updates in
place.  A replay with another tensor than the captured one raises.
Callers put a reference's storage in the key.

Launch counters.  Each kernel wrapper counts its launches in Python
(``COUNTERS``).  A capture runs the wrappers without running anything on
the device, and a replay runs no Python, so the runner snapshots the
counters around the capture, keeps the difference as the graph's
``tally``, puts the counters back, and adds the tally on every replay.
The eager warm-up before a capture counts as the eager run it is.  So a
request stream shows the same counts with graphs on and off.

Nothing falls back: a capture or replay that fails raises, and a runner
refuses a device other than CUDA.
"""

from __future__ import annotations

import gc
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

import torch

from repro_torch.kernels import (decode_attn, hstu_attn, paged_prefix_attn,
                                 prefix_rank_attn, ssd_chunk)
from repro_torch.tree import leaves, tree_map

# kernel name -> (wrapper module, counter attribute)
COUNTERS = {
    "hstu_attn": (hstu_attn, "launches"),
    "prefix_rank_attn": (prefix_rank_attn, "launches"),
    "paged_prefix_rank_attn": (paged_prefix_attn, "launches"),
    "segment_rank_attn": (paged_prefix_attn, "launches_segment"),
    "ssd_chunk_intra": (ssd_chunk, "launches_intra"),
    "ssd_chunk_state": (ssd_chunk, "launches_state"),
    "decode_attn": (decode_attn, "launches"),
}


def read_counters() -> Dict[str, int]:
    return {n: getattr(m, a) for n, (m, a) in COUNTERS.items()}


def write_counters(values: Dict[str, int]) -> None:
    for n, (m, a) in COUNTERS.items():
        setattr(m, a, values[n])


def tallied(fn: Callable[[], Any]) -> Tuple[Any, Dict[str, int]]:
    """Run ``fn()`` and return (its result, the launches it counted by
    kernel), with every counter put back as it was before: what a
    capture does, since a captured launch has not run."""
    before = read_counters()
    try:
        out = fn()
        after = read_counters()
    finally:
        write_counters(before)
    return out, {n: after[n] - before[n] for n in before
                 if after[n] != before[n]}


def add_tally(tally: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` runs of a graph whose launches are ``tally``."""
    for n, c in tally.items():
        m, a = COUNTERS[n]
        setattr(m, a, getattr(m, a) + c * times)


def tensor_leaves(tree) -> list:
    out = leaves(tree)
    for x in out:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"graph inputs are tensors, got {type(x)}")
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


class Graph:
    """One captured launch: static inputs ``args``, captured references
    ``refs``, static ``outputs``, the kernel launches one replay makes
    (``tally``), and how often it was replayed."""

    def __init__(self, key, graph, args, refs, outputs, tally):
        self.key = key
        self.batch = key[1]          # keys are (entry point, batch, ...)
        self.graph = graph
        self.args = args
        self.refs = refs
        self.outputs = outputs
        self.tally = tally
        self.replays = 0

    def replay(self, args=None, refs=()):
        """Copy ``args`` into the static inputs, check that ``refs`` are
        the captured tensors, replay, and count the graph's launches.
        Returns the static outputs."""
        if len(refs) != len(self.refs) or not all(
                _same(r, s) for r, s in zip(refs, self.refs)):
            raise ValueError(f"graph {self.key}: replayed against other "
                             f"tensors than it captured by reference")
        if args is not None:
            new, static = tensor_leaves(args), tensor_leaves(self.args)
            if len(new) != len(static):
                raise ValueError(f"graph {self.key}: {len(new)} inputs, "
                                 f"captured {len(static)}")
            for a, s in zip(new, static):
                if a is s:
                    continue
                if a.shape != s.shape or a.dtype != s.dtype:
                    raise ValueError(
                        f"graph {self.key}: input {tuple(a.shape)} "
                        f"{a.dtype} != captured {tuple(s.shape)} {s.dtype}")
                s.copy_(a)
        self.graph.replay()
        add_tally(self.tally)
        self.replays += 1
        return self.outputs


class GraphRunner:
    """CUDA graphs keyed by launch shape, on one CUDA device, sharing
    one memory pool.  ``captures`` counts graphs captured while warming
    up (``warming`` set) and lazily, at a key's first hit."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: Dict[Hashable, Graph] = {}
        self.captures = {"warmup": 0, "lazy": 0}
        self.warming = False
        self._reship: Optional[torch.Tensor] = None

    def get(self, key) -> Optional[Graph]:
        return self.graphs.get(key)

    def reship_buffer(self, shape, dtype) -> torch.Tensor:
        """The device tensor a host page pool is re-shipped into before a
        paged launch: one static pool that the paged graphs read by
        reference (reallocated when the pool's shape or type changes,
        which gives its graphs new keys)."""
        t = self._reship
        if t is None or tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            t = self._reship = torch.empty(tuple(shape), dtype=dtype,
                                           device=self.device)
        return t

    def run(self, key, fn: Callable, args=(), refs=()):
        """``fn(*refs, *args)``, replayed from the key's graph (captured
        at the key's first hit, whose answer is the eager warm-up's)."""
        g = self.graphs.get(key)
        if g is None:
            return self.capture(key, fn, args, refs)
        return g.replay(args, refs)

    def capture(self, key, fn: Callable, args=(), refs=()):
        """Warm ``fn`` up eagerly on the side stream over static copies
        of ``args`` (counted), then capture it over the same tensors (not
        counted: its launches become the graph's tally).  Returns the
        warm-up's outputs."""
        if key in self.graphs:
            raise KeyError(f"graph {key} is already captured")
        main = torch.cuda.current_stream(self.device)
        static = tree_map(lambda t: t.to(self.device, copy=True), args)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            out = fn(*refs, *static)
        for t in tensor_leaves(out):
            t.record_stream(main)
        main.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()

        def record():
            # torch.cuda.graph() would also synchronize the device and
            # empty the allocator's cache at every capture, which a lazy
            # capture on the serving path cannot afford.  The garbage
            # collector is held off meanwhile: a graph it destroyed
            # mid-capture (another runner's, freed with its executor)
            # would invalidate the capture
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(self.stream):
                    graph.capture_begin(pool=self.pool)
                    try:
                        outputs = fn(*refs, *static)
                    finally:
                        graph.capture_end()
            finally:
                if gc_on:
                    gc.enable()
            return outputs

        outputs, tally = tallied(record)
        self.graphs[key] = Graph(key, graph, static, tuple(refs), outputs,
                                 tally)
        self.captures["warmup" if self.warming else "lazy"] += 1
        return out

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this runner's graph pool
        (intermediates and static outputs of every graph)."""
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)


def resolve_runner(graphs, device) -> Optional[GraphRunner]:
    """The runner an executor or serve step uses.  ``graphs``: None for
    the default (graphs on a CUDA device, eager on the CPU), False for
    eager, True for graphs (raises off CUDA), or a ``GraphRunner`` to
    share (several executors over one model)."""
    device = torch.device(device)
    if isinstance(graphs, GraphRunner):
        if graphs.device != device:
            raise ValueError(f"graph runner on {graphs.device}, model on "
                             f"{device}")
        return graphs
    if graphs is None:
        graphs = device.type == "cuda"
    return GraphRunner(device) if graphs else None
