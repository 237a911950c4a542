"""Mixture-of-Experts FFN, in PyTorch (port of ``repro.models.moe``).

The reference's path without a mesh: a float32 router, softmax, top-k
with renormalised gates, a capacity-bounded dispatch over all experts
on one device, and the Switch load-balance auxiliary loss (``moe_aux``,
computed from the routing only when a caller asks for it).  The
reference computes the router and the expert products in plain jnp,
outside any Pallas kernel; here they are plain torch (the per-expert
GLU is one ``torch.bmm`` per weight over (E, capacity, d)).

Under a process mesh the reference's two branches (ref moe.py:100-143):

* expert-parallel, when the "model" axis has m > 1 devices and m
  divides E (the rank holds experts [r E/m, (r+1) E/m)): the rank
  dispatches all the tokens of its data shard to its own experts, with
  the capacity of that shard's token count, and the partial outputs
  are summed over "model" (the reference's ``shard_map`` and ``psum``);
* otherwise every rank holds every expert and the reference's
  semantics are the global batch's (GSPMD): a slot's place in its
  expert's buffer counts the earlier slots of the whole batch and the
  capacity is the whole batch's, so the per-expert slot counts of the
  data shards are gathered first.

The load-balance loss is a mean over the global batch either way, and
the shared experts are "ff"-sharded as ``layers.ffn``.

Nothing here syncs with the host, so a decode step through it can be
captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Dict

import torch

from .layers import ParamSpec, _act
from .partitioning import (axis_index, axis_size, batch_axis, enter, gather,
                           reduce, sharded_axis)

CAPACITY_FACTOR = 2.0


def moe_specs(cfg) -> Dict[str, ParamSpec]:
    d, e, f, dt = cfg.d_model, cfg.n_experts, cfg.d_expert, cfg.dtype
    specs = {
        "router": ParamSpec((d, e), ("embed", None), dtype="float32"),
        "wi": ParamSpec((e, d, f), ("experts", "embed", None), dtype=dt),
        "wg": ParamSpec((e, d, f), ("experts", "embed", None), dtype=dt),
        "wo": ParamSpec((e, f, d), ("experts", None, "embed"), dtype=dt),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * cfg.d_expert
        specs.update({
            "shared_wi": ParamSpec((d, fs), ("embed", "ff"), dtype=dt),
            "shared_wg": ParamSpec((d, fs), ("embed", "ff"), dtype=dt),
            "shared_wo": ParamSpec((fs, d), ("ff", "embed"), dtype=dt),
        })
    return specs


def _expert_compute(x, gates, eidx, wi, wg, wo, capacity, act, first=0,
                    offset=None):
    """Capacity-bounded dispatch / GLU / combine over the El experts
    [first, first + El) that wi, wg (El, d, f), wo (El, f, d) hold.

    x (T, d); gates, eidx (T, k).  Slot (t, j) takes place ``pos`` in
    expert ``eidx[t, j]``'s buffer, ``pos`` an exclusive count over the
    flattened (t, j) order of the earlier slots sent to that expert,
    plus ``offset[e]`` (the slots of earlier data shards, under the
    global rule); a slot with ``pos >= capacity``, or for another
    rank's expert, is dropped (contributes zero).  The buffer has one
    row more than the capacity: every dropped slot writes zeros to
    expert 0's last row, whose result is discarded, and every kept
    (e, pos) holds exactly one slot, so the scatter is exact."""
    T, d = x.shape
    k = eidx.shape[-1]
    E = wi.shape[0]
    e = eidx.reshape(T * k) - first
    g = gates.reshape(T * k)
    mine = (e >= 0) & (e < E)
    e = torch.where(mine, e, 0)
    oh = ((e[:, None] == torch.arange(E, device=x.device))
          & mine[:, None]).long()
    pos = (oh.cumsum(0) - oh).gather(1, e[:, None])[:, 0]
    if offset is not None:
        pos = pos + offset[e]
    keep = mine & (pos < capacity)
    row = torch.where(keep, e * (capacity + 1) + pos, capacity)
    tok = torch.arange(T * k, device=x.device) // k
    xk = x[tok] * keep[:, None].to(x.dtype)
    x_disp = x.new_zeros(E * (capacity + 1), d).index_copy_(0, row, xk)
    x_disp = x_disp.view(E, capacity + 1, d)[:, :capacity]
    h = act(torch.bmm(x_disp, wg)) * torch.bmm(x_disp, wi)
    y_e = torch.bmm(h, wo)                                  # (E, cap, d)
    y_pad = torch.cat([y_e, y_e.new_zeros(E, 1, d)], 1).view(-1, d)
    y_slot = y_pad[row] * (g * keep.to(g.dtype))[:, None].to(y_e.dtype)
    return y_slot.view(T, k, d).sum(dim=1)


def moe_ffn(params, x, cfg):
    """x (B, S, d) -> (output (B, S, d), routing (probs (B, S, E)
    float32, eidx (B, S, k))).  The reference returns the auxiliary
    load-balance loss in the routing's place; here ``moe_aux`` computes
    it from the routing, so the serve path, which never reads it, does
    not pay for it.  Under a process mesh x holds this rank's rows of
    the batch (see the module docstring for the two branches)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    x2 = x.reshape(B * S, d)
    g2 = gates.reshape(B * S, k).to(x.dtype)
    i2 = eidx.reshape(B * S, k)
    wi, wg, wo = params["wi"], params["wg"], params["wo"]
    ep = sharded_axis(wi.shape[0], E, "experts")
    if ep:
        # the reference's shard_map: this rank's experts on its data
        # shard's tokens, the capacity of that shard
        cap = int(B * S * k / E * CAPACITY_FACTOR) + 1
        y = _expert_compute(enter(x2, ep), enter(g2, ep), i2, wi, wg, wo,
                            cap, _act(cfg.act),
                            first=axis_index(ep) * wi.shape[0])
        return reduce(y, ep).view(B, S, d), (probs, eidx)   # its psum
    bx = batch_axis()
    n = axis_size(bx)
    cap = int(B * S * n * k / E * CAPACITY_FACTOR) + 1
    offset = None
    if n > 1:
        # the global rule: the slots of the lower data shards come first
        counts = (i2.reshape(-1)[:, None] == torch.arange(
            E, device=x.device)).long().sum(0)
        every = gather(counts, bx)                              # (n, E)
        offset = every[:axis_index(bx)].sum(0)
    y = _expert_compute(x2, g2, i2, wi, wg, wo, cap, _act(cfg.act),
                        offset=offset)
    return y.view(B, S, d), (probs, eidx)


def moe_aux(probs, eidx, cfg):
    """The Switch-style load-balance auxiliary loss (a float32 scalar)
    from ``moe_ffn``'s routing; under a process mesh both means are the
    global batch's (this rank's sums, summed over the batch axes)."""
    E, k = cfg.n_experts, cfg.top_k
    chosen = eidx[..., None] == torch.arange(E, device=eidx.device)
    bx = batch_axis()
    if axis_size(bx) == 1:
        me = probs.mean(dim=(0, 1))                               # (E,)
        ce = chosen.float().sum(dim=2).mean(dim=(0, 1))           # (E,)
    else:
        n = probs.shape[0] * probs.shape[1] * axis_size(bx)
        me = reduce(probs.sum(dim=(0, 1)), bx) / n
        ce = reduce(chosen.float().sum(dim=(0, 1, 2)), bx) / n
    return cfg.router_aux_coef * E * torch.sum(me * ce) / k


def shared_expert_ffn(params, x, cfg):
    """The always-on shared experts: a GLU FFN of width ``n_shared *
    d_expert``, "ff"-sharded as ``layers.ffn``."""
    act = _act(cfg.act)
    tp = sharded_axis(params["shared_wi"].shape[1],
                      cfg.n_shared_experts * cfg.d_expert, "ff")
    if tp:
        x = enter(x, tp)
    h = act(x @ params["shared_wg"]) * (x @ params["shared_wi"])
    y = h @ params["shared_wo"]
    return reduce(y, tp) if tp else y
