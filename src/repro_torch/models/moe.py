"""Mixture-of-Experts FFN, in PyTorch (port of ``repro.models.moe``).

The reference's path without a mesh: a float32 router, softmax, top-k
with renormalised gates, a capacity-bounded dispatch over all experts
on one device, and the Switch load-balance auxiliary loss (``moe_aux``,
computed from the routing only when a caller asks for it).  The
reference computes the router and the expert products in plain jnp,
outside any Pallas kernel; here they are plain torch (the per-expert
GLU is one ``torch.bmm`` per weight over (E, capacity, d)).

Not ported: the reference's expert-parallel branch (``shard_map`` over
the mesh's "model" axis with a ``psum`` of the top-k contributions).
It waits for multi-GPU (ROADMAP Queue 1, item 10); this module always
computes every expert on the local device.

Nothing here syncs with the host, so a decode step through it can be
captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Dict

import torch

from .layers import ParamSpec, _act

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


def _expert_compute(x, gates, eidx, wi, wg, wo, capacity, act):
    """Capacity-bounded dispatch / GLU / combine over all E experts.

    x (T, d); gates, eidx (T, k); wi, wg (E, d, f), wo (E, f, d).  Slot
    (t, j) takes place ``pos`` in expert ``eidx[t, j]``'s buffer, ``pos``
    an exclusive count over the flattened (t, j) order of the earlier
    slots sent to that expert; a slot with ``pos >= capacity`` is
    dropped (contributes zero).  The buffer has one row more than the
    capacity: every dropped slot writes zeros to expert 0's last row,
    whose result is discarded, and every kept (e, pos) holds exactly one
    slot, so the scatter is exact."""
    T, d = x.shape
    k = eidx.shape[-1]
    E = wi.shape[0]
    e = eidx.reshape(T * k)
    g = gates.reshape(T * k)
    oh = (e[:, None] == torch.arange(E, device=x.device)).long()
    pos = (oh.cumsum(0) - oh).gather(1, e[:, None])[:, 0]
    keep = pos < capacity
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
    not pay for it."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(B * S * k / E * CAPACITY_FACTOR) + 1
    y = _expert_compute(x.reshape(B * S, d),
                        gates.reshape(B * S, k).to(x.dtype),
                        eidx.reshape(B * S, k), params["wi"], params["wg"],
                        params["wo"], cap, _act(cfg.act))
    return y.view(B, S, d), (probs, eidx)


def moe_aux(probs, eidx, cfg):
    """The Switch-style load-balance auxiliary loss (a float32 scalar)
    from ``moe_ffn``'s routing."""
    E, k = cfg.n_experts, cfg.top_k
    me = probs.mean(dim=(0, 1))                                   # (E,)
    chosen = eidx[..., None] == torch.arange(E, device=eidx.device)
    ce = chosen.float().sum(dim=2).mean(dim=(0, 1))               # (E,)
    return cfg.router_aux_coef * E * torch.sum(me * ce) / k


def shared_expert_ffn(params, x, cfg):
    act = _act(cfg.act)
    h = act(x @ params["shared_wg"]) * (x @ params["shared_wi"])
    return h @ params["shared_wo"]
