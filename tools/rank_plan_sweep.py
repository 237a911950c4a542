#!/usr/bin/env python3
"""Time the HSTU rank kernel on the card at the relay path's shapes, for
its own launch plan and for other (q_rows, cluster) plans.

    python3 tools/rank_plan_sweep.py                       # this tree's plan
    python3 tools/rank_plan_sweep.py --plans r1:80,8 r8:80,6
    python3 tools/rank_plan_sweep.py --root build/parent   # another tree

Shapes (H 4, D 64, float32, or bf16 with ``--dtype bfloat16``): ``h1``
/ ``h8`` the causal prefill (``hstu_attn``) of a 2048-token psi at B 1 /
8; ``r1`` / ``r8`` the rank over a dense 2048-token prefix with 16 incr +
64 items; ``r576`` the paper's 64 incr + 512 items at B 1; ``p8`` the
paged rank at B 8 with 64-token pages and chip_smoke's ragged lengths,
``p8f`` the same at full rows (every row 2048 tokens: ``r8``'s work),
``p1`` one row of 2048 tokens; ``s1`` / ``s8`` the segment rank on
chip_smoke's spans, ``s8f`` one 2048-token span a row at B 8 (``p8f``'s
work); ``rlong`` (not run by default) the B 8 rank over a 32768-token
prefix, whose long key loops show the kernel's steady state.  Each is
timed two ways, both with
CUDA events, by chip_smoke.py's own timers: ``graph``, 20 launches
captured in a CUDA graph and replayed 5 times, the least of 3 samples
(the card's time per launch, no host in it), and ``call``, 20
back-to-back wrapper calls (host included), the least of 3 samples,
with the most beside it as ``call_max`` (the host's time varies from
sample to sample far more than the card's).  ``--root`` times another
tree's kernels (its ``src/``) with this tree's timers and inputs.  A plan
given as ``shape:q_rows,cluster`` (cluster at most 8, the kernel's
portable cap) replaces ``kernels/cuda_lib.py::rank_launch_plan`` for
that shape only.  This is the measurement behind
``RANK_TILES_PER_BLOCK`` and ``RANK_PLAN_CLUSTER``.  Prints one JSON
line and writes it to ``chiprun_out/rank_plan_sweep_<tag>.json``.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, D, P = 4, 64, 2048


def load_tree(root):
    """The kernel module of the tree at ``root`` (its ``src/``): chip_smoke,
    imported first for its timers, has already imported this tree's
    ``repro_torch``, so that package is dropped before the other's is
    imported."""
    import importlib
    sys.path.insert(0, os.path.join(os.path.abspath(root), "src"))
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    return importlib.import_module("repro_torch.kernels.cuda_lib")


def shapes(torch, cs, dtype):
    """name -> a call of the tree's kernel wrapper at that shape, its
    values of ``dtype``."""
    from repro_torch.kernels import hstu_attn as hk
    from repro_torch.kernels import paged_prefix_attn as pk
    from repro_torch.kernels import prefix_rank_attn as rk
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)
    fns = {}
    for B in (1, 8):
        q, k, v = (randn(B, H, P, D) for _ in range(3))
        fns[f"h{B}"] = lambda q=q, k=k, v=v: hk.hstu_attn(q, k, v)
    for name, B, n_incr, n_items in (("r1", 1, 16, 64), ("r8", 8, 16, 64),
                                     ("r576", 1, 64, 512)):
        Sq = n_incr + n_items
        q, kn, vn = (randn(B, H, Sq, D) for _ in range(3))
        kp, vp = randn(B, H, P, D), randn(B, H, P, D)
        fns[name] = (lambda q=q, kn=kn, vn=vn, kp=kp, vp=vp, n=n_incr:
                     rk.prefix_rank_attn_split(q, kp, vp, kn, vn, n_incr=n))
    # a prefix 16x the path's: each block's key loop is long, so the time
    # per tile is the loop's steady state, not its prologue and epilogue
    q, kn, vn = (randn(8, H, 80, D) for _ in range(3))
    kp, vp = randn(8, H, 16 * P, D), randn(8, H, 16 * P, D)
    fns["rlong"] = lambda: rk.prefix_rank_attn_split(q, kp, vp, kn, vn,
                                                     n_incr=16)
    n_pages = P // 64
    for name, lens in (("p8", cs.RAGGED), ("p8f", [P] * 8), ("p1", [P])):
        B = len(lens)
        pool = randn(2 * B * n_pages + 1, 64, H, D)
        pool[-1] = 0
        perm = torch.randperm(2 * B * n_pages, generator=gen, device=dev).int()
        kt, vt = perm[:B * n_pages].view(B, -1), perm[B * n_pages:].view(B, -1)
        plens = torch.tensor(lens, dtype=torch.int32, device=dev)
        q, kn, vn = (randn(B, H, 80, D) for _ in range(3))
        fns[name] = (lambda q=q, pool=pool, kt=kt, vt=vt, plens=plens, kn=kn,
                     vn=vn: pk.paged_prefix_rank_attn(
                         q, pool, pool, kt, vt, plens, kn, vn, n_incr=16))
        if name == "p8f":               # one 2048-token span a row
            pos = (torch.arange(n_pages, dtype=torch.int32, device=dev)
                   * 64).expand(B, n_pages).contiguous()
            valid = torch.full_like(pos, 64)
            qpos = (P + torch.arange(80, dtype=torch.int32, device=dev)
                    ).expand(B, 80)
            fns["s8f"] = (lambda q=q, pool=pool, kt=kt, vt=vt, kn=kn, vn=vn:
                          pk.segment_rank_attn(q, pool, pool, kt, vt, pos,
                                               valid, qpos, kn, vn,
                                               n_items=64))
    for B in (1, 8):
        a = cs._segment_inputs(torch, gen, B)
        a = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in a.items() if k != "n_items"}
        fns[f"s{B}"] = lambda a=a: pk.segment_rank_attn(**a, n_items=64)
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose kernels to time (default: this one)")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--shapes", default="h1,h8,r1,r8,r576,p8,s1,s8")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--plans", nargs="*", default=[],
                    help="shape:q_rows,cluster plans to time as well")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this tree's timers and inputs
    import torch
    if not torch.cuda.is_available():
        print("rank_plan_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    cuda_lib = load_tree(args.root)  # the timed tree's kernels
    dtype = getattr(torch, args.dtype)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cuda_lib.library()
    fns = shapes(torch, cs, dtype)
    extra = {}
    for spec in args.plans:
        name, plan = spec.split(":")
        extra.setdefault(name, []).append(tuple(int(x) for x in plan.split(",")))
    own = getattr(cuda_lib, "rank_launch_plan", None)
    def timed(fn):
        calls = [cs._time_ms(torch, fn) for _ in range(3)]
        return dict(graph=cs._graph_ms(torch, fn), call=min(calls),
                    call_max=max(calls))

    out = {}
    for name in args.shapes.split(","):
        fn = fns[name]
        out[name] = timed(fn)
        for plan in extra.get(name, []):
            cuda_lib.rank_launch_plan = lambda n_prefix, Sq, plan=plan: plan
            try:
                out[f"{name}@{plan[0]},{plan[1]}"] = timed(fn)
            finally:
                cuda_lib.rank_launch_plan = own
    line = json.dumps({"tag": args.tag, "card": card, "dtype": args.dtype,
                       "kernels": cuda_lib.__file__, "ms": out})
    print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"rank_plan_sweep_{args.tag}.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
