#!/usr/bin/env python3
"""Time ``ssd_chunk_intra`` on the card at the Zamba2 prefill shape, for
its own launch plan and for other heads-per-block plans.

    python3 tools/ssd_intra_sweep.py                       # this tree's plan
    python3 tools/ssd_intra_sweep.py --plans 4 16
    python3 tools/ssd_intra_sweep.py --root build/parent   # another tree

Shape: ``zamba2_1p2b``'s prefill of 2 x 8192 tokens in chunks of 128
(B 2, nc 64, Q 128, H 64, P 64, N 64, float32), inputs made as
chip_smoke.py makes them (``_ssd_inputs``: x, B, C normal, dt a softplus,
cum the cumulative log-decay).  Each plan is timed two ways, both with
CUDA events, by chip_smoke.py's own timers: ``graph``, 20 launches
captured in a CUDA graph and replayed 5 times, the least of 3 samples
(the card's time per launch, no host in it), and ``call``, 20
back-to-back wrapper calls (host included).  ``--root`` times another
tree's kernel (its ``src/``) with this tree's timers and inputs, so that
two trees compare in one process each, in turns, within one chip call.
A plan ``--plans H`` replaces ``kernels/cuda_lib.py::
ssd_intra_heads_per_block`` with H heads per block (a tree without that
function takes none).  The byte bound (x, B, C, cum, dt in, y out, at
3.35 TB/s) is printed beside.  Prints one JSON line and writes it to
``chiprun_out/ssd_intra_sweep_<tag>.json``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, NC, Q = 2, 64, 128


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose kernel to time (default: this one)")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--plans", nargs="*", type=int, default=[],
                    help="heads per block to time as well")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import chip_smoke as cs          # this tree's timers and inputs
    from rank_plan_sweep import load_tree
    import torch
    if not torch.cuda.is_available():
        print("ssd_intra_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    cuda_lib = load_tree(args.root)  # the timed tree's kernel
    from repro_torch.kernels import ssd_chunk as sk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cuda_lib.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    Cc, Bc, xc, cum, dtc = cs._ssd_inputs(torch, gen, B, NC, Q)
    fn = lambda: sk.ssd_chunk_intra(Cc, Bc, xc, cum, dtc)
    H, P, N = xc.shape[3], xc.shape[4], Bc.shape[3]
    nbytes = 4 * (2 * B * NC * Q * N + 2 * B * NC * Q * H * P
                  + 2 * B * NC * Q * H)
    own = getattr(cuda_lib, "ssd_intra_heads_per_block", None)
    out = {"own": dict(graph=cs._graph_ms(torch, fn),
                       call=cs._time_ms(torch, fn))}
    for hg in args.plans:
        if own is None:
            raise SystemExit(f"{args.root} has no ssd_intra_heads_per_block")
        cuda_lib.ssd_intra_heads_per_block = lambda H, hg=hg: hg
        try:
            out[f"hg{hg}"] = dict(graph=cs._graph_ms(torch, fn),
                                  call=cs._time_ms(torch, fn))
        finally:
            cuda_lib.ssd_intra_heads_per_block = own
    line = json.dumps({"tag": args.tag, "card": card,
                       "shape": dict(B=B, L=NC * Q, Q=Q, H=H, P=P, N=N),
                       "bound_ms": nbytes / cs.HBM_BW * 1e3, "ms": out})
    print(line, flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"ssd_intra_sweep_{args.tag}.json"), "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
