#!/usr/bin/env python3
"""Time the bounded weight draw against the stacked draw on one model.

    python3 tools/draw_time.py [--arch qwen3_4b] [--device cuda] [--smoke]

Builds ``--arch`` at full size on ``--device`` and fills its parameters
from seed 0 twice, in sorted-name order: the stacked draw (each weight
drawn whole on the host by ``ParamSpec.initialise``, then cut to the
rank's shard) and ``arch.draw_params`` (``arch.draw_into``: flat chunks
of at most ``DRAW_CHUNK`` elements).  It does so at one device and as
rank 0 of a (1, 4) mesh (a meta ``ProcessMesh``: the weights a rank of
``chip_smoke.py``'s ``dist`` phase holds), in the order stacked,
bounded, bounded, stacked, and prints each wall, the host's peak
resident memory after each pair, and whether both draws gave the same
bits.  Host only: the card just holds the weights.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def stacked(torch, model, seed):
    """The stacked draw: every weight whole, then the rank's shard."""
    from repro_torch.models.arch import flat_specs
    from repro_torch.models.partitioning import (current_rules,
                                                 is_process_mesh,
                                                 shard_slices)
    params = dict(model.named_parameters())
    rules = current_rules()
    sharded = rules is not None and is_process_mesh(rules.mesh)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, s in sorted(flat_specs(model.param_specs()).items()):
            full = s.initialise(g)
            if sharded:
                full = full[shard_slices(
                    s.shape, rules.spec(s.axes, shape=s.shape), rules.mesh)]
            params[name].copy_(full)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke size (a quick check)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.launch.mesh import ProcessMesh
    from repro_torch.models import build_model, get_config
    from repro_torch.models.arch import DRAW_CHUNK, draw_params
    from repro_torch.models.partitioning import logical_rules
    cfg = get_config(args.arch, smoke=args.smoke)
    out = {"arch": args.arch, "device": args.device,
           "draw_chunk": DRAW_CHUNK, "threads": torch.get_num_threads()}
    for tag, mesh in (("1x1", None), ("1x4 rank 0", ProcessMesh.meta((1, 4)))):
        with logical_rules(mesh):
            model = build_model(cfg, device=args.device)
            n = sum(p.numel() for p in model.parameters())
            times, sums, same = {"stacked": [], "bounded": []}, {}, True
            for kind in ("stacked", "bounded", "bounded", "stacked"):
                t0 = time.perf_counter()
                if kind == "stacked":
                    stacked(torch, model, 0)
                else:
                    draw_params(model, torch.Generator().manual_seed(0))
                if args.device == "cuda":
                    torch.cuda.synchronize()
                times[kind].append(time.perf_counter() - t0)
                sums[kind] = [p.detach().clone() for p in model.parameters()]
                if len(sums) == 2:
                    same &= all(torch.equal(a, b) for a, b in zip(
                        sums["stacked"], sums["bounded"]))
                    sums = {kind: sums[kind]}
            del model, sums
        out[tag] = dict(elements=n, stacked_s=times["stacked"],
                        bounded_s=times["bounded"], same_bits=same,
                        peak_rss_gib=resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)
        print(json.dumps({tag: out[tag]}), flush=True)
    print(json.dumps({"draw_time": out}), flush=True)
    return 0 if all(out[t]["same_bits"] for t in ("1x1", "1x4 rank 0")) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
