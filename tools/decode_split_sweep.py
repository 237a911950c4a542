#!/usr/bin/env python3
"""Time the port's flash decode against SDPA over split counts, on the card.

    python3 tools/decode_split_sweep.py

At the Zamba2 decode shape (B 2, H = KV = 32, D 64, bf16, the cache one
section of a stacked 6-section ring) and S in {8192, 32768}, launch
``kernels/decode_attn.py::decode_attn`` with each split count of
``SPLITS`` (the split plan replaced for the run) and time it and
``scaled_dot_product_attention`` in turns: kernel, SDPA, SDPA, kernel,
twice, each sample 20 back-to-back calls between CUDA events, the
median of each.  At S 8192 it also times them with a cold L2 (a 192 MB
read before each single call).  The plan's own choice on this card is
printed first.  This is the measurement behind
``kernels/cuda_lib.py::DECODE_BLOCKS_PER_SM``.  Needs one CUDA card.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

SPLITS = (1, 2, 3, 4, 5, 8)
B, H, KV, D, SECTIONS = 2, 32, 32, 64, 6


def events_ms(torch, fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, kernel, library, sample):
    runs = {kernel: [], library: []}
    for fn in (kernel, library, library, kernel) * 2:
        runs[fn].append(sample(fn))
    return statistics.median(runs[kernel]), statistics.median(runs[library])


def main():
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_split_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import decode_attn as dk

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = cuda_lib.decode_split_plan
    flush = torch.ones(192 * 2 ** 20 // 4, device="cuda")

    def warm(fn):
        fn()
        torch.cuda.synchronize()
        return events_ms(torch, fn, 20)

    def cold(fn):
        times = []
        for _ in range(10):
            flush.sum()                        # evicts the L2 without dirtying it
            times.append(events_ms(torch, fn, 1))
        return statistics.median(times)

    gen = torch.Generator(device="cuda").manual_seed(1)
    try:
        for S in (8192, 32768):
            q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
            kc = torch.randn((SECTIONS, B, S, KV, D), generator=gen,
                             device="cuda").bfloat16()
            vc = torch.randn_like(kc)
            k, v = kc[2], vc[2]
            kernel = lambda: dk.decode_attn(q, k, v)
            sdpa = lambda: F.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                enable_gqa=True)
            print(f"S {S}: the plan on {n_sm} SMs gives "
                  f"{plan(B, KV, S, n_sm)} (n_split, keys_per_split)")
            for n in SPLITS:
                cuda_lib.decode_split_plan = \
                    lambda B_, KV_, S_, n_sm_, hg=1, n=n: (n, -(-S_ // n))
                cuda_lib._decode_template.cache_clear()
                km, lm = in_turns(torch, kernel, sdpa, warm)
                line = (f"S {S} splits {n} blocks {B * KV * n}: warm kernel "
                        f"{km:.4f} ms sdpa {lm:.4f} ms ratio {km / lm:.3f}")
                if S == 8192:
                    ck, cl = in_turns(torch, kernel, sdpa, cold)
                    line += (f" | cold kernel {ck:.4f} ms sdpa {cl:.4f} ms "
                             f"ratio {ck / cl:.3f}")
                print(line, flush=True)
            del kc, vc, k, v
    finally:
        cuda_lib.decode_split_plan = plan
        cuda_lib._decode_template.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
