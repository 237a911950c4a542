"""Training launcher: ``python -m repro_torch.launch.train --arch hstu-gr``
(port of ``repro.launch.train``).

Runs the synthetic next-item data pipeline -> train step -> checkpoint
loop on ``--device`` (``cuda`` unless told otherwise; ``--device cpu``
runs the plain PyTorch path) for any ``--arch`` of the registry: HSTU,
the Transformer family, the hybrid, the SSM stacks and the enc-dec.  A
VLM's batch gets zero ``frontend`` embeddings and an enc-dec's zero
``frames`` (B, F, d) in the model's type, as the reference's launcher
gives them.  Every ``--log-every`` steps, and at the last, it prints the
training ledger line: loss, grad norm, lr and seconds per step.  Weights
are random, drawn from a seeded ``torch.Generator``; the schedule warms
up over 20 steps and decays to ``--steps``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import UserBehaviorStore, WorkloadConfig
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model, get_config
from repro_torch.training import checkpoint
from repro_torch.training import optimizer as opt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hstu-gr")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    model = build_model(cfg, device=device).init(
        torch.Generator().manual_seed(0))
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"family={cfg.family} device={device}")

    adamw = opt.AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps)
    step_fn = make_train_step(model, adamw)
    state = opt.init_state(step_fn.params)
    store = UserBehaviorStore(WorkloadConfig(vocab=cfg.vocab))
    batches = store.train_batches(args.batch, args.seq)

    stub = {"vlm": "frontend", "encdec": "frames"}.get(cfg.family)
    t0 = time.time()
    for i in range(args.steps):
        batch = next(batches)
        if stub:
            batch[stub] = torch.zeros(
                (args.batch, cfg.n_frontend_tokens, cfg.d_model),
                dtype=model.tok.dtype, device=device)
        m = step_fn(state, batch)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss={float(m['loss']):.4f} "
                  f"grad_norm={float(m['grad_norm']):.3f} "
                  f"lr={m['lr']:.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
    if args.ckpt:
        checkpoint.save(args.ckpt, step_fn.params, state, step=args.steps)
        print(f"checkpoint -> {args.ckpt}")
    return float(m["loss"])


if __name__ == "__main__":
    main()
