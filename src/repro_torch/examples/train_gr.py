"""Train the GR backbone on the synthetic next-item-prediction pipeline
(a few hundred steps, CPU-sized model), logging the training ledger —
loss / grad-norm / lr / s-per-step every --log-every steps — and writing
a checkpoint under ``build/`` (port of ``examples/train_gr.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_gr
on the card; arguments, if any, replace the defaults below (add
``--device cpu`` to them for the CPU).
"""
import sys
from pathlib import Path

from repro_torch.launch.train import main

CKPT = Path(__file__).resolve().parents[3] / "build" / "relaygr_ck" / "hstu"

if __name__ == "__main__":
    main(sys.argv[1:] or
         ["--arch", "hstu-gr", "--smoke", "--steps", "200",
          "--batch", "8", "--seq", "128", "--ckpt", str(CKPT)])
