"""The device a benchmark ran on, for its record."""

from __future__ import annotations

import subprocess

import torch


def describe(device: torch.device) -> dict:
    """Name, power limit (as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them) and count of the card; for the
    CPU, just that."""
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "card": None}
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={idx}"], capture_output=True, text=True, check=True)
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "card": smi.stdout.strip(), "count": torch.cuda.device_count()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
