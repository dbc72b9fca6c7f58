"""Device resolution and card facts.

Every function of the port that allocates takes an explicit `device`;
`resolve` turns it into a `torch.device` and refuses a CUDA device when no
card is present, so nothing silently runs on the CPU instead.
"""

from __future__ import annotations

import subprocess

import torch


def resolve(device) -> torch.device:
    """`device` (str or torch.device) -> torch.device. Raises on `cuda`
    without a card and on device types the port does not support."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def card_name_and_power_limit() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card). Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]
