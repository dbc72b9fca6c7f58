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


def synchronize(device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` calls on the current CUDA
    stream, timed with CUDA events after `warmup` untimed calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_name_and_power_limit() -> str:
    """The card's name and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them (first card). Raises if nvidia-smi fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]
