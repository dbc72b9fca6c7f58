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


def graph_of(fn, launches: int = 64):
    """A torch.cuda.CUDAGraph of `launches` calls of fn(), replayed once.
    fn is called once before the capture (builds, lazy module loads). A
    kernel wrapper's launch counter moves once per call at capture, not at
    replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_us(graph, launches: int, replays: int = 20) -> float:
    """Device microseconds a captured call takes with no host gap between
    calls: `replays` replays of `graph` (of `launches` calls) timed with
    CUDA events, divided by the calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (replays * launches)


def graph_us(fn, launches: int = 64, replays: int = 20) -> float:
    """Device microseconds a call of fn() takes, from `graph_of` and
    `replay_us`."""
    return replay_us(graph_of(fn, launches), launches, replays)


def device_us_by_op(fn, calls: int = 10) -> dict:
    """{operation: (device microseconds a launch, launches recorded)} from
    torch.profiler's CUDA activity over `calls` calls of fn (kernel names
    cut at their argument list). The mean is over the launches the
    profiler recorded, which can be fewer than those made."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us and ev.count:
            out[ev.key.replace("(anonymous namespace)::", "").split("(")[0]] = (us / ev.count,
                                                                              ev.count)
    return out


def gpu_clocks() -> str:
    """One sample of the first card's SM clock, power draw and power limit
    (`nvidia-smi --query-gpu=clocks.sm,power.draw,power.limit
    --format=csv,noheader`)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30,
    )
    return out.stdout.strip().splitlines()[0]
