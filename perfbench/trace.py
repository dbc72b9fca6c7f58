"""What the traced run (--trace 1) records besides the program's own spans
and counters: the shape and the device time of every K1 launch, and a
torch.profiler window over a few frames, read into device busy time,
the longest idle gaps and the device operations that took most time."""

from __future__ import annotations

import inspect

import torch

from perfbench.roofline import path_bytes

K1_KERNEL = "traverse_wide_kernel"


class K1Recorder:
    """Wraps the path tracer's `traverse_wide` (the K1 entry) while active:
    each launch's ray count, lane-mode flag, table bytes, the bytes of one
    root-to-leaf path and its live rays (t_min <= t_max: K1 retires the
    others before it reads a node), and CUDA events around it. The live
    count stays on the device until `launches()` reads it."""

    def __init__(self, pt_module):
        self.mod = pt_module
        self.orig = pt_module.traverse_wide
        self.sig = inspect.signature(self.orig)
        self.calls = []   # (n_rays, has_mode, table_bytes, path_bytes, live rays tensor)
        self.events = []

    def __enter__(self):
        orig, sig = self.orig, self.sig

        def recorded(*a, **kw):
            b = sig.bind(*a, **kw).arguments
            t = {k: b[k] for k in ("nodes", "meta", "records", "words")}
            tables = sum(int(x.numel()) * x.element_size() for x in t.values())
            path = path_bytes(*(tuple(x.shape) + (x.element_size(),) for x in t.values()))
            live = (b["t_min"] <= torch.as_tensor(b["t_max"], device=b["t_min"].device)).sum()
            self.calls.append((int(b["origin"].shape[0]), b.get("mode") is not None, tables,
                               path, live))
            timed = b["origin"].is_cuda
            if timed:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = orig(*a, **kw)
            if timed:
                ev[1].record()
                self.events.append(ev)
            return out

        self.mod.traverse_wide = recorded
        return self

    def __exit__(self, *exc):
        self.mod.traverse_wide = self.orig
        return False

    def launches(self):
        """[(n_rays, has_mode, table_bytes, path_bytes, live_rays)] as ints."""
        live = torch.stack([c[4] for c in self.calls]).tolist() if self.calls else []
        return [c[:4] + (int(n),) for c, n in zip(self.calls, live)]

    def event_mean_s(self):
        """Mean device seconds a launch by the CUDA events (a launch that
        waited for the host counts that wait), or None."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / len(self.events) / 1e3


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read_profile(prof, k1_launches: int, window_s: float, k1_mean_fallback=None):
    """Device facts of a profiled window.

    busy_s: the union of device intervals, plus the K1 launches the
    profiler did not record (counted launches - recorded) times K1's
    per-launch mean. Returns a dict with busy_s, window_s, k1_recorded,
    k1_mean_s (the profiler's per-launch mean, else the fallback) and the
    breakdown (top device ops by total seconds; longest idle gaps, named
    by the innermost host operation over the gap's middle)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    k1 = [e - s for s, e, n in dev if K1_KERNEL in n]
    k1_mean = (sum(k1) / len(k1) / 1e6) if k1 else k1_mean_fallback
    merged = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    dropped = max(k1_launches - len(k1), 0)
    if k1_mean is not None:
        busy += dropped * k1_mean
    by_op = {}
    for s, e, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    if merged:
        lo = min(s for s, _, _ in host) if host else merged[0][0]
        edges = [(lo, lo)] + merged
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b > a:
                gaps.append((a, b))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        covering = [(e - s, n) for s, e, n in host if s <= mid <= e]
        named.append([min(covering)[1] if covering else "no host op", (b - a) / 1e6])
    return {"busy_s": busy, "window_s": window_s, "k1_recorded": len(k1),
            "k1_dropped": dropped, "k1_mean_s": k1_mean,
            "breakdown": {"device_ops": [[n, s] for n, s in top_ops], "idle_gaps": named}}
