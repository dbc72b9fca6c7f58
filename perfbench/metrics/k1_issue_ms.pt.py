"""Kernels: mean host ms a window frame in the program's `pt.k1` spans (one
a traverse_wide call, summed over the frame), from pass_ms: K1's argument
preparation, launch and hit decode, and, in a traced run, the harness's K1
recorder (perfbench/trace.py), which wraps every launch inside the span
with its own argument binding, live-ray count and CUDA events. A span
that did not run in a frame counts 0 there; None where no frame holds a
`pt.chunk` span (a program without the spans)."""


def read(ctx):
    frames = ctx["pass_ms"]
    if not any("pt.chunk" in p for p in frames):
        return None
    return sum(p.get("pt.k1", 0.0) for p in frames) / len(frames)
