"""Alpha loops: mean host ms a window frame blocked in the hop loops'
device reads (the program's `pt.alpha_read` spans, summed over the frame),
from pass_ms. 0 in a frame without a hop loop read (no masked material);
None where no frame holds a `pt.chunk` span (a program without the spans)."""


def read(ctx):
    frames = ctx["pass_ms"]
    if not any("pt.chunk" in p for p in frames):
        return None
    return sum(p.get("pt.alpha_read", 0.0) for p in frames) / len(frames)
