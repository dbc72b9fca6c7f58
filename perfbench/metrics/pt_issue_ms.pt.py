"""Path tracer: mean host ms a window frame issuing the path tracer's work:
the program's `pt.chunk` spans (each chunk of rays, summed over the frame)
less the `pt.alpha_read` spans inside them (the hop loops' blocking reads),
from pass_ms. A span that did not run in a frame counts 0 there; None
where no frame holds a `pt.chunk` span (a program without the spans)."""


def read(ctx):
    frames = ctx["pass_ms"]
    if not any("pt.chunk" in p for p in frames):
        return None
    return sum(p.get("pt.chunk", 0.0) - p.get("pt.alpha_read", 0.0) for p in frames) / len(frames)
