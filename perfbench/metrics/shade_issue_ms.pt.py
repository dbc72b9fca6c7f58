"""Path tracer: mean host ms a window frame issuing the shading of hits:
the program's `pt.shade` spans (hit attributes and surface properties) and
`pt.nee` spans (environment and punctual-light sampling, BSDF evaluation,
MIS), summed over the frame, from pass_ms. A span that did not run in a
frame counts 0 there; None where no frame holds a `pt.chunk` span (a
program without the spans)."""


def read(ctx):
    frames = ctx["pass_ms"]
    if not any("pt.chunk" in p for p in frames):
        return None
    return sum(p.get("pt.shade", 0.0) + p.get("pt.nee", 0.0) for p in frames) / len(frames)
