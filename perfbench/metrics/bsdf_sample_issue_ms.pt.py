"""Path tracer: mean host ms a window frame issuing the BSDF samples: the
program's `pt.bsdf_sample` spans (each bounce's BSDF sample, its weight
and Russian roulette), summed over the frame, from pass_ms. A frame
without the span counts 0; None where no frame holds one (a program
without the span)."""


def read(ctx):
    frames = ctx["pass_ms"]
    if not any("pt.bsdf_sample" in p for p in frames):
        return None
    return sum(p.get("pt.bsdf_sample", 0.0) for p in frames) / len(frames)
