"""Renderer: mean ms a window frame outside `skin_and_refit` and
`path_trace_scene`: the tone map and the u8 copy to the host (frame_ms
minus the two spans)."""


def read(ctx):
    rest = [f - p["skin_and_refit"] - p["path_trace_scene"]
            for f, p in zip(ctx["frame_ms"], ctx["pass_ms"])
            if "skin_and_refit" in p and "path_trace_scene" in p]
    return sum(rest) / len(rest) if rest else None
