"""Path tracer: mean ms a window frame in `path_trace_scene` (one sample a
pixel traced and accumulated), from Renderer.profile's pass_ms."""


def read(ctx):
    ms = [p["path_trace_scene"] for p in ctx["pass_ms"] if "path_trace_scene" in p]
    return sum(ms) / len(ms) if ms else None
