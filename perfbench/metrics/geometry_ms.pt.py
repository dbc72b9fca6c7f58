"""Renderer: mean ms a window frame in `skin_and_refit` (Renderer.profile's
span: pose, world rebuild on the device, table swap), from pass_ms."""


def read(ctx):
    ms = [p["skin_and_refit"] for p in ctx["pass_ms"] if "skin_and_refit" in p]
    return sum(ms) / len(ms) if ms else None
