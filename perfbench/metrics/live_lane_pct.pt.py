"""Path tracer: the share of the lanes shaded that were alive, in %: 100 x
the window frames' `live_lanes` (lanes alive when each bounce's shading
starts) over their `lanes_shaded` (the rows each bounce shades), from the
program's per-frame counts. None where the counts lack them (a program
without the counter) or nothing was shaded."""


def read(ctx):
    counts = [c for c in ctx["counts"] if "live_lanes" in c and "lanes_shaded" in c]
    shaded = sum(c["lanes_shaded"] for c in counts)
    if not shaded:
        return None
    return 100.0 * sum(c["live_lanes"] for c in counts) / shaded
