"""Kernels: K1's share of its byte roofline over the window, in %.

Bound: the bytes every K1 launch of the window must move (rays read once,
hits written once, node and leaf tables read once but no more of them than
one root-to-leaf path a live ray; roofline.k1_bytes from each launch's
argument shapes and live rays) over the card's published HBM bandwidth.
Time: K1's per-launch device time (the profiler's mean over the launches
it recorded) times the launches counted."""

from perfbench.roofline import peak


def read(ctx):
    if not ctx.get("k1_calls") or ctx.get("k1_mean_s") is None:
        return None
    bound_s = ctx["k1_bytes"] / peak(ctx["kind"], "hbm_bytes_per_s")
    return 100.0 * bound_s / (ctx["k1_mean_s"] * ctx["k1_calls"])
