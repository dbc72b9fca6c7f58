"""Alpha loops: hops a window frame (pathtracer.ALPHA_RETRY_HOPS +
ALPHA_SHADOW_HOPS over the window, divided by the frames); each hop is one
more K1 launch and one host read. A scene with no masked material reads 0."""


def read(ctx):
    return ctx["alpha_hops"] / ctx["frames"] if ctx["frames"] else None
