"""Path tracer: K1 launches a window frame (ops.traverse.KERNEL_LAUNCHES
over the window, divided by the frames)."""


def read(ctx):
    return ctx["k1_launches"] / ctx["frames"] if ctx["frames"] else None
