"""Device: the share of a frame in which no operation runs on the card, in
%: 1 - busy / frame. busy: device seconds a frame over the frames traced
under torch.profiler after the window (the union of the profiler's device
intervals, plus the K1 launches it dropped times K1's per-launch mean);
the profiler's host cost stretches those frames but not the device
intervals. frame: the window's own mean frame time, outside the profiler
(with the spans' few synchronizations a frame)."""


def read(ctx):
    d = ctx.get("device")
    if not d or not ctx.get("frames") or ctx.get("frame_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / ctx["profiled_frames"] / ctx["frame_s"])
