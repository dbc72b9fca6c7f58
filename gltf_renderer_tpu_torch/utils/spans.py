"""Named spans of the program's own phases, on two clocks.

    with spans.span("pt.shade"):
        ...

A span costs one module flag check and one `_profiler_enabled()` call
while nothing records. While a frame record is open on the calling thread
(`frame(..., record=True)`: the Renderer's `profile`), it adds its host
milliseconds (`time.perf_counter`) to the record under its name, summed
over repeats; it never synchronizes, so a span that issues device work
times the issue, and one that reads from the device times the wait. While
a torch profiler records, it also opens a profiler range under its name,
so the span lies on the profiler's clock beside the device activity
(whether or not a record is open).

The range is torch's RecordFunctionFast, an operator-scope range (a
`cpu_op` in the trace), not `torch.profiler.record_function`: a
user-scope range makes the profiler add a `gpu_user_annotation` interval
on the device timeline from the range's first kernel to its last, which
a reader of the trace's device events takes for device work; it also
costs ~16 us a range against ~2 us (torch 2.13, an x86 CPU host).

`host_read(mask)` is the alpha hop loops' read of a device mask on the
host (`bool(mask.any())`, a wait for the device's queue), inside a
`pt.alpha_read` span and counted in the open record (`alpha_reads`). It is
not every blocking call of a frame: uploads and other syncs are not spans.

Records are thread-local: the viewer draws on its own render thread.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_NOOP = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class Record:
    """One frame's spans: summed host ms by name, and the alpha reads."""

    __slots__ = ("ms", "alpha_reads")

    def __init__(self):
        self.ms = {}
        self.alpha_reads = 0


class _Local(threading.local):
    record = None


_local = _Local()


class _Span:
    __slots__ = ("name", "record", "range", "t0")

    def __init__(self, name, record):
        self.name = name
        self.record = record
        self.range = None

    def __enter__(self):
        if _profiling():
            self.range = _Range(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.record is not None:
            ms = self.record.ms
            ms[self.name] = ms.get(self.name, 0.0) + (time.perf_counter() - self.t0) * 1e3
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that times `name` into the open record and the profiler;
    the shared no-op context while neither records."""
    record = _local.record
    if record is None and not _profiling():
        return _NOOP
    return _Span(name, record)


@contextlib.contextmanager
def frame(name: str, record: bool):
    """One frame: yields its Record (None unless `record`), open on this
    thread until the frame ends, and a profiler range `name` around the
    frame while a profiler records (not in the record: its host time is
    the caller's frame time)."""
    rec = Record() if record else None
    prev, _local.record = _local.record, rec
    try:
        with (_Range(name) if _profiling() else _NOOP):
            yield rec
    finally:
        _local.record = prev


def host_read(mask) -> bool:
    """bool(mask.any()): the host waits for the device's queued work."""
    with span("pt.alpha_read"):
        out = bool(mask.any())
    record = _local.record
    if record is not None:
        record.alpha_reads += 1
    return out
