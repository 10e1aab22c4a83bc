"""Profiling and tracing (``cuda_qr_tpu/utils/profiling.py``).

  * ``trace(logdir)``: ``torch.profiler`` around the enclosed block (the
    card's activity too when there is one), exported as a Chrome trace
    ``trace.json`` in ``logdir``;
  * ``span(name)``: the program's span.  Off (one shared
    ``contextlib.nullcontext``: no ``record_function``, no clock read)
    unless a ``torch.profiler`` session is recording, which is read at
    every entry.  On, it is a ``torch.profiler.record_function(name)``,
    on the profiler's clock beside the device's events, and it adds to
    ``span_totals[name]`` its count, its seconds from enter to exit and
    the seconds of the spans nested directly inside it (its self time is
    the difference).  The totals only grow; readers take differences.
    Names are ``<layer>.<what>``: ``entry.*`` around a call into the
    program, ``driver.*``, ``panel.*``;
  * ``device_memory_stats()``: bytes in use, peak and limit of a card, or
    {} on the CPU (the reference's answer for a device without stats).

Steady-state timing lives in ``utils.timing``; ``utils/profile.py`` is the
port's profiling script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclasses.dataclass
class SpanTotal:
    """What the spans of one name added up to while a profiler recorded."""
    count: int = 0
    total_s: float = 0.0       # enter to exit, host clock
    child_s: float = 0.0       # covered by the spans nested directly inside

    @property
    def self_s(self) -> float:
        return self.total_s - self.child_s


# Span name -> its totals since the process started.
span_totals: dict[str, SpanTotal] = {}
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_open = threading.local()          # .stack: this thread's open spans


class _Span:
    __slots__ = ("name", "region", "t0", "child_s")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.region = torch.profiler.record_function(self.name)
        self.region.__enter__()
        self.child_s = 0.0
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].child_s += dt
        self.region.__exit__(*exc)
        with _lock:
            tot = span_totals.get(self.name)
            if tot is None:
                tot = span_totals[self.name] = SpanTotal()
            tot.count += 1
            tot.total_s += dt
            tot.child_s += self.child_s
        return False


def span(name: str):
    """The program's span ``name`` around the enclosed block: recorded
    only while a profiler session is (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def device_memory_stats(device=None) -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit} of a CUDA device (the
    current one by default); {} for the CPU or without a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    _, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}
