"""Two traced passes over the same calls, reduced to what the per-layer
metrics read.

Before them the harness times the same calls untraced (``untraced_s``).
The timing pass records the device's events alone (``torch.profiler``
with the CUDA activity only: no CPU ops, no shapes), whose window, on the
host's clock from the first call to the last call's sync, still holds
CUPTI's cost per launch, so the idle share reads the untraced time.  It
gives the device events (name, start, end), the busy time of the device
(the union of their intervals, the arithmetic of
``cuda_qr_tpu_torch/utils/profile.py``'s ``_busy_us``) and the device
time by operation.  The shapes pass records CPU ops with
their shapes as well, and the benchmark's own spans (``qrbench.window``
around the calls, ``qrbench.call`` around each): it gives the
matmul-family ops with their recorded shapes and the device time of the
kernels linked to them, and the device's idle time by the innermost host
op that was open over each gap (its gaps are wider than the timing pass's,
by the profiler's cost).  Nothing is written to disk.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

WINDOW, CALL = "qrbench.window", "qrbench.call"
MATMULS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm", "aten::mv",
           "aten::addmv", "aten::dot")
TOP = 10


@dataclasses.dataclass
class Trace:
    calls: int                      # the timing pass's calls
    window_s: float                 # the timing pass's window, host clock
    untraced_s: float               # the same calls on the same inputs, untraced
    config: dict                    # the cell's configuration file
    traffic: dict                   # the cell's traffic file
    device_events: list             # (name, start_us, end_us), the timing pass's
    matmuls: list                   # (op name, input shapes, device us of its kernels)
    counters: dict                  # reader (file stem) -> its counter's change, timing pass
    busy_s: float | None = None     # None: no device event (a CPU run)
    breakdown: dict | None = None

    @property
    def on_device(self) -> bool:
        return bool(self.device_events)


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, start: float, stop: float) -> list:
    """(start, end) of each stretch of [start, stop] that no interval covers."""
    gaps, end = [], start
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, stop)))
        end = max(end, e)
        if end >= stop:
            break
    if end < stop:
        gaps.append((end, stop))
    return [(a, b) for a, b in gaps if b > a]


def innermost(ops: list, points: list) -> list:
    """For each time in ``points`` (sorted), the name of the innermost op of
    ``ops`` ((start, end, name), properly nested, sorted by start, longer
    first on ties) that is open at it, or None."""
    names, stack, j = [], [], 0
    for t in points:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] <= ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def device_events(prof) -> list:
    """(name, start_us, end_us) of a profiler session's device events; a
    span (record_function) also leaves a device-side annotation over its
    whole length, which is no device work."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
            and e.name not in (WINDOW, CALL)]


def reduce(timing, window_s: float, untraced_s: float, shapes, calls: int, config: dict,
           traffic: dict, counters: dict) -> Trace:
    """The Trace of a timing pass (a profiler session of ``calls`` calls in
    ``window_s`` seconds, or None on the CPU), the same calls untraced in
    ``untraced_s`` seconds, and a shapes pass (a session whose calls ran
    inside a WINDOW span)."""
    from torch.autograd import DeviceType
    events = shapes.events()
    window = next(e for e in events if e.name == WINDOW)
    ws, we = window.time_range.start, window.time_range.end
    matmuls, ops = [], []
    for e in events:
        if e.device_type == DeviceType.CPU and not e.is_async:
            if e.name in MATMULS and e.kernels:
                matmuls.append((e.name, e.input_shapes, sum(k.duration for k in e.kernels)))
            if e.thread == window.thread and e.name not in (WINDOW, CALL):
                ops.append((e.time_range.start, e.time_range.end, e.name))
    device = device_events(timing) if timing is not None else []
    trace = Trace(calls=calls, window_s=window_s, untraced_s=untraced_s, config=config,
                  traffic=traffic, device_events=device, matmuls=matmuls, counters=counters)
    if not device:
        return trace
    trace.busy_s = busy_us([(s, e) for _, s, e in device]) / 1e6
    by_op = defaultdict(float)
    for name, s, e in device:
        by_op[name] += (e - s) / 1e6
    gaps = idle_gaps([(s, e) for _, s, e in device_events(shapes)], ws, we)
    ops.sort(key=lambda o: (o[0], -o[1]))
    mids = [(a + b) / 2 for a, b in gaps]
    by_host = defaultdict(float)
    for (a, b), name in zip(gaps, innermost(ops, mids)):
        by_host[name or "(no host op)"] += (b - a) / 1e6
    trace.breakdown = {
        "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]],
    }
    return trace
