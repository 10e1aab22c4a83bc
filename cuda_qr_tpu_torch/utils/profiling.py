"""Profiling and tracing (``cuda_qr_tpu/utils/profiling.py``).

  * ``trace(logdir)``: ``torch.profiler`` around the enclosed block (the
    card's activity too when there is one), exported as a Chrome trace
    ``trace.json`` in ``logdir``;
  * ``annotate(name)``: a named region inside a traced block
    (``torch.profiler.record_function``);
  * ``device_memory_stats()``: bytes in use, peak and limit of a card, or
    {} on the CPU (the reference's answer for a device without stats).

Steady-state timing lives in ``utils.timing``; ``utils/profile.py`` is the
port's profiling script.
"""

from __future__ import annotations

import contextlib
import os

import torch


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


def annotate(name: str):
    """Named region inside a traced block (shows in the trace's timeline)."""
    return torch.profiler.record_function(name)


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
