"""FLOP count and a CUDA-event timer.

The reference's harness (``cuda_qr_tpu/utils/timing.py``) subtracted a
host<->device round trip of a remote TPU link from its loop time; a local
card has no such link, so the timer here reads CUDA events around a run of
calls and has no correction term.
"""

from __future__ import annotations

from typing import Callable

import torch


def qr_flops(m: int, n: int) -> float:
    """2mn^2 - (2/3)n^3, the convention of the reference's numbers."""
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3


def cuda_time_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call of ``fn`` on the current stream.

    Raises where there is no card: a timing taken on the host is not a
    device time.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
