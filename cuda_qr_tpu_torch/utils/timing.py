"""FLOP count, a CUDA-event timer, the benchmark harness of the CLI and the
headline record, and the card's name beside which their times are kept.

The reference's harness (``cuda_qr_tpu/utils/timing.py``) forced completion
by fetching a scalar and subtracted a host<->device round trip of a remote
TPU link from its loop time; a local card has no such link, so the timers
here read CUDA events around a run of calls and have no correction term.
"""

from __future__ import annotations

import dataclasses
import subprocess
import time
from typing import Any, Callable

import torch


def qr_flops(m: int, n: int) -> float:
    """2mn^2 - (2/3)n^3, the convention of the reference's numbers."""
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them: a time is
    kept beside them, since a card set below its full power runs slower."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


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


@dataclasses.dataclass
class BenchResult:
    compile_s: float         # the first call's seconds, kernel build and load included
    steady_s: float          # mean seconds per steady call
    reps: int
    flops: float | None = None

    @property
    def gflops(self) -> float | None:
        if self.flops is None:
            return None
        return self.flops / self.steady_s / 1e9


def _on_cuda(a) -> bool:
    if isinstance(a, (tuple, list)):
        return any(_on_cuda(x) for x in a)
    return isinstance(a, torch.Tensor) and a.is_cuda


def bench(fn: Callable[..., Any], *args, reps: int = 3,
          flops: float | None = None) -> BenchResult:
    """Time ``fn(*args)``: the first call by the host clock around a
    synchronized call (any kernel build and load included), then the mean of
    ``reps`` steady calls after one untimed call, by CUDA events
    (``cuda_time_ms``) when a tensor argument (a DTensor too, or a tensor
    in a tuple such as ``PackedQR``) is on a CUDA device, and by
    ``time.perf_counter`` only when the caller's tensors are on the CPU."""
    cuda = any(_on_cuda(a) for a in args)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    fn(*args)
    sync()
    compile_s = time.perf_counter() - t0
    if cuda:
        steady = cuda_time_ms(lambda: fn(*args), reps=reps, warmup=1) / 1e3
    else:
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        steady = (time.perf_counter() - t0) / reps
    return BenchResult(compile_s=compile_s, steady_s=steady, reps=reps, flops=flops)
