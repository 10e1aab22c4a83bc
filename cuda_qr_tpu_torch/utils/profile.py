"""Where the device time of a call goes, from torch.profiler on the card.

    python -m cuda_qr_tpu_torch.utils.profile [--out DIR]

Profiles, after a warm-up call each, one 8192^2 float32 ``qr_blocked`` at
DEFAULT_CONFIG and one 1,048,576 x 128 float32 Householder ``tsqr``: the
call's window on the host clock (ending in a synchronize), the device busy
time (the union of the CUDA events' intervals), the busy share, the host
syncs, and the device time and count of each kernel, largest first.  Prints
one summary line per call and writes the full tables as JSON to
``DIR/profile.json`` (default ``chiprun_out``).  Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops import smalllinalg


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile(fn) -> dict:
    """One profiled call of ``fn`` (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    smalllinalg.host_syncs = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    syncs = smalllinalg.host_syncs
    sums, counts, intervals = defaultdict(float), defaultdict(int), []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        sums[ev.name] += end - start
        counts[ev.name] += 1
    busy_ms = _busy_us(intervals) / 1e3
    kernels = sorted(({"name": k, "ms": v / 1e3, "count": counts[k]} for k, v in sums.items()),
                     key=lambda r: -r["ms"])
    return {"window_ms": window_ms, "busy_ms": busy_ms, "busy_share": busy_ms / window_ms,
            "device_events": len(intervals), "host_syncs": syncs, "kernels": kernels}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (8192, 8192), dtype=np.float32)).to(dev)
    T = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1 << 20, 128), dtype=np.float32)).to(dev)
    runs = {"qr_blocked 8192^2 f32 DEFAULT_CONFIG": lambda: ct.qr_blocked(A),
            "tsqr 1048576x128 f32 householder": lambda: ct.tsqr(T)}
    out = {"device": smi}
    for name, fn in runs.items():
        rec = profile(fn)
        out[name] = rec
        top = ", ".join(f"{k['name'][:48]} {k['ms']:.3f} ms x{k['count']}"
                        for k in rec["kernels"][:6])
        print(f"{name}: window {rec['window_ms']:.2f} ms, device busy {rec['busy_ms']:.2f} ms "
              f"({100 * rec['busy_share']:.1f} %), {rec['device_events']} device events, "
              f"{rec['host_syncs']} host syncs; top: {top}", flush=True)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "profile.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
