"""Where the device time of a call goes, from torch.profiler on the card.

    python -m cuda_qr_tpu_torch.utils.profile [--out DIR] [--only TEXT]

Profiles, after a warm-up call each, one 8192^2 float32 ``qr_blocked`` at
DEFAULT_CONFIG, one 1,048,576 x 128 float32 Householder ``tsqr``, one
8192^2 float32 pivoted ``qrcp_blocked`` at DEFAULT_CONFIG, one 1024^2
float32 ``eigh``, one 4096^2 float32 ``svd`` and one 8192^2 float32 ``caqr``
on one rank over NCCL (``--only`` keeps the runs whose name starts with
TEXT): the
call's window on the host clock (ending in a synchronize), the device busy
time (the union of the CUDA events' intervals), the busy share, the host
syncs, the host's wait at them and the panel and driver layers' own host
time (from the program's spans, ``utils/profiling.span_totals``), and the
device time and count of each kernel, largest first.  The
trace must hold one event for every launch the port's kernel wrappers
counted in the call (chol_inv, geqrt, select_pivots, newton_inv); a call whose trace
lost one fails.  Prints
one summary line per call and writes the full tables as JSON to
``DIR/profile.json`` (default ``chiprun_out``).  Fails without a card.

The run "collectives" times all_reduce on 4 gloo ranks sharing card 0, of
CUDA tensors and of the same data through host memory, at the distributed
path's sizes.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_batched
from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
from cuda_qr_tpu_torch.ops.qrcp import qrcp_blocked
from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
from cuda_qr_tpu_torch.utils import profiling
from cuda_qr_tpu_torch.utils.timing import card_name

# The port's kernels: the names their device events carry, and the wrappers
# whose launch counters they answer to.
COUNTED = {"chol_inv": (("chol_inv_kernel",), (chol_with_inv_kernel,)),
           "geqrt": (("geqrt_subpanel_kernel", "geqrt_stream_kernel"),
                     (geqrt_base, geqrt_batched)),
           "select_pivots": (("select_cluster_kernel",), (select_pivots_kernel,)),
           "newton_inv": (("newton_cluster_kernel",), (newton_certified_kernel,))}


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_work(events) -> list:
    """The profiler events that are device work: the CUDA events but the
    device-side range that a span (``record_function``) leaves over its
    whole length."""
    return [ev for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]


def _span_seconds() -> dict:
    """The span totals so far: the host's wait at the syncs, and the panel
    and driver layers' own host time (each span less its direct children;
    the driver's without the syncs)."""
    totals = list(profiling.span_totals.items())
    return {"sync_wait": sum(t.total_s for k, t in totals if k == "driver.host_sync"),
            "panel_self": sum(t.self_s for k, t in totals if k.startswith("panel.")),
            "driver_self": sum(t.self_s for k, t in totals
                               if k.startswith("driver.") and k != "driver.host_sync")}


def profile(fn) -> dict:
    """One profiled call of ``fn`` (after one warm-up call); raises if the
    trace lacks an event for a kernel launch that a wrapper counted."""
    fn()
    torch.cuda.synchronize()
    smalllinalg.host_syncs = 0
    for _, wrappers in COUNTED.values():
        for w in wrappers:
            w.launches = 0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    spans = _span_seconds()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    syncs = smalllinalg.host_syncs
    span_ms = {f"{k}_ms": (v - spans[k]) * 1e3 for k, v in _span_seconds().items()}
    sums, counts, intervals = defaultdict(float), defaultdict(int), []
    for ev in device_work(prof.events()):
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        sums[ev.name] += end - start
        counts[ev.name] += 1
    busy_ms = _busy_us(intervals) / 1e3
    launches = {}
    for kernel, (names, wrappers) in COUNTED.items():
        counted = sum(w.launches for w in wrappers)
        traced = sum(c for k, c in counts.items() if any(n in k for n in names))
        if traced != counted:
            raise RuntimeError(f"profile: {traced} {kernel} events in the trace for "
                               f"{counted} launches counted")
        launches[kernel] = counted
    kernels = sorted(({"name": k, "ms": v / 1e3, "count": counts[k]} for k, v in sums.items()),
                     key=lambda r: -r["ms"])
    return {"window_ms": window_ms, "busy_ms": busy_ms, "busy_share": busy_ms / window_ms,
            "device_events": len(intervals), "host_syncs": syncs, **span_ms,
            "launches": launches, "kernels": kernels}


def _caqr_rank(mesh, n: int) -> dict:
    """Rank body: the profile of one caqr of an n^2 Gaussian on this rank."""
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(torch.cuda.current_device())
    return profile(lambda: ct.caqr(A, mesh))


COLLECTIVE_SIZES = {"nb x nb": (128, 128), "nb x 8192 strip": (128, 8192),
                    "4096 x 4096": (4096, 4096)}


def _collectives_rank(mesh, reps: int = 10) -> dict:
    """Rank body: mean ms of one all_reduce of each COLLECTIVE_SIZES float32
    tensor, on the card and through host memory."""
    import torch.distributed as dist
    out = {}
    for name, shape in COLLECTIVE_SIZES.items():
        x = torch.ones(shape, device=torch.cuda.current_device())
        for via in ("card", "host"):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                if via == "card":
                    dist.all_reduce(x)
                else:
                    h = x.cpu()
                    dist.all_reduce(h)
                    x.copy_(h)
            torch.cuda.synchronize()
            out[f"{name} via {via}"] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--only", default="", help="profile only the runs whose name starts with this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device")
    smi = card_name()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (8192, 8192), dtype=np.float32)).to(dev)
    T = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (1 << 20, 128), dtype=np.float32)).to(dev)
    S = (A[:1024, :1024] + A[:1024, :1024].T) * 0.5
    runs = {"qr_blocked 8192^2 f32 DEFAULT_CONFIG": lambda: ct.qr_blocked(A),
            "tsqr 1048576x128 f32 householder": lambda: ct.tsqr(T),
            "qrcp_blocked 8192^2 f32 DEFAULT_CONFIG": lambda: qrcp_blocked(A),
            "eigh 1024^2 f32 DEFAULT_CONFIG": lambda: ct.eigh(S),
            "svd 4096^2 f32 eigh_impl=torch": lambda: ct.svd(A[:4096, :4096])}
    runs = {name: fn for name, fn in runs.items() if name.startswith(args.only)}
    out = {"device": smi}
    from ..parallel.launch import run_ranks
    name = "caqr 8192^2 f32 bk block over NCCL, P=1"
    if name.startswith(args.only):
        runs[name] = lambda: None          # listed for the summary loop below
        out[name] = run_ranks(1, _caqr_rank, 8192)[0]
    if "collectives".startswith(args.only):
        rec = run_ranks(4, _collectives_rank)[0]
        out["collectives"] = rec
        print("all_reduce ms, 4 gloo ranks on one card: "
              + ", ".join(f"{k} {v:.3f}" for k, v in rec.items()), flush=True)
    for name, fn in runs.items():
        rec = out[name] if name in out else profile(fn)
        out[name] = rec
        top = ", ".join(f"{k['name'][:48]} {k['ms']:.3f} ms x{k['count']}"
                        for k in rec["kernels"][:6])
        b3 = [k for k in rec["kernels"] if COUNTED["select_pivots"][0][0] in k["name"]]
        b3_ms = sum(k["ms"] for k in b3)
        b3_line = (f"; B3 (select_pivots) {b3_ms:.3f} ms x{sum(k['count'] for k in b3)}, "
                   f"{100 * b3_ms / rec['busy_ms']:.1f} % of busy") if b3 else ""
        print(f"{name}: window {rec['window_ms']:.2f} ms, device busy {rec['busy_ms']:.2f} ms "
              f"({100 * rec['busy_share']:.1f} %), {rec['device_events']} device events, "
              f"{rec['host_syncs']} host syncs waiting {rec['sync_wait_ms']:.2f} ms, panel self "
              f"{rec['panel_self_ms']:.2f} ms, driver self {rec['driver_self_ms']:.2f} ms, "
              f"launches {rec['launches']} (each traced)"
              f"{b3_line}; top: {top}", flush=True)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / "profile.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
