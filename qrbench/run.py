"""Run one cell of BENCHMARK.json and print its result as the last line.

    python -m qrbench --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Set-up (process start to the window's first
call) imports torch and the program, builds or loads its kernels (nvcc's
share printed on standard error), draws the inputs from the seed on the
card, runs the traffic's set-up and warms up on the cell's own inputs.
Then one caller drives the entry point in a closed loop, one call in flight,
each call ended by ``torch.cuda.synchronize()``, for ``--seconds``; with
``--trace 1`` it drives the traffic's ``trace_calls`` calls three times
instead (untraced, then a timing pass of the device's events alone, then a
pass with CPU ops and their shapes; see ``trace.py``) and reports the
per-layer metrics.  After the window the reference judges a
sample of the calls, drawn from the seed, and every number compared is
printed beside its limit: on standard error as the last lines, and in the
result line under ``checks``, its last key.

The run exits 2 without a card (or with fewer than the cell asks for), 3 if
JAX or the JAX package was loaded, 1 on any other fault, each with no
result line; 0 after printing one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import random
import sys
import time
import traceback
from pathlib import Path

from qrbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_qr_tpu")
E2E = ("setup_s", "call_ms", "call_p90_ms")     # what an end-to-end metric can be


def process_start() -> float:
    """``time.perf_counter()``'s reading when this process started."""
    now = time.perf_counter()
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        age = 0.0
    return now - max(age, 0.0)


def loaded_forbidden() -> list:
    """Top-level module names of JAX or the JAX package in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% at or below."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]


def limit_value(entry, config: dict) -> float:
    """A limit as a number: given, or c * n * eps of the configuration."""
    if isinstance(entry["limit"], dict):
        import torch
        eps = torch.finfo(getattr(torch, config["dtype"])).eps
        return entry["limit"]["n_eps"] * config["shape"][1] * eps
    return float(entry["limit"])


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen, self.items = size, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def _sync(device: str):
    import torch
    return torch.cuda.synchronize if device == "cuda" else (lambda: None)


def drive(gen, limit, sync, sample: Reservoir, log, by_time: bool, span: str | None = None):
    """The closed loop, for ``limit`` seconds (``by_time``) or calls, each
    call inside a profiler span named ``span`` if one is given: (start,
    end, per-call seconds, failed calls)."""
    import torch
    durations, failed, i = [], 0, 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(span) if span else contextlib.nullcontext():
                out = gen.call(i)
                sync()
        except Exception:                      # a failed call is counted, not fatal
            out = None
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        if out is not None:
            sample.offer((gen.key(i), out))
        i += 1
        if (t1 - start >= limit) if by_time else (i >= limit):
            return start, t1, durations, failed


def passes(check: dict) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]


def judge(cell, pools: dict, setup: dict, sample: Reservoir, failed: int,
          attempted: int) -> tuple:
    """(correct, {number: {"value", "limit"}}) by the cell's reference; a
    number the reference does not give (a wrong shape) reads None and fails."""
    samples = [dict(key, out=out) for key, out in sample.items]
    values = spec.reference_module(cell).judge(pools, samples, setup) if samples else {}
    checks = {name: {"value": values.get(name), "limit": limit_value(entry, cell.config)}
              for name, entry in cell.limits.items() if not name.startswith("_")}
    ok = all(passes(c) for c in checks.values())
    return bool(ok and failed == 0 and attempted > 0 and samples), checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = spec.ROOT,
             device: str = "cuda", overrides: dict | None = None, t_start: float | None = None,
             log=None) -> dict:
    """One run of a cell: the result line as a dict.  ``overrides`` replaces
    fields of the configuration's QRConfig (the control's lower precision);
    ``device="cpu"`` rehearses on the host with the kernels' plain versions."""
    import torch
    import cuda_qr_tpu_torch as program
    from qrbench import trace as tracing
    from qrbench.traffic import Generator

    t_start = time.perf_counter() if t_start is None else t_start
    t_imported = time.perf_counter()
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = spec.load(workload, root)
    sync = _sync(device)
    traffic = cell.traffic
    gen = Generator(program, cell.config, traffic, seed, device, overrides)
    sync()
    t_inputs = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        gen.call(i)
    sync()
    if device == "cuda":
        from cuda_qr_tpu_torch.ops import _build
        log(f"qrbench: nvcc build_seconds={_build.build_seconds} "
            f"(0.0: every kernel library was already built in this checkout)")
    log(f"qrbench: set-up s: to the program imported {t_imported - t_start:.3f}, inputs and "
        f"the traffic's set-up {t_inputs - t_imported:.3f}, warm-up (kernel load included) "
        f"{time.perf_counter() - t_inputs:.3f}")
    sample = Reservoir(traffic["check_calls"], seed)
    metrics, breakdown, device_info = {}, None, {}
    if not trace:
        cpu0 = time.process_time()
        start, end, durations, failed = drive(gen, seconds, sync, sample, log, by_time=True)
        window_s = end - start
        ok_calls = len(durations) - failed
        values = {"setup_s": start - t_start,
                  "call_ms": 1e3 * window_s / max(ok_calls, 1),
                  "call_p90_ms": 1e3 * percentile(durations, 90)}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[spec.quantity(m["name"], E2E)],
                                  "unit": m["unit"]}
        tenths = [durations[len(durations) * k // 10:len(durations) * (k + 1) // 10]
                  for k in range(10)]
        log(f"qrbench: {len(durations)} calls in {window_s:.3f} s; the process's CPU "
            f"seconds over the window's {(time.process_time() - cpu0) / window_s:.3f}; mean ms "
            f"by tenth of the calls: {' '.join(f'{1e3 * sum(t) / len(t):.2f}' for t in tenths if t)}")
    else:
        readers = {m["name"]: spec.metric_module(cell, m["name"]) for m in cell.per_layer}
        counted = {spec.metric_file(cell, k).stem: r for k, r in readers.items()
                   if hasattr(r, "counter")}
        calls = traffic["trace_calls"]
        start, end, durations, failed = drive(gen, calls, sync, sample, log, by_time=False)
        untraced_s = end - start
        before = {k: r.counter(program) for k, r in counted.items()}
        with (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
              if device == "cuda" else contextlib.nullcontext()) as timing:
            start, end, timed, timed_failed = drive(gen, calls, sync, sample, log, by_time=False)
        deltas = {k: r.counter(program) - before[k] for k, r in counted.items()}
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts, record_shapes=True) as shapes:
            with torch.profiler.record_function(tracing.WINDOW):
                _, _, more, more_failed = drive(gen, calls, sync, sample, log, by_time=False,
                                                span=tracing.CALL)
        t = tracing.reduce(timing, end - start, untraced_s, shapes, calls, cell.config, traffic,
                           deltas)
        log(f"qrbench: {calls} calls untraced {untraced_s:.3f} s, timing pass {end - start:.3f} "
            f"s, shapes pass {sum(more):.3f} s")
        durations = durations + timed + more
        failed = failed + timed_failed + more_failed
        del timing, shapes
        for m in cell.per_layer:
            value = readers[m["name"]].read(t)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = t.breakdown
        if t.on_device:
            device_info = {"busy_s": t.busy_s, "window_s": t.window_s}
    attempted = len(durations)
    if device == "cuda":
        head = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated()}
    else:
        head = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": None}
    setup = gen.setup_outputs()
    pools = gen.pools
    del gen                                        # the program's state is freed
    if device == "cuda":
        torch.cuda.empty_cache()
    correct, checks = judge(cell, pools, setup, sample, failed, attempted)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": {**head, **device_info}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def check_lines(checks: dict) -> list:
    return [f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if passes(c) else 'FAIL'}"
            for name, c in checks.items()]


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python -m qrbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load(args.workload)
    import torch
    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"qrbench: the cell needs {need} CUDA device(s); torch.cuda.is_available()="
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
        from cuda_qr_tpu_torch.utils.timing import card_name
        print(f"qrbench: {args.workload} seed {args.seed} on {card_name()}", file=sys.stderr)
    except Exception:
        traceback.print_exc()
        return 1
    found = loaded_forbidden()
    if found:
        print(f"qrbench: loaded {', '.join(found)}: the port must not load JAX "
              f"or the JAX package", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(check_lines(result["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
