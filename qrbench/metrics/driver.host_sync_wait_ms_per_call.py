"""The host's wait at the syncs, in ms per call: the seconds of the
program's ``driver.host_sync`` spans (the blocking read inside
``smalllinalg.host_decision`` and ``host_values``) over the timing pass.
Long waits: the host is ahead of the card at a sync; near 0: it is behind,
and the cost is the refill of an empty queue.  Layer: driver.  Moves
call_ms.  None on the CPU (no profiler runs over its timing pass, so the
spans are off) and with a program that has no spans."""

import math


def counter(program) -> float:
    totals = getattr(getattr(program.utils, "profiling", None), "span_totals", None)
    if totals is None:
        return math.nan
    total = totals.get("driver.host_sync")
    return total.total_s if total is not None else 0.0


def read(trace):
    delta = trace.counters["driver.host_sync_wait_ms_per_call"]
    if not trace.on_device or math.isnan(delta):
        return None
    return 1e3 * delta / trace.calls
