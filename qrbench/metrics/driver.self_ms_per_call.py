"""The driver's own host time, in ms per call: over the timing pass, the
seconds of the program's ``driver.*`` spans but the host syncs
(``driver.factor``, ``driver.group``, ``driver.orgqr`` and its groups, the
TSQR tree's) less the spans nested directly inside them (panels, syncs,
inner driver spans).  Layer: driver.  Moves call_ms.  None on the CPU (no
profiler runs over its timing pass, so the spans are off) and with a
program that has no spans."""

import math

WAIT = "driver.host_sync"


def counter(program) -> float:
    totals = getattr(getattr(program.utils, "profiling", None), "span_totals", None)
    if totals is None:
        return math.nan
    return sum(t.self_s for name, t in list(totals.items())
               if name.startswith("driver.") and name != WAIT)


def read(trace):
    delta = trace.counters["driver.self_ms_per_call"]
    if not trace.on_device or math.isnan(delta):
        return None
    return 1e3 * delta / trace.calls
