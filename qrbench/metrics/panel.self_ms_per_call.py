"""The panel layer's own host time, in ms per call: over the timing pass,
the seconds of the program's ``panel.*`` spans (``panel.factor`` and its
retries) less the spans nested directly inside them (the host syncs).
Layer: panel.  Moves call_ms.  None on the CPU (no profiler runs over its
timing pass, so the spans are off) and with a program that has no spans."""

import math


def counter(program) -> float:
    totals = getattr(getattr(program.utils, "profiling", None), "span_totals", None)
    if totals is None:
        return math.nan
    return sum(t.self_s for name, t in list(totals.items())
               if name.startswith("panel."))


def read(trace):
    delta = trace.counters["panel.self_ms_per_call"]
    if not trace.on_device or math.isnan(delta):
        return None
    return 1e3 * delta / trace.calls
