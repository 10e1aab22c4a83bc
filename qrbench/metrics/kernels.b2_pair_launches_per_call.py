"""B2's triangle-pair launches per call: the launches of the geqrt kernel's
pair body (``geqrt_batched(..., pair=True)``, one per TSQR tree level),
counted by the program (``ops.geqrt``'s ``geqrt_batched.pair_launches``)
over the traced calls.  Layer: kernels.  Moves call_ms.tsqr1M: each level
that takes the pair body instead of the dense one is a level of shorter
waves.  None with a program that has no such counter."""

import math


def counter(program) -> float:
    geqrt = getattr(getattr(program, "ops", None), "geqrt", None)
    count = getattr(getattr(geqrt, "geqrt_batched", None), "pair_launches", None)
    return math.nan if count is None else count


def read(trace):
    delta = trace.counters["kernels.b2_pair_launches_per_call"]
    if math.isnan(delta):
        return None
    return delta / trace.calls
