"""B2's blocked-body launches per call: the launches of the geqrt kernel's
blocked leaf body (a float32 stack of leaves of up to 1,024 rows, one per
TSQR call for its leaves), counted by the program (``ops.geqrt``'s
``geqrt_batched.leaf_launches``) over the traced calls.  Layer: kernels.
Moves call_ms.tsqr1M: the leaves that take the blocked body instead of the
dense one run their work as register-tiled products.  None with a program
that has no such counter."""

import math


def counter(program) -> float:
    geqrt = getattr(getattr(program, "ops", None), "geqrt", None)
    count = getattr(getattr(geqrt, "geqrt_batched", None), "leaf_launches", None)
    return math.nan if count is None else count


def read(trace):
    delta = trace.counters["kernels.b2_leaf_launches_per_call"]
    if math.isnan(delta):
        return None
    return delta / trace.calls
