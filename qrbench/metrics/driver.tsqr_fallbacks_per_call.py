"""Direct fallbacks per call: the CholeskyQR2 direct attempts of ``tsqr``
and ``tsqr_r`` (``tsqr_leaf="cholqr2"``) whose certificate sent the call
to the Householder tree, counted by the program (``models.tsqr``'s
``direct_fallbacks``) over the traced calls.  Layer: driver.  Moves the
call time of its cells: a fallback adds the tree's time to the direct
attempt's.  None with a program that has no such counter."""

import math


def counter(program) -> float:
    count = getattr(getattr(program.models, "tsqr", None), "direct_fallbacks", None)
    return math.nan if count is None else count


def read(trace):
    delta = trace.counters["driver.tsqr_fallbacks_per_call"]
    if math.isnan(delta):
        return None
    return delta / trace.calls
