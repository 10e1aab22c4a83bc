"""The device's idle share of an untraced call, in %: 1 minus the device's
busy time (the union of the timing pass's device events' intervals) over
the host-clock time of the same calls on the same inputs, run untraced
just before.  The timing pass's own window is longer by the profiler's
cost (the result line's ``window_s``).  Layer: device.  Moves the call
time of its cells.  None without device events (a CPU run)."""


def read(trace):
    if not trace.on_device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.untraced_s)
