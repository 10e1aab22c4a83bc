"""Kernel launches per call: the device events of the timing pass that
are kernels (not copies or fills), over the traced calls.  Layer: device.
Moves call_ms.  None without device events (a CPU run)."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(trace):
    if not trace.on_device:
        return None
    kernels = sum(1 for name, _, _ in trace.device_events if not name.startswith(NOT_KERNELS))
    return kernels / trace.calls
