"""Host syncs per call: the data-dependent branches that the driver and the
panels decide on the host (``smalllinalg.host_decision`` and
``host_values``, each one device-to-host sync), counted by the program
over the traced calls.  Layer: driver.  Moves call_ms."""


def counter(program) -> float:
    return program.ops.smalllinalg.host_syncs


def read(trace):
    return trace.counters["driver.host_syncs_per_call"] / trace.calls
