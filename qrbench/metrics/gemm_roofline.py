"""The GEMMs as a share of their roofline, in %.  Layer: GEMM.  Moves
call_ms.

Over every matmul-family op of the traced calls (``aten::mm``, ``bmm``,
``mv``, ...; cuBLAS underneath) with device kernels linked to it: the sum
of max(2MNK / the peak of the configuration's GEMM precision, bytes /
HBM's rate), M, N, K (and the batch) from the profiler's recorded shapes,
bytes of both operands read once and the product written once, over the
sum of the linked kernels' device time.  None where no such op ran on the
device.
"""

from qrbench.roofline import ELEMENT_BYTES, least_seconds, peak, share_percent


def flops_bytes(op: str, shapes: list, size: int) -> tuple:
    """(operations, bytes) of one matmul-family op from its input shapes."""
    if op in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        shapes = shapes[1:3]
    a, b = shapes[0], shapes[1]
    if op == "aten::dot":
        (k,) = a
        return 2 * k, (2 * k + 1) * size
    if op in ("aten::mv", "aten::addmv"):
        m, k = a
        return 2 * m * k, (m * k + k + m) * size
    batch = a[0] if len(a) == 3 else 1
    m, k = a[-2], a[-1]
    n = b[-1]
    return 2 * batch * m * n * k, batch * (m * k + k * n + m * n) * size


def read(trace):
    size = ELEMENT_BYTES[trace.config["dtype"]]
    flops_per_s = peak(trace.config)
    least = measured = 0.0
    for op, shapes, us in trace.matmuls:
        if us <= 0:
            continue
        f, nbytes = flops_bytes(op, shapes, size)
        least += least_seconds(f, nbytes, flops_per_s)
        measured += us / 1e6
    return share_percent(least, measured)
