"""The roofline count functions against hand counts, and the trace
arithmetic on made-up intervals."""

import importlib.util

import pytest

from qrbench import roofline
from qrbench.tests.tiny_root import REPO
from qrbench.trace import busy_us, idle_gaps, innermost


def metric(name):
    path = REPO / "qrbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_b2_leaves_hand_count():
    b2 = metric("b2_geqrt_roofline")
    flops, nbytes = b2.geqrt_work(1024, 1024, 128)
    # 1,024 leaves of 1,024 x 128: 1024 * (3 * 1024 * 128^2 - 128^3)
    assert flops == 1024 * (3 * 1024 * 128 ** 2 - 128 ** 3)
    assert flops / 1e9 == pytest.approx(49.392, abs=1e-3)
    assert roofline.least_seconds(flops, nbytes) * 1e3 == pytest.approx(0.7372, abs=1e-4)
    assert nbytes == 1024 * (2 * 1024 * 128 + 128 + 128 * 128) * 4


def test_b2_tree_adds_every_node_once():
    b2 = metric("b2_geqrt_roofline")
    cfg = {"shape": [1 << 20, 128], "qr_config": {"block_rows": 1024}}
    flops, _ = b2.work(cfg)
    leaves, _ = b2.geqrt_work(1024, 1024, 128)
    nodes, _ = b2.geqrt_work(1023, 256, 128)
    assert flops == leaves + nodes
    # an odd count passes one factor up: 5 leaves -> 2 + 1 + 1 nodes
    five = {"shape": [5 * 1024, 128], "qr_config": {"block_rows": 1024}}
    assert b2.work(five)[0] == b2.geqrt_work(5, 1024, 128)[0] + b2.geqrt_work(4, 256, 128)[0]


def test_b1_one_cholesky_inverse_a_panel():
    b1 = metric("b1_chol_inv_roofline")
    flops, nbytes = b1.work({"shape": [8192, 8192], "qr_config": {"panel_width": 128}})
    assert flops == 64 * 2 * 128 ** 3 / 3
    assert nbytes == 64 * 3 * 128 * 128 * 4
    # bytes bound it: 0.000059 ms a panel, as the kernel table's bound
    assert roofline.least_seconds(flops / 64, nbytes / 64) * 1e3 == pytest.approx(5.869e-5, rel=1e-3)


def test_gemm_counts():
    g = metric("gemm_roofline")
    assert g.flops_bytes("aten::mm", [[8, 4], [4, 2]], 4) == (2 * 8 * 4 * 2, (32 + 8 + 16) * 4)
    assert g.flops_bytes("aten::bmm", [[3, 8, 4], [3, 4, 2]], 4) == (3 * 128, 3 * 56 * 4)
    assert g.flops_bytes("aten::addmm", [[8, 2], [8, 4], [4, 2], [], []], 4) == (128, 56 * 4)
    assert g.flops_bytes("aten::mv", [[8, 4], [4]], 4) == (64, (32 + 4 + 8) * 4)
    assert g.flops_bytes("aten::dot", [[4], [4]], 8) == (8, 9 * 8)


def test_gemm_share_over_linked_kernel_time():
    g = metric("gemm_roofline")

    class T:
        config = {"dtype": "float32", "qr_config": {"precision": "highest"}}
        matmuls = [("aten::mm", [[8192, 8192], [8192, 512]], 2000.0)]
    least = 2 * 8192 * 8192 * 512 / 67e12
    assert g.read(T) == pytest.approx(100 * least / 2e-3)
    T.matmuls = []
    assert g.read(T) is None


def test_busy_union_and_gaps():
    iv = [(0, 10), (5, 12), (20, 30), (25, 26), (40, 41)]
    assert busy_us(iv) == 12 + 10 + 1
    assert idle_gaps(iv, 0, 50) == [(12, 20), (30, 40), (41, 50)]
    assert idle_gaps(iv, -5, 35) == [(-5, 0), (12, 20), (30, 35)]


def test_innermost_host_op():
    ops = sorted([(0, 100, "outer"), (10, 20, "a"), (12, 14, "a.inner"), (30, 60, "b")],
                 key=lambda o: (o[0], -o[1]))
    assert innermost(ops, [5, 13, 16, 25, 59, 70, 120]) == [
        "outer", "a.inner", "a", "outer", "b", "outer", None]


def test_idle_share_reads_the_untraced_calls():
    idle = metric("device.idle_share")
    from qrbench.trace import Trace
    t = Trace(calls=2, window_s=0.9, untraced_s=0.5, config={}, traffic={},
              device_events=[("k", 0.0, 1e5), ("k", 2e5, 3e5)], matmuls=[], counters={},
              busy_s=0.2)
    assert idle.read(t) == pytest.approx(60.0)      # 1 - 0.2 / 0.5, not 1 - 0.2 / 0.9
    t.device_events = []
    assert idle.read(t) is None
