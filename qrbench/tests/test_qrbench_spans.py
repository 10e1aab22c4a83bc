"""The readers of the program's span totals: ms per call from a hand-made
Trace, None on the CPU and with a program that has no spans, and a
counter that a tiny CPU qr inside a profiler moves."""

import math
import types

import pytest
import torch

import cuda_qr_tpu_torch as program
from qrbench.tests.test_qrbench_roofline import metric
from qrbench.trace import Trace

SPAN_METRICS = ("driver.host_sync_wait_ms_per_call", "panel.self_ms_per_call",
                "driver.self_ms_per_call")


def _trace(name, delta, device_events):
    return Trace(calls=4, window_s=1.2, untraced_s=1.0, config={}, traffic={},
                 device_events=device_events, matmuls=[], counters={name: delta},
                 busy_s=0.3 if device_events else None)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reads_ms_per_call_on_the_card_only(name):
    m = metric(name)
    assert m.read(_trace(name, 0.2, [("k", 0.0, 1.0)])) == pytest.approx(50.0)
    assert m.read(_trace(name, 0.2, [])) is None
    assert m.read(_trace(name, math.nan, [("k", 0.0, 1.0)])) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_program_without_spans_reads_nothing(name):
    bare = types.SimpleNamespace(utils=types.SimpleNamespace())
    assert math.isnan(metric(name).counter(bare))


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_counter_reads_the_programs_totals(name):
    m = metric(name)
    config = program.QRConfig(device="cpu", panel_width=32)
    A = torch.randn(128, 96, generator=torch.Generator().manual_seed(3))
    program.qr(A, config)
    before = m.counter(program)
    program.qr(A, config)
    assert m.counter(program) == before             # no profiler: the spans are off
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        program.qr(A, config)
    assert m.counter(program) > before
