"""The reader of B2's blocked-body launch counter
(``kernels.b2_leaf_launches_per_call``): nothing from a program without the
counter, a count per call from one with it, and in a traced CPU rehearsal
of the cell ``tsqr1M.qr`` 0 launches (the CPU takes the plain version)."""

import math
import types

import pytest
import torch

import cuda_qr_tpu_torch as program
from cuda_qr_tpu_torch.ops import geqrt as geqrt_module
from qrbench import run
from qrbench.tests.test_qrbench_roofline import metric
from qrbench.tests.tiny_root import make_root
from qrbench.trace import Trace

NAME = "kernels.b2_leaf_launches_per_call"
CELL = "tsqr1M.qr"


def _trace(delta):
    return Trace(calls=10, window_s=0.3, untraced_s=0.25, config={}, traffic={},
                 device_events=[], matmuls=[], counters={NAME: delta})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("bare", [
    types.SimpleNamespace(),
    types.SimpleNamespace(ops=types.SimpleNamespace()),
    types.SimpleNamespace(ops=types.SimpleNamespace(geqrt=types.SimpleNamespace(
        geqrt_batched=lambda panels, off: None))),
], ids=["no-ops", "no-geqrt-module", "no-counter"])
def test_a_program_without_the_counter_reads_nothing(bare):
    m = metric(NAME)
    assert math.isnan(m.counter(bare))
    assert m.read(_trace(m.counter(bare) - m.counter(bare))) is None


def test_reads_a_count_per_call():
    m = metric(NAME)
    batched = types.SimpleNamespace(leaf_launches=30)
    with_counter = types.SimpleNamespace(ops=types.SimpleNamespace(
        geqrt=types.SimpleNamespace(geqrt_batched=batched)))
    assert m.counter(with_counter) == 30
    assert m.read(_trace(100)) == 10.0
    assert m.read(_trace(0)) == 0.0


def test_counter_is_the_programs():
    m = metric(NAME)
    assert m.counter(program) == geqrt_module.geqrt_batched.leaf_launches


def test_traced_rehearsal_reads_no_launch_on_the_cpu(root):
    result = run.run_cell(CELL, 2**31 + 37, 0.1, True, root=root, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"][NAME]["value"] == 0.0


def test_a_program_without_the_counter_leaves_the_metric_out(root, monkeypatch):
    monkeypatch.delattr(geqrt_module.geqrt_batched, "leaf_launches")
    result = run.run_cell(CELL, 2**31 + 41, 0.1, True, root=root, device="cpu")
    assert result["correct"] and NAME not in result["metrics"]
