"""The reader of the direct path's fallback counter
(``driver.tsqr_fallbacks_per_call``): nothing from a program without the
counter, a count per call from one with it, and in a traced rehearsal of
the cell ``tsqr1M.cholqr2`` 0 fallbacks and 2 host syncs a call."""

import math
import types

import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as program
from cuda_qr_tpu_torch.models import tsqr as tsqr_module
from qrbench import run
from qrbench.tests.test_qrbench_roofline import metric
from qrbench.tests.tiny_root import make_root
from qrbench.trace import Trace

NAME = "driver.tsqr_fallbacks_per_call"
CELL = "tsqr1M.cholqr2"


def _trace(delta):
    return Trace(calls=4, window_s=1.2, untraced_s=1.0, config={}, traffic={},
                 device_events=[], matmuls=[], counters={NAME: delta})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("bare", [
    types.SimpleNamespace(models=types.SimpleNamespace()),
    types.SimpleNamespace(models=types.SimpleNamespace(tsqr=types.SimpleNamespace())),
], ids=["no-tsqr-module", "no-counter"])
def test_a_program_without_the_counter_reads_nothing(bare):
    m = metric(NAME)
    assert math.isnan(m.counter(bare))
    assert m.read(_trace(m.counter(bare) - m.counter(bare))) is None


def test_reads_a_count_per_call():
    m = metric(NAME)
    with_counter = types.SimpleNamespace(models=types.SimpleNamespace(
        tsqr=types.SimpleNamespace(direct_fallbacks=7)))
    assert m.counter(with_counter) == 7
    assert m.read(_trace(2)) == pytest.approx(0.5)
    assert m.read(_trace(0)) == 0.0


def test_counter_follows_the_programs_fallbacks():
    m = metric(NAME)
    rng = np.random.default_rng(5)
    U, _ = np.linalg.qr(rng.standard_normal((2048, 16)))
    A = torch.from_numpy(((U * np.logspace(0, -7.5, 16))).astype(np.float32))
    config = program.QRConfig(device="cpu", block_rows=256, tsqr_leaf="cholqr2")
    before = m.counter(program)
    program.tsqr(A, config)                  # cond ~ 3e7: the certificate fails
    assert m.counter(program) - before == 1
    program.tsqr(torch.randn(2048, 16, generator=torch.Generator().manual_seed(5)), config)
    assert m.counter(program) - before == 1


def test_traced_rehearsal_reads_no_fallback_and_two_syncs(root):
    result = run.run_cell(CELL, 2**31 + 29, 0.1, True, root=root, device="cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"][NAME]["value"] == 0.0
    assert result["metrics"]["driver.host_syncs_per_call.cholqr2"]["value"] == 2.0


def test_a_program_without_the_counter_leaves_the_metric_out(root, monkeypatch):
    monkeypatch.delattr(tsqr_module, "direct_fallbacks")
    result = run.run_cell(CELL, 2**31 + 31, 0.1, True, root=root, device="cpu")
    assert result["correct"] and NAME not in result["metrics"]
    assert "driver.host_syncs_per_call.cholqr2" in result["metrics"]
