"""The control reads ``correct`` false on the card: the program's own path
one precision below the configuration's, as its ``control`` states (every
GEMM in one TF32 pass, ``precision="tf32"``; or the trailing update in one
TF32 pass instead of 3xTF32, ``trailing_precision="tf32"``), in every cell
of BENCHMARK.json, at sizes a test run holds.  TF32 exists only on the
card, so these tests need one:

    python -m pytest -m cuda qrbench/tests/test_qrbench_control.py
"""

import json

import pytest
import torch

from qrbench import run, spec
from qrbench.tests.tiny_root import card_cut, cells, make_root

CELLS = cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    return make_root(tmp_path_factory.mktemp("root"), card_cut, rhs_cols=128)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_program_reads_correct(root, workload):
    result = run.run_cell(workload, 2**31 + 3, 1.0, False, root=root)
    assert result["correct"], json.dumps(result["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_incorrect(root, workload, seed):
    control = spec.load(workload, root).config["control"]
    result = run.run_cell(workload, seed, 1.0, False, root=root, overrides=control)
    assert not result["correct"], json.dumps(result["checks"])
