"""The result line of a tiny rehearsal on the CPU, and the command's
refusal without a card."""

import json
import subprocess
import sys

import pytest
import torch

from qrbench import run, spec
from qrbench.tests.tiny_root import REPO, cells, make_root

CELLS = cells()
DEVICE_SOURCES = ("device_trace",)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_result_line_shape(root, workload, trace):
    result = run.run_cell(workload, 2**31 + 11, 0.3, trace, root=root, device="cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"] and "window_s" not in result["device"]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    device_metrics = {m["name"] for m in bench["per_layer"] + bench["end_to_end"]
                      if m["source"] in DEVICE_SOURCES}
    assert not device_metrics & set(result["metrics"])
    if trace:
        assert set(result["metrics"]) <= {m["name"] for m in bench["per_layer"]}
    else:
        names = {m["name"] for m in spec.load(workload, root).end_to_end}
        assert set(result["metrics"]) == names and "setup_s" in names
        assert {spec.quantity(n, run.E2E) for n in names} == set(run.E2E)
        assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"} and check["value"] <= check["limit"]
    json.dumps(result)


def test_host_syncs_counted_in_traced_qr(root):
    result = run.run_cell("qr8192.qr", 5, 0.1, True, root=root, device="cpu")
    assert result["metrics"]["driver.host_syncs_per_call"]["value"] > 0


def test_no_card_exits_without_a_result():
    proc = subprocess.run([sys.executable, "-m", "qrbench", "--workload", "qr8192.qr",
                           "--seed", "1", "--seconds", "1"], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 2 and proc.stdout == ""


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert run.percentile(values, 90) == 90
    assert run.percentile([5.0], 90) == 5.0
    assert run.percentile([3, 1, 2], 90) == 3


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed):
        r = run.Reservoir(4, seed)
        for i in range(100):
            r.offer(i)
        return r.items
    assert draw(7) == draw(7) and len(draw(7)) == 4
    assert draw(7) != draw(8)


def test_process_start_is_before_now():
    import time
    assert run.process_start() <= time.perf_counter()
