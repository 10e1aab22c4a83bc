"""A configuration, a traffic mix, a per-layer metric and a cell are added
as files and BENCHMARK.json entries only: the harness finds them by name."""

import json

import pytest
import torch

from qrbench import run, spec
from qrbench.tests.tiny_root import make_root

METRIC = '''
def counter(program):
    return program.ops.smalllinalg.host_syncs


def read(trace):
    return trace.calls + 0.0 * trace.counters["added.calls_traced"]
'''


def test_new_files_are_found_with_no_code_edited(tmp_path):
    torch.set_num_threads(2)
    root = make_root(tmp_path)
    q = root / "qrbench"
    conf = json.loads((q / "configs" / "qr_square_8192_f32.json").read_text())
    conf["shape"] = [160, 96]
    conf["qr_config"]["panel_width"] = 16
    (q / "configs" / "qr_tall_added.json").write_text(json.dumps(conf))
    traffic = json.loads((q / "traffic" / "qr.json").read_text())
    traffic.update(pool=3, warmup_calls=3, trace_calls=3, check_calls=2)
    (q / "traffic" / "qr_added.json").write_text(json.dumps(traffic))
    (q / "metrics" / "added.calls_traced.py").write_text(METRIC)
    (q / "limits" / "added.qr.json").write_text(
        (q / "limits" / "qr8192.qr.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "qr_tall_added", "source": "https://example.org/added",
                             "file": "qrbench/configs/qr_tall_added.json", "reduced": []})
    bench["workloads"].append({"name": "added.qr", "config": "qr_tall_added",
                               "traffic": "qr_added", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "call_ms.added", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock", "workloads": ["added.qr"]})
    bench["per_layer"].append({"name": "added.calls_traced", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "call_ms.added",
                               "workloads": ["added.qr"]})
    bench["per_layer"].append({"name": "added.calls_traced.split", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "call_ms.added"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = run.run_cell("added.qr", 9, 0.1, False, root=root, device="cpu")
    assert plain["correct"] and set(plain["metrics"]) == {"call_ms.added", "setup_s"}
    traced = run.run_cell("added.qr", 9, 0.1, True, root=root, device="cpu")
    assert traced["correct"] and traced["metrics"] == {
        "added.calls_traced": {"value": 3.0, "unit": "calls"},
        "added.calls_traced.split": {"value": 3.0, "unit": "calls"}}


@pytest.mark.parametrize("name,quantity", [
    ("call_ms", "call_ms"), ("call_ms.tsqr1M", "call_ms"), ("setup_s", "setup_s"),
    ("call_p90_ms.a.b", "call_p90_ms")])
def test_a_split_end_to_end_name_reads_its_quantity(name, quantity):
    assert spec.quantity(name, run.E2E) == quantity


def test_a_split_per_layer_name_finds_its_reader():
    cell = spec.load("tsqr1M.qr")
    assert spec.metric_file(cell, "device.idle_share.tsqr1M").name == "device.idle_share.py"
    assert spec.metric_file(cell, "device.idle_share").name == "device.idle_share.py"
    with pytest.raises(KeyError):
        spec.metric_file(cell, "no_such.metric")
