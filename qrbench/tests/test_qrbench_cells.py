"""A configuration and a cell added as files and BENCHMARK.json entries are
cut by their shape, rehearsed on the CPU and listed among the tests' cells
with no edit to a test; and the mixed-precision cell ``qr8192.mixed``:
its control reaches the program, and it reports its own per-layer metrics.
"""

import json
import shutil

import pytest
import torch

import cuda_qr_tpu_torch as ct
from qrbench import run, spec
from qrbench.tests.tiny_root import REPO, card_cut, cells, make_root, tiny_cut

MIXED = "qr8192.mixed"
MIXED_METRICS = {"device.launches_per_call.mixed", "device.idle_share.mixed",
                 "driver.self_ms_per_call.mixed", "panel.self_ms_per_call.mixed"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("root"))


def test_the_cut_follows_the_shape():
    assert tiny_cut([8192, 8192]) == {"shape": [192, 192], "panel_width": 32}
    assert tiny_cut([1048576, 128]) == {"shape": [4096, 32], "block_rows": 1024}
    assert tiny_cut([6144, 6144]) == {"shape": [192, 192], "panel_width": 32}
    assert tiny_cut([524288, 16]) == {"shape": [4096, 16], "block_rows": 1024}
    with pytest.raises(ValueError):
        tiny_cut([128, 8192])


def _source_with_an_added_cell(src, shape, traffic):
    """A copy of the repository's benchmark files with one configuration of
    ``shape``, its cell ``added.cell`` under ``traffic`` and its limits added."""
    src.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", src / "BENCHMARK.json")
    shutil.copytree(REPO / "qrbench", src / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    q = src / "qrbench"
    conf = json.loads((q / "configs" / "qr_square_8192_f32.json").read_text())
    conf.update(name="added_config", shape=shape)
    (q / "configs" / "added_config.json").write_text(json.dumps(conf))
    (q / "limits" / "added.cell.json").write_text((q / "limits" / "qr8192.qr.json").read_text())
    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "added_config", "source": "https://example.org/added",
                             "file": "qrbench/configs/added_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "added.cell", "config": "added_config",
                               "traffic": traffic, "chips": 1, "why": "a test"})
    (src / "BENCHMARK.json").write_text(json.dumps(bench))


@pytest.mark.parametrize("shape,traffic,cut", [
    ([6144, 6144], "qr", [192, 192]),           # square, a shape no cell has
    ([8192, 8192], "qr", [192, 192]),           # a shape another configuration has
    ([524288, 64], "tsqr", [4096, 32]),         # tall
])
def test_a_configuration_added_as_files_is_cut_and_rehearsed(tmp_path, shape, traffic, cut):
    torch.set_num_threads(2)
    src = tmp_path / "src"
    _source_with_an_added_cell(src, shape, traffic)
    (tmp_path / "root").mkdir()
    root = make_root(tmp_path / "root", source=src)
    added = json.loads((root / "qrbench" / "configs" / "added_config.json").read_text())
    assert added["shape"] == cut
    assert cells(src) == cells()[:-1] + ("added.cell", cells()[-1])
    for trace in (False, True):
        result = run.run_cell("added.cell", 2**31 + 13, 0.1, trace, root=root, device="cpu")
        assert result["correct"], json.dumps(result["checks"])


def test_mixed_runs_its_stated_precision_and_its_control_one_below(root, monkeypatch):
    cell = spec.load(MIXED, root)
    assert cell.traffic["check"] == "thin_qr"
    assert cell.config["qr_config"]["trailing_precision"] == "high"
    seen, orig = [], ct.qr

    def spy(A, config, **kw):
        seen.append(config.resolved_trailing_precision())
        return orig(A, config, **kw)
    monkeypatch.setattr(ct, "qr", spy)
    result = run.run_cell(MIXED, 2**31 + 17, 0.1, False, root=root, device="cpu")
    assert result["correct"], json.dumps(result["checks"])
    assert seen and set(seen) == {"high"}
    seen.clear()
    run.run_cell(MIXED, 2**31 + 17, 0.1, False, root=root, device="cpu",
                 overrides=cell.config["control"])
    assert seen and set(seen) == {"tf32"}


def test_mixed_reports_its_four_metrics_and_no_gemm_roofline(root):
    assert MIXED in cells()
    cell = spec.load(MIXED, root)
    assert {m["name"] for m in cell.end_to_end} == {"call_ms.mixed", "call_p90_ms.mixed",
                                                   "setup_s"}
    assert {m["name"] for m in cell.per_layer} == MIXED_METRICS
    assert all(m["moves"] == "call_ms.mixed" for m in cell.per_layer)
    result = run.run_cell(MIXED, 2**31 + 19, 0.1, True, root=root, device="cpu")
    assert result["correct"] and set(result["metrics"]) <= MIXED_METRICS


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the per-layer metrics read the device's trace")
    return make_root(tmp_path_factory.mktemp("card_root"), card_cut, rhs_cols=128)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_a_traced_run_on_the_card_reports_every_metric_of_its_cell(card_root, workload):
    cell = spec.load(workload, card_root)
    result = run.run_cell(workload, 2**31 + 23, 1.0, True, root=card_root)
    assert result["correct"], json.dumps(result["checks"])
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    assert result["device"]["busy_s"] > 0 and "breakdown" in result
    shares = [v["value"] for k, v in result["metrics"].items() if k.endswith("_roofline")]
    assert all(0 < s <= 100 for s in shares), result["metrics"]
