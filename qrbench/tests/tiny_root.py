"""A checkout-like root with the benchmark's files at sizes a CPU test run
holds: the same cells, configurations cut to small shapes, and a cell of
Q^T B traffic (``qr8192.apply_qt``), which the generator and the reference
``apply_qt`` serve but no cell of BENCHMARK.json runs yet."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = {
    "qr_square_8192_f32": {"shape": [192, 192], "panel_width": 32},
    "tsqr_1M_128_f32": {"shape": [4096, 32], "block_rows": 1024},
}
APPLY_QT = "qr8192.apply_qt"


def apply_qt_traffic(rhs_cols: int) -> dict:
    return {"why": "qr_factor(A) once in set-up, then a closed loop of Q^T B",
            "loop": "closed", "clients": 1, "setup": "qr_factor", "entry": "apply_qt",
            "setup_outputs": ["R"], "kwargs": {}, "pool": 1, "rhs_cols": rhs_cols,
            "rhs_pool": 8, "warmup_calls": 8, "check": "apply_qt", "check_calls": 8,
            "trace_calls": 8}


def _add_apply_qt(tmp: Path, bench: dict, rhs_cols: int) -> None:
    q = tmp / "qrbench"
    (q / "traffic" / "apply_qt.json").write_text(json.dumps(apply_qt_traffic(rhs_cols)))
    (q / "limits" / f"{APPLY_QT}.json").write_text(json.dumps(
        {"factor_r_gap": {"limit": 1e-4}, "qtb_backward": {"limit": 1e-4}}))
    bench["workloads"].append({"name": APPLY_QT, "config": "qr_square_8192_f32",
                               "traffic": "apply_qt", "chips": 1, "why": "a test cell"})
    for name in ("call_ms", "call_p90_ms"):
        bench["end_to_end"].append({"name": f"{name}.apply_qt", "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": [APPLY_QT]})


def make_root(tmp: Path, sizes: dict = TINY, rhs_cols: int = 16) -> Path:
    """Copy BENCHMARK.json and qrbench/'s data files under ``tmp``, with
    every configuration cut to its shape in ``sizes``, and add the cell
    ``qr8192.apply_qt`` with B of ``rhs_cols`` columns."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "qrbench", tmp / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        conf = json.loads(path.read_text())
        cut = dict(sizes[c["name"]])
        conf["shape"] = cut.pop("shape")
        conf["qr_config"].update(cut)
        path.write_text(json.dumps(conf))
    _add_apply_qt(tmp, bench, rhs_cols)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
