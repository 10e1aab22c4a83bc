"""A checkout-like root with the benchmark's files at sizes a test run
holds: the same cells, configurations cut to small shapes, and a cell of
Q^T B traffic (``qr8192.apply_qt``), which the generator and the reference
``apply_qt`` serve but no cell of BENCHMARK.json runs yet.

A configuration is cut by its published ``shape``, never by its name, so a
configuration or a cell added as files and entries is cut, rehearsed and
tried with no edit here; ``cells`` gives the tests their cells from
BENCHMARK.json."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
APPLY_QT = "qr8192.apply_qt"


def tiny_cut(shape) -> dict:
    """The CPU tests' cut of a configuration of ``shape`` (m, n): its new
    ``shape`` and the QRConfig fields that keep the algorithm's structure at
    it.  Square: 192 x 192 in panels of 32 (six panels, the groups of
    factor_lookahead 4 and a partial group).  Tall: 4,096 x min(n, 32) in
    leaves of 1,024 rows (a tree of four leaves)."""
    m, n = shape
    if m == n:
        return {"shape": [192, 192], "panel_width": 32}
    if m > n:
        return {"shape": [4096, min(n, 32)], "block_rows": 1024}
    raise ValueError(f"no cut for a wide shape {shape}")


def card_cut(shape) -> dict:
    """The card tests' cut of a configuration of ``shape`` (m, n): square
    2,048 x 2,048, tall 262,144 x n; the QRConfig as stated."""
    m, n = shape
    return {"shape": [2048, 2048]} if m == n else {"shape": [262144, n]}


def cells(root: Path = REPO) -> tuple:
    """The cells of ``root``'s BENCHMARK.json, in its order, and the
    ``qr8192.apply_qt`` cell that ``make_root`` adds."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return tuple(w["name"] for w in bench["workloads"]) + (APPLY_QT,)


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


def make_root(tmp: Path, cut=tiny_cut, rhs_cols: int = 16, source: Path = REPO) -> Path:
    """Copy ``source``'s BENCHMARK.json and qrbench/'s data files under
    ``tmp``, with every configuration cut to ``cut(its shape)``, and add the
    cell ``qr8192.apply_qt`` with B of ``rhs_cols`` columns."""
    shutil.copy(source / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(source / "qrbench", tmp / "qrbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = tmp / c["file"]
        conf = json.loads(path.read_text())
        fields = cut(conf["shape"])
        conf["shape"] = fields.pop("shape")
        conf["qr_config"].update(fields)
        path.write_text(json.dumps(conf))
    _add_apply_qt(tmp, bench, rhs_cols)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
