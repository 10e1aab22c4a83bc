"""Find a cell's files by the names in BENCHMARK.json.

A cell is one entry of ``workloads``.  Its configuration is the file its
``configs`` entry names; its traffic mix is ``qrbench/traffic/<traffic>.json``;
its limits are ``qrbench/limits/<workload>.json``; its reference is the
module ``qrbench/reference/<check>.py`` that the traffic file names; each
per-layer metric is ``qrbench/metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix or a metric is adding files and entries:
nothing here changes.

A metric's name may split a quantity by the cells that report it: a
dotted suffix that names no file or value of its own, as in
``call_ms.tsqr1M`` (``call_ms``, with a bound of its own) or
``device.idle_share.tsqr1M`` (read by ``metrics/device.idle_share.py``).
The longest dotted prefix that is known is the quantity.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = "qrbench"


@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict          # the BENCHMARK.json entry
    config: dict            # the configuration file's content
    traffic: dict           # the traffic file's content
    limits: dict            # the limits file's content
    end_to_end: list        # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list         # ... and with --trace 1


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def quantity(name: str, known) -> str:
    """The longest dotted prefix of ``name`` that is in ``known``."""
    parts = name.split(".")
    for k in range(len(parts), 0, -1):
        if ".".join(parts[:k]) in known:
            return ".".join(parts[:k])
    raise KeyError(f"qrbench: no reader or value for the metric {name!r}")


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """A metric's ``workloads``, or without them (a per-layer metric) every
    cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` under ``root`` (a checkout)."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"qrbench: no workload {workload!r} in BENCHMARK.json "
                         f"(have {', '.join(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = _read(root / HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(root=root, workload=w, config=_read(root / conf["file"]), traffic=traffic,
                limits=_read(root / HERE / "limits" / f"{workload}.json"),
                end_to_end=e2e, per_layer=per_layer)


def metric_file(cell: Cell, name: str) -> Path:
    """The file of the reader of one per-layer metric (of its quantity)."""
    folder = cell.root / HERE / "metrics"
    return folder / f"{quantity(name, {p.stem for p in folder.glob('*.py')})}.py"


def metric_module(cell: Cell, name: str):
    """The reader of one per-layer metric, loaded from its own file."""
    path = metric_file(cell, name)
    spec = importlib.util.spec_from_file_location(
        f"qrbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(cell: Cell):
    """The reference that judges this cell's answers (``check`` in the traffic)."""
    return importlib.import_module(f"qrbench.reference.{cell.traffic['check']}")
