"""Readings that a cell's limits are set from, in one process per call.

    python -m qrbench.readings --workload NAME [--workload NAME ...]
        --seeds N [N ...] --control-seeds N [N ...] --seconds S [--out FILE]

For each workload: runs of the program as its configuration states, one
per seed, each with a window of ``--seconds`` at the cell's own load and
its reference's judgement of as many calls as a benchmark run judges; then
runs of the control (the program with the configuration's ``control``
fields, its own path one precision below), one per control seed.  Prints
each run's numbers, and the lower reading (the largest over the program's
runs) and upper reading (the smallest over the control's) of every number;
writes them as JSON to ``--out``.  Needs a card.  The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from qrbench import spec
from qrbench.run import run_cell


def readings(workload: str, seeds: list, control_seeds: list, seconds: float,
             root: Path = spec.ROOT, device: str = "cuda") -> dict:
    """{"program": [...], "control": [...], "lower": {...}, "upper": {...}}."""
    cell = spec.load(workload, root)
    runs = {"program": [], "control": []}
    for side, seed_list, overrides in (("program", seeds, None),
                                       ("control", control_seeds, cell.config["control"])):
        for seed in seed_list:
            r = run_cell(workload, seed, seconds, False, root=root, device=device,
                         overrides=overrides)
            rec = {"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                   "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                   "numbers": {k: c["value"] for k, c in r["checks"].items()}}
            runs[side].append(rec)
            print(f"readings {workload} {side} {json.dumps(rec)}", file=sys.stderr, flush=True)
    names = sorted({k for rec in runs["program"] + runs["control"] for k in rec["numbers"]})

    def pick(side, fn):
        out = {}
        for k in names:
            vals = [rec["numbers"].get(k) for rec in runs[side]]
            out[k] = None if any(v is None for v in vals) or not vals else fn(vals)
        return out
    return {**runs, "lower": pick("program", max), "upper": pick("control", min)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m qrbench.readings",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="build/qrbench/readings.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("qrbench.readings: needs a CUDA device", file=sys.stderr)
        return 2
    out = {w: readings(w, args.seeds, args.control_seeds, args.seconds)
           for w in args.workload}
    for w, r in out.items():
        print(f"{w} lower {json.dumps(r['lower'])}")
        print(f"{w} upper {json.dumps(r['upper'])}")
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
