"""Resumable distributed CAQR: a panel-at-a-time driver with checkpoints
(``cuda_qr_tpu/parallel/caqr_resumable.py``).

Each panel is the monolithic factorization's own step (``caqr._panel_step``
/ ``caqr._panel_step_bk``), so a resumed run gives the same factors.  The
snapshots live in one directory, shared by the ranks:

  panel_NNNN_rR.npz   rank R's fields of finished panel NNNN (tau, T, Y),
                      written once;
  panel_NNNN.npz      the replicated fields of panel NNNN, written by rank 0;
  state_rR_NNNN.npz   rank R's rows of the matrix before panel NNNN, with
                      the problem's meta, every ``every`` panels; the two
                      newest are kept.

Every file is written atomically (tmp + rename).  On resume the ranks agree
on the panel to restart from (all_reduce(MIN) of each rank's newest
snapshot), so a crash between two ranks' writes loses at most ``every``
panels.  A snapshot of another problem is rejected on every rank.
"""

from __future__ import annotations

import glob
import os

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..utils.checkpoint import load_state, save_state
from ..utils.config import DEFAULT_CONFIG, QRConfig
from .caqr import (FIELDS, LOCAL_FIELDS, _assemble, _check_factor, _ctx, _local_copy,
                   _panel_step, _panel_step_bk)
from .collectives import agree, pmin

KEEP_STATES = 2


def panel_file(path: str, kk: int, rank: int | None = None) -> str:
    """Panel kk's file of ``rank``, or its replicated file (rank None)."""
    tail = "" if rank is None else f"_r{rank}"
    return os.path.join(path, f"panel_{kk:04d}{tail}.npz")


def state_file(path: str, rank: int, next_panel: int) -> str:
    return os.path.join(path, f"state_r{rank}_{next_panel:04d}.npz")


def _states(path: str, rank: int) -> list[int]:
    """The panels this rank holds a state snapshot before, ascending."""
    names = glob.glob(os.path.join(path, f"state_r{rank}_*.npz"))
    return sorted(int(os.path.basename(p)[:-4].rsplit("_", 1)[1]) for p in names)


def caqr_factor_resumable(A, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
                          layout: str = "block", checkpoint_path: str | None = None,
                          every: int = 4, combine: str = "bk"):
    """Distributed CAQR with per-panel checkpoints, called by every rank.

    Same result as ``caqr.caqr_factor`` with the matching ``combine``: "bk"
    (default) returns CAQRFactorsBK, "allgather" CAQRFactors.
    ``checkpoint_path`` is a directory shared by the ranks (module
    docstring); a rerun of the same call resumes from the newest snapshot
    that every rank holds.  A must already be padded and in the layout's
    storage order, as for ``caqr_factor``.
    """
    _check_factor(A, mesh, config, layout, combine)
    m, n = A.shape
    a = _local_copy(A, mesh, config)
    c = _ctx(mesh, config, layout, a.shape[0], n)
    k = n // c.nb
    fields = FIELDS[combine]
    meta = {"m": m, "n": n, "nb": c.nb, "layout": layout, "P": c.P, "combine": combine}
    cols = {f: [] for f in fields}
    start = 0
    if checkpoint_path:
        start = _resume(a, cols, checkpoint_path, meta, fields, c)
    step = _panel_step_bk if combine == "bk" else _panel_step
    for kk in range(start, k):
        for f, v in zip(fields, step(a, kk, c)):
            cols[f].append(v)
        done = kk + 1
        if checkpoint_path and done < k:
            _snapshot(a, cols, checkpoint_path, kk, done, every, meta, fields, c)
    return _assemble(a, cols, layout, combine, c)


def _snapshot(a, cols, path, kk, done, every, meta, fields, c) -> None:
    """Write panel kk's files, and this rank's state every ``every`` panels."""
    save_state(panel_file(path, kk, c.i),
               {f: cols[f][-1] for f in fields if f in LOCAL_FIELDS}, {"panel": kk})
    if c.i == 0:
        save_state(panel_file(path, kk),
                   {f: cols[f][-1] for f in fields if f not in LOCAL_FIELDS}, {"panel": kk})
    if done % every == 0:
        save_state(state_file(path, c.i, done), {"A": a}, {"next_panel": done, **meta})
        for old in _states(path, c.i)[:-KEEP_STATES]:
            os.unlink(state_file(path, c.i, old))


def _resume(a, cols, path, meta, fields, c) -> int:
    """Load the newest snapshot that every rank holds into ``a`` and
    ``cols``; returns the panel to restart from (0: none)."""
    have = _states(path, c.i)
    mine = have[-1] if have else 0
    if mine:
        _, saved = load_state(state_file(path, c.i, mine))
        stale = any(saved.get(key) != value for key, value in meta.items())
    else:
        saved, stale = None, False
    if agree(torch.tensor(stale), c.mesh):
        raise ValueError(f"checkpoint {path} does not match this problem: {saved} vs {meta}")
    start = pmin(mine, c.mesh)
    if agree(torch.tensor(start > 0 and start not in have), c.mesh):
        raise RuntimeError(f"checkpoint {path}: no snapshot before panel {start} on every rank")
    if start == 0:
        return 0
    state, _ = load_state(state_file(path, c.i, start))
    a.copy_(torch.as_tensor(state["A"]))
    for kk in range(start):
        local, _ = load_state(panel_file(path, kk, c.i))
        shared, _ = load_state(panel_file(path, kk))
        for f in fields:
            cols[f].append(torch.as_tensor((local if f in LOCAL_FIELDS else shared)[f],
                                           device=a.device))
    return start
