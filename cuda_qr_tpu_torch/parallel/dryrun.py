"""A multi-rank dry run of the distributed layer on the CPU, and the rank
bodies that compose several distributed calls.

    python -m cuda_qr_tpu_torch.parallel.dryrun [P]

``dryrun_multichip(P)`` is the counterpart of the reference's
``dryrun_multichip`` (``__graft_entry__.py``): on P gloo ranks on the CPU,
at tiny shapes (nb = 8), it runs CAQR with the "bk" combine in the block
layout, the "allgather" combine and the cyclic layout, the ormqr round trip
on both factor forms, a crash-and-resume of the resumable CAQR in both
layouts, CAQR at nb = 32, TSQR with the butterfly combine and with
CholeskyQR2 leaves, ``lstsq_dist`` and ``polar_dist``, checks each, and
prints one line of results.
"""

from __future__ import annotations

import os
import sys
import tempfile
import types

import numpy as np
import torch

from ..utils.config import QRConfig
from ..utils.verify import check_qr
from . import caqr_resumable
from .caqr import caqr_factor, caqr_orgqr, caqr_ormqr, cyclic_permutation
from .launch import run_ranks, to_host


def ormqr_roundtrip(mesh, A, B, config: QRConfig, layout: str, combine: str):
    """Rank body: factor A (already in the layout's storage order), then
    (R, explicit Q, Q^T B, Q (Q^T B)) from the factors."""
    factors, R = caqr_factor(A, mesh, config, layout=layout, combine=combine)
    Q = caqr_orgqr(factors, mesh, A.shape[1], config, layout=layout)
    QtB = caqr_ormqr(factors, B, mesh, config, layout=layout, transpose=True)
    back = caqr_ormqr(factors, QtB, mesh, config, layout=layout, transpose=False)
    return R, Q, QtB, back


def caqr_sharded(mesh, A, config: QRConfig, layout: str, combine: str):
    """Rank body: ``caqr`` of A handed over as a row-sharded DTensor (torch's
    split of the rows, uneven when the rank count does not divide them)."""
    from torch.distributed.tensor import distribute_tensor

    from ..models.caqr import caqr
    from .mesh import row_sharding
    Ad = distribute_tensor(torch.as_tensor(A), mesh, row_sharding(mesh), src_data_rank=None)
    return caqr(Ad, mesh, config, layout=layout, combine=combine)


def carried(mesh, fields: dict, B, n_cols: int, config: QRConfig, layout: str):
    """Rank body: the reference's CAQR factors (``fields``, as numpy) carried
    across with ``factors_from_reference``; returns (Q, Q^T B, Q B)."""
    from ..utils.interop import factors_from_reference
    factors = factors_from_reference(types.SimpleNamespace(**fields), mesh)
    return (caqr_orgqr(factors, mesh, n_cols, config, layout=layout),
            caqr_ormqr(factors, B, mesh, config, layout=layout, transpose=True),
            caqr_ormqr(factors, B, mesh, config, layout=layout, transpose=False))


class _Crash(Exception):
    """The simulated crash of ``crash_and_resume``."""


def crash_and_resume(mesh, A, config: QRConfig, layout: str, combine: str,
                     crash_after: int, every: int, path: str):
    """Rank body: run ``caqr_factor_resumable`` with checkpoints in ``path``,
    crash it after ``crash_after`` panels, rerun the same call (it resumes)
    and factor once more with ``caqr_factor``.  Returns (snapshot panels of
    this rank after the crash, this rank's panel files, resumed (factors,
    R), uninterrupted (factors, R))."""
    name = "_panel_step_bk" if combine == "bk" else "_panel_step"
    orig = getattr(caqr_resumable, name)
    calls = {"n": 0}

    def crashing(*args):
        if calls["n"] == crash_after:
            raise _Crash
        calls["n"] += 1
        return orig(*args)

    setattr(caqr_resumable, name, crashing)
    try:
        caqr_resumable.caqr_factor_resumable(A, mesh, config, layout=layout, checkpoint_path=path,
                                             every=every, combine=combine)
        raise AssertionError("the simulated crash did not fire")
    except _Crash:
        pass
    finally:
        setattr(caqr_resumable, name, orig)
    rank = mesh.get_local_rank(0)
    snapshots = caqr_resumable._states(path, rank)
    files = sorted(f for f in os.listdir(path) if f.endswith(f"_r{rank}.npz")
                   and f.startswith("panel_"))
    resumed = caqr_resumable.caqr_factor_resumable(A, mesh, config, layout=layout,
                                                   checkpoint_path=path, every=every,
                                                   combine=combine)
    return snapshots, files, resumed, caqr_factor(A, mesh, config, layout=layout, combine=combine)


def _dryrun_checks(mesh, path: str) -> list[str]:
    """Rank body of ``dryrun_multichip``: the checks, as result strings."""
    import cuda_qr_tpu_torch as ct

    P = mesh.size(0)
    nb = 8
    m, n = P * 2 * nb, 4 * nb
    cfg = QRConfig(panel_width=nb, dtype=torch.float32, use_kernels=False, device="cpu",
                   block_rows=64)
    rng = np.random.default_rng(12)
    A = rng.standard_normal((m, n)).astype(np.float32)
    eps = float(np.finfo(np.float32).eps)
    checks = []

    def gate(name, M, Q, R, width):
        chk = check_qr(M, to_host(Q, mesh), to_host(R, mesh))
        if not chk.residual < 4 * width * chk.eps:
            raise AssertionError(f"{name}: {chk}")
        checks.append(f"{name} {chk.residual:.2e}")

    for combine, layout in (("bk", "block"), ("allgather", "block"), ("bk", "cyclic")):
        Q, R = ct.caqr(A, mesh, cfg, layout=layout, combine=combine)
        gate(f"caqr-{combine}-{layout}", A, Q, R, n)

    anorm = float(np.linalg.norm(A))
    RB = np.zeros((m, n), np.float32)
    for combine in ("bk", "allgather"):
        Rf, _, QtA, _ = to_host(ormqr_roundtrip(mesh, A, A, cfg, "block", combine), mesh)
        err_r = float(np.linalg.norm(np.triu(QtA[:n]) - Rf[:n]))
        if not err_r < 8 * n * eps * anorm:
            raise AssertionError(f"ormqr-{combine}: Q^T A vs R {err_r}")
        RB[:n] = Rf[:n]
        fac, _ = caqr_factor(A, mesh, cfg, combine=combine)
        QR = to_host(caqr_ormqr(fac, RB, mesh, cfg, transpose=False), mesh)
        err_a = float(np.linalg.norm(QR - A)) / anorm
        if not err_a < 8 * n * eps:
            raise AssertionError(f"ormqr-{combine}: Q R vs A {err_a}")
        checks.append(f"ormqr-roundtrip-{combine} {err_a:.2e}")

    perm, _ = cyclic_permutation(m, nb, P)
    for layout, As in (("block", A), ("cyclic", A[perm])):
        ck = os.path.join(path, layout)
        _, _, (_, R_r), (_, R_m) = crash_and_resume(mesh, As, cfg, layout, "bk", 2, 1, ck)
        err = float((R_r - R_m).abs().max())
        if not err < 1e-4:
            raise AssertionError(f"resume-bk-{layout}: {err}")
        checks.append(f"resume-bk-{layout} {err:.2e}")

    cfg32 = cfg.replace(panel_width=32)
    A32 = rng.standard_normal((P * 64, 128)).astype(np.float32)
    Q32, R32 = ct.caqr(A32, mesh, cfg32)
    gate("caqr-bk-nb32", A32, Q32, R32, 128)

    B = rng.standard_normal((P * 32, 8)).astype(np.float32)
    strategy = "butterfly" if (P & (P - 1)) == 0 else "allgather"
    Qt, Rt = ct.tsqr_dist(B, mesh, cfg, strategy=strategy)
    gate(f"tsqr-{strategy}", B, Qt, Rt, 8)
    Qt2, Rt2 = ct.tsqr_dist(B, mesh, cfg.replace(tsqr_leaf="cholqr2"), strategy=strategy)
    gate("tsqr-cholqr2-leaves", B, Qt2, Rt2, 8)

    bb = rng.standard_normal(m).astype(np.float32)
    sol = ct.lstsq_dist(A, bb, mesh, cfg)
    x_ref = np.linalg.lstsq(A.astype(np.float64), bb.astype(np.float64), rcond=None)[0]
    if not np.allclose(sol.x.numpy(), x_ref, atol=n * 1e-5):
        raise AssertionError("lstsq_dist disagrees with numpy's lstsq")
    checks.append("lstsq_dist ok")

    Ap = rng.standard_normal((P * 16, 16)).astype(np.float32)
    U, H = ct.polar_dist(Ap, mesh, config=cfg)
    U = to_host(U, mesh)
    err_o = float(np.linalg.norm(U.T @ U - np.eye(16)))
    err_p = float(np.linalg.norm(U @ H.numpy() - Ap) / np.linalg.norm(Ap))
    if not (err_o < 1e-4 and err_p < 1e-5):
        raise AssertionError(f"polar_dist: {err_o}, {err_p}")
    checks.append(f"polar_dist {err_p:.2e}")
    return checks


def dryrun_multichip(n_devices: int) -> str:
    """Run the checks on ``n_devices`` gloo ranks on the CPU; print and
    return the result line.  Raises on any failed check."""
    with tempfile.TemporaryDirectory(prefix="cqt_dryrun_") as path:
        checks = run_ranks(n_devices, _dryrun_checks, path, device="cpu")[0]
    P = n_devices
    line = f"dryrun_multichip({P}): CAQR {P * 16}x32 " + " / ".join(checks)
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
