"""Command line: ``python -m cuda_qr_tpu_torch <cmd> ...`` (the counterpart
of ``cuda_qr_tpu/cli.py``, with its commands, flags, records and exit codes).

Each command builds its input on the host from ``--seed`` (numpy), runs the
port on the card (``--platform cuda``, the default; without a card torch
raises its own error) or on the CPU (``--platform cpu``), verifies the
result and prints one JSON record.  Exit code 0, or 2 when the record's
``ok`` is false or the arguments are bad.

Commands:
  factor m n   -- blocked QR benchmark + verification
  tsqr m n     -- tall-skinny TSQR benchmark + verification
  lstsq m n k  -- least-squares solve benchmark
  compare m n  -- our QR vs torch.linalg.qr on the same device
  oracle m n pr pc -- run the C99 sliding-panel oracle end to end
  caqr m n [--devices D] [--layout block|cyclic] -- distributed CAQR on D
                  ranks (gloo on the CPU; on cards NCCL when each rank has
                  one, else gloo with the ranks sharing them)
  pivoted m n [--rank r] [--decay d] -- rank-revealing randomized QRCP
                  (optionally truncated at rank r; decay < 1 generates a
                  geometrically decaying spectrum)
  batched b m n -- batched small-matrix QR (sCholQR3) over a (b, m, n) stack
  update m n   -- rank-1 qr_update benchmark vs a full refactor
  decomp k m n -- LQ/RQ/QL benchmark + verification (k in {lq, rq, ql})
  rsvd m n     -- randomized rank-k SVD benchmark on a decaying spectrum
                  (--sym: symmetric eigh_rand benchmark instead)
  polar m n    -- QDWH polar decomposition benchmark + verification
  eigh n       -- QDWH-eig symmetric eigendecomposition + verification
  svd m n      -- QDWH SVD (--eigh-impl torch|qdwh) + verification
  dist KIND m n [--devices D] -- distributed solver over a row mesh
                  (KIND in {tsqr, lstsq, polar, svd, rsvd, eigh-rand})

Records keep the reference's keys.  ``steady_ms`` is the mean of
``--trials`` calls after one untimed call, by CUDA events on the card
(``time.perf_counter`` on the CPU).  ``compile_s`` is the first call's
seconds by the host clock around a synchronized call: on the card, the
kernels' build and load (there is no XLA compile), plus the first call's
own time.  ``compare`` times ``torch.linalg.qr`` on the same device
(``torch_q_plus_r_ms``, ``q_plus_r_speedup_vs_torch``).  Verification runs
in float64 on the result's device (``check_qr_device`` and the same
formulas as the reference's host checks), so a check at 8192^2 on the card
is no host product; on the CPU ``check_qr``.  Flags: ``--mixed`` is
MIXED_CONFIG's 3xTF32 trailing update, ``--no-pallas`` is
``use_kernels=False``, ``--stages`` is ``scan_stages`` and
``--stage-schedule`` (comma-separated panels per stage, the factor's
only; ``factor``/``tsqr``/``compare`` alone take it) is
``stage_schedule``: both set the panel groups, so Q's rounding.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def _config(args):
    from .utils.config import QRConfig
    extra = {}
    if getattr(args, "stages", None) is not None:
        extra["scan_stages"] = args.stages
    if getattr(args, "lookahead", None) is not None:
        extra["factor_lookahead"] = args.lookahead
    if getattr(args, "stage_schedule", None):
        extra["stage_schedule"] = tuple(int(x) for x in args.stage_schedule.split(","))
    if getattr(args, "mixed", False):
        extra["trailing_precision"] = "high"
    return QRConfig(dtype=DTYPES[args.dtype], use_kernels=not args.no_pallas,
                    tsqr_leaf=args.tsqr_leaf, device=args.platform, **extra)


def _emit(rec):
    print(json.dumps(rec), flush=True)


def _put(x, cfg) -> torch.Tensor:
    """Host data on the configured device, in the configured dtype."""
    return torch.as_tensor(np.asarray(x), device=cfg.device).to(cfg.dtype)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.detach().resolve_conj().to(torch.complex128 if x.is_complex() else torch.float64)


def _norm(x: torch.Tensor, ord=None) -> float:
    return float(torch.linalg.matrix_norm(x, ord) if ord is not None else torch.linalg.norm(x))


def _eye_defect(G: torch.Tensor) -> torch.Tensor:
    return G - torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)


def _check(A, Q, R):
    """The residual/orthogonality gates in float64 on Q's device."""
    from .utils.verify import check_qr, check_qr_device
    return check_qr_device(A, Q, R) if Q.is_cuda else check_qr(A, Q, R)


def _timing(r) -> dict:
    return {"steady_ms": round(r.steady_s * 1e3, 4), "compile_s": round(r.compile_s, 3)}


def _gates(chk) -> dict:
    return {"residual": chk.residual, "orthogonality": chk.orthogonality, "ok": chk.ok}


def _eps(args) -> float:
    return 1.2e-7 if args.dtype != "f64" else 2.3e-16


def cmd_factor(args):
    from .ops.blocked import extract_r, orgqr, qr_blocked
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.m, args.n)), cfg)
    r = bench(lambda a: qr_blocked(a, cfg), A, reps=args.trials, flops=qr_flops(args.m, args.n))
    rec = {"cmd": "factor", "m": args.m, "n": args.n, "dtype": args.dtype, **_timing(r),
           "gflops": round(r.gflops, 1)}
    if not args.no_verify:
        fac = qr_blocked(A, cfg)
        rec |= _gates(_check(A, orgqr(fac, args.m, args.n, cfg), extract_r(fac, args.n)))
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_tsqr(args):
    from .models.tsqr import tsqr
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.m, args.n)), cfg)
    r = bench(lambda a: tsqr(a, cfg), A, reps=args.trials, flops=qr_flops(args.m, args.n))
    rec = {"cmd": "tsqr", "m": args.m, "n": args.n, "dtype": args.dtype,
           "leaf": cfg.tsqr_leaf, **_timing(r), "gflops": round(r.gflops, 1)}
    if not args.no_verify:
        Q, R = tsqr(A, cfg)
        rec |= _gates(_check(A, Q, R))
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_lstsq(args):
    from .models.lstsq import lstsq
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.m, args.n)), cfg)
    B = _put(rng.standard_normal((args.m, args.k)), cfg)
    r = bench(lambda a, b: lstsq(a, b, cfg), A, B, reps=args.trials)
    x = _f64(lstsq(A, B, cfg).x)
    x_ref = torch.linalg.lstsq(_f64(A), _f64(B)).solution     # float64 LAPACK / cuSOLVER
    err = float((x - x_ref).abs().max() / max(1.0, float(x_ref.abs().max())))
    _emit({"cmd": "lstsq", "m": args.m, "n": args.n, "k": args.k, "dtype": args.dtype,
           **_timing(r), "rel_err_vs_lapack": err})
    return 0


def cmd_compare(args):
    from .ops.blocked import extract_r, orgqr, qr_blocked
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.m, args.n)), cfg)
    fl = qr_flops(args.m, args.n)
    ours = bench(lambda a: qr_blocked(a, cfg), A, reps=args.trials, flops=fl)

    # Like for like: torch.linalg.qr returns explicit (Q, R), so our side is
    # factor + orgqr.
    def qr_full(a):
        fac = qr_blocked(a, cfg)
        return orgqr(fac, args.m, args.n, cfg), extract_r(fac, args.n)

    ours_qr = bench(qr_full, A, reps=args.trials)
    lib_in = A if A.dtype != torch.bfloat16 else A.float()   # no bfloat16 geqrf
    lib = bench(torch.linalg.qr, lib_in, reps=args.trials, flops=fl)
    _emit({"cmd": "compare", "m": args.m, "n": args.n, "dtype": args.dtype,
           "ours_factor_ms": round(ours.steady_s * 1e3, 4),
           "ours_factor_gflops": round(ours.gflops, 1),
           "ours_q_plus_r_ms": round(ours_qr.steady_s * 1e3, 4),
           "torch_q_plus_r_ms": round(lib.steady_s * 1e3, 4),
           "q_plus_r_speedup_vs_torch": round(lib.steady_s / ours_qr.steady_s, 3)})
    return 0


def cmd_pivoted(args):
    from .models.qr import qr_pivoted
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = rng.standard_normal((args.m, args.n))
    if args.decay < 1.0:  # decaying spectrum: the rank-revealing use case
        U, _ = np.linalg.qr(rng.standard_normal((args.m, args.n)))
        V, _ = np.linalg.qr(rng.standard_normal((args.n, args.n)))
        A = (U * args.decay ** np.arange(args.n)) @ V.T
    Aj = _put(A, cfg)
    r = bench(lambda a: qr_pivoted(a, cfg, rank=args.rank), Aj, reps=args.trials,
              flops=qr_flops(args.m, args.n))
    rec = {"cmd": "pivoted", "m": args.m, "n": args.n, "dtype": args.dtype,
           "rank": args.rank, "decay": args.decay, **_timing(r), "gflops": round(r.gflops, 1)}
    if not args.no_verify:
        Q, R, piv = qr_pivoted(Aj, cfg, rank=args.rank)
        Qn, Rn = _f64(Q), _f64(R)
        A64 = torch.as_tensor(A, device=Q.device)
        resid = _norm(A64[:, piv] - Qn @ Rn) / _norm(A64)
        orth = float(_eye_defect(Qn.T @ Qn).abs().max())
        eps = float(torch.finfo(cfg.dtype).eps)
        ok = (resid < args.n * eps) if args.rank is None else (orth < 1e-4)
        rec |= {"residual": resid, "orthogonality": orth, "ok": bool(ok)}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_oracle(args):
    from .oracle import binding

    rng = np.random.default_rng(args.seed)
    A = rng.standard_normal((args.m, args.n))
    resid, orth = binding.factor_and_check(A, args.pr, args.pc)
    _emit({"cmd": "oracle", "m": args.m, "n": args.n, "pr": args.pr,
           "pc": args.pc, "residual": resid, "orthogonality": orth})
    return 0 if resid < 1e-12 * args.n else 2


def cmd_batched(args):
    from .models.batched import qr_batched
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.b, args.m, args.n)), cfg)
    r = bench(lambda a: qr_batched(a, cfg), A, reps=args.trials,
              flops=args.b * qr_flops(args.m, args.n))
    rec = {"cmd": "batched", "b": args.b, "m": args.m, "n": args.n,
           "dtype": args.dtype, **_timing(r), "gflops": round(r.gflops, 1)}
    if not args.no_verify:
        Q, R = qr_batched(A, cfg)
        Qn, Rn, An = _f64(Q), _f64(R), _f64(A)
        resid = _norm(Qn @ Rn - An) / max(_norm(An), 1.0)
        orth = float(torch.linalg.matrix_norm(_eye_defect(Qn.mT @ Qn)).max())
        eps = float(torch.finfo(cfg.dtype).eps)
        rec |= {"residual": resid, "orthogonality": orth,
                "ok": resid < args.n * eps and orth < 4 * args.n * eps}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_update(args):
    from .models.qr import qr
    from .models.update import qr_rank1_update
    from .utils.hostio import to_host
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = rng.standard_normal((args.m, args.n))
    Q, R = qr(_put(A, cfg), cfg)
    u = _put(rng.standard_normal(args.m), cfg)
    v = _put(rng.standard_normal(args.n), cfg)
    A1 = A + np.outer(to_host(u).astype(np.float64), to_host(v).astype(np.float64))
    r_up = bench(lambda q, rr: qr_rank1_update(q, rr, u, v), Q, R, reps=args.trials)
    r_ref = bench(lambda a: qr(a, cfg), _put(A1, cfg), reps=args.trials)
    rec = {"cmd": "update", "m": args.m, "n": args.n, "dtype": args.dtype,
           "update_ms": round(r_up.steady_s * 1e3, 4),
           "refactor_ms": round(r_ref.steady_s * 1e3, 4),
           "compile_s": round(r_up.compile_s, 3)}
    if not args.no_verify:
        Q1, R1 = qr_rank1_update(Q, R, u, v)
        chk = _check(torch.as_tensor(A1, device=Q1.device), Q1, R1)
        rec |= {"residual": chk.residual, "orthogonality": chk.orthogonality,
                "ok": chk.residual_ok and chk.orthogonality_ok}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_decomp(args):
    from .models import decomp
    from .utils.timing import bench, qr_flops

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    A = _put(rng.standard_normal((args.m, args.n)), cfg)
    fn = {"lq": decomp.lq, "rq": decomp.rq, "ql": decomp.ql}[args.kind]
    r = bench(lambda a: fn(a, cfg), A, reps=args.trials,
              flops=qr_flops(max(args.m, args.n), min(args.m, args.n)))
    rec = {"cmd": "decomp", "kind": args.kind, "m": args.m, "n": args.n,
           "dtype": args.dtype, **_timing(r), "gflops": round(r.gflops, 1)}
    if not args.no_verify:
        X, Y = (_f64(t) for t in fn(A, cfg))
        A64 = _f64(A)
        resid = _norm(X @ Y - A64) / _norm(A64)
        orthf = Y @ Y.T if args.kind in ("lq", "rq") else X.T @ X
        rec |= {"residual": resid, "orthogonality": _norm(_eye_defect(orthf)),
                "ok": resid < max(args.m, args.n) * 1.2e-7}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def _spectrum_matrix(rng, m: int, n: int, s: np.ndarray) -> np.ndarray:
    """(U * s) V^T with Haar U (m x k), V (n x k), k = len(s)."""
    k = len(s)
    U = np.linalg.qr(rng.standard_normal((m, k)))[0]
    V = np.linalg.qr(rng.standard_normal((n, k)))[0]
    return (U * s) @ V.T


def cmd_polar(args):
    from .models.polar import polar
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    # controllable conditioning, so the QDWH schedule is exercised honestly
    k = min(args.m, args.n)
    A = _put(_spectrum_matrix(rng, args.m, args.n, np.geomspace(1.0, 1.0 / max(args.cond, 1.0), k)),
             cfg)
    r = bench(lambda a: polar(a, config=cfg), A, reps=args.trials)
    rec = {"cmd": "polar", "m": args.m, "n": args.n, "cond": args.cond,
           "dtype": args.dtype, **_timing(r)}
    if not args.no_verify:
        Up, Hp = (_f64(t) for t in polar(A, config=cfg))
        A64 = _f64(A)
        UU = Up.T @ Up if args.m >= args.n else Up @ Up.T
        orth = _norm(_eye_defect(UU))
        resid = _norm(Up @ Hp - A64) / _norm(A64)
        rec |= {"residual": resid, "orthogonality": orth,
                "ok": resid < k * 1.2e-7 and orth < k * 1.2e-7}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_svd(args):
    from .models.polar import svd
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    k = min(args.m, args.n)
    s_true = np.geomspace(1.0, 1.0 / max(args.cond, 1.0), k)
    A = _put(_spectrum_matrix(rng, args.m, args.n, s_true), cfg)
    r = bench(lambda a: svd(a, config=cfg, eigh_impl=args.eigh_impl), A, reps=args.trials)
    rec = {"cmd": "svd", "m": args.m, "n": args.n, "cond": args.cond,
           "eigh_impl": args.eigh_impl, "dtype": args.dtype, **_timing(r)}
    if not args.no_verify:
        Us, ss, Vh = (_f64(t) for t in svd(A, config=cfg, eigh_impl=args.eigh_impl))
        A64 = _f64(A)
        resid = _norm((Us * ss) @ Vh - A64) / _norm(A64)
        orth = max(_norm(_eye_defect(Us.T @ Us)), _norm(_eye_defect(Vh @ Vh.T)))
        serr = float((ss - torch.as_tensor(s_true, device=ss.device)).abs().max() / s_true[0])
        eps = _eps(args)
        rec |= {"residual": resid, "orthogonality": orth, "sv_rel_err": serr,
                "ok": resid < k * eps and orth < 4 * k * eps}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_rsvd(args):
    from .models.rsvd import rsvd
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    if args.sym:
        return _cmd_eigh_rand(args, cfg, rng)
    # spectrum with a controllable decay, so the truncation error is meaningful
    r_full = min(args.m, args.n)
    s = args.decay ** np.arange(r_full)
    A = _put(_spectrum_matrix(rng, args.m, args.n, s), cfg)
    r = bench(lambda a: rsvd(a, args.rank, n_iter=args.iters, config=cfg), A, reps=args.trials)
    rec = {"cmd": "rsvd", "m": args.m, "n": args.n, "rank": args.rank,
           "dtype": args.dtype, **_timing(r)}
    if not args.no_verify:
        Uk, sk, Vtk = (_f64(t) for t in rsvd(A, args.rank, n_iter=args.iters, config=cfg))
        err = _norm((Uk * sk) @ Vtk - _f64(A), 2)
        tail = s[args.rank] if args.rank < r_full else 0.0
        rec |= {"err2": err, "s_next": float(tail),
                "ok": bool(err < 3 * tail + max(args.m, args.n) * 1e-6)}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def _cmd_eigh_rand(args, cfg, rng):
    """rsvd --sym: randomized Hermitian eigendecomposition benchmark on a
    symmetric matrix with an alternating-sign decaying spectrum."""
    from .models.rsvd import eigh_rand
    from .utils.timing import bench

    m = args.m
    # A rank-limited Haar basis: the tail check |w[rank]| needs only
    # r_full > rank eigenpairs, and a full m x m host QR would dominate.
    r_full = min(m, 4 * args.rank)
    V = np.linalg.qr(rng.standard_normal((m, r_full)))[0]
    w = args.decay ** np.arange(r_full) * np.where(np.arange(r_full) % 2, -1.0, 1.0)
    A = _put((V * w) @ V.T, cfg)
    r = bench(lambda a: eigh_rand(a, args.rank, n_iter=args.iters, config=cfg), A,
              reps=args.trials)
    rec = {"cmd": "eigh_rand", "m": m, "rank": args.rank, "dtype": args.dtype, **_timing(r)}
    if not args.no_verify:
        wk, Vk = (_f64(t) for t in eigh_rand(A, args.rank, n_iter=args.iters, config=cfg))
        err = _norm((Vk * wk) @ Vk.T - _f64(A), 2)
        tail = abs(w[args.rank]) if args.rank < r_full else 0.0
        rec |= {"err2": err, "w_next": float(tail), "ok": bool(err < 3 * tail + m * 1e-6)}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def cmd_eigh(args):
    from .models.eigh import eigh
    from .utils.timing import bench

    cfg = _config(args)
    rng = np.random.default_rng(args.seed)
    n = args.m
    # GOE-like symmetric matrix: dense spectrum, no pathological gaps
    G = rng.standard_normal((n, n))
    A = _put((G + G.T) / np.sqrt(2 * n), cfg)
    r = bench(lambda a: eigh(a, cfg, base_n=args.base_n), A, reps=args.trials)
    rec = {"cmd": "eigh", "n": n, "dtype": args.dtype, "base_n": args.base_n, **_timing(r)}
    if not args.no_verify:
        w, V = (_f64(t) for t in eigh(A, cfg, base_n=args.base_n))
        A64 = _f64(A)
        resid = _norm(A64 @ V - V * w[None, :]) / _norm(A64)
        orth = _norm(_eye_defect(V.T @ V))
        werr = float((torch.sort(w).values - torch.linalg.eigvalsh(A64)).abs().max()
                     / w.abs().max())
        eps = _eps(args)
        rec |= {"residual": resid, "orthogonality": orth, "eigval_rel_err": werr,
                # V is a depth-O(log n) product of QRCP bases and Jacobi
                # rotations: 4n*eps, the batched command's convention
                "ok": resid < n * eps and orth < 4 * n * eps}
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def _rank_rows(A: np.ndarray, mesh, cfg):
    """This rank's rows of the full host matrix A (torch's Shard(0) split),
    on its device in the configured dtype, as a row-sharded DTensor."""
    from .models.caqr import _chunk_rows
    from .parallel.collectives import coord
    from .parallel.mesh import as_row_sharded, mesh_device
    m = A.shape[0]
    rows = _chunk_rows(m, mesh.size(0))(coord(mesh))
    a = torch.as_tensor(A[rows], device=mesh_device(mesh)).to(cfg.dtype)
    return as_row_sharded(a, mesh, m)


def _gather(x, mesh) -> torch.Tensor:
    """A result on every rank, whole (a DTensor is gathered)."""
    from torch.distributed.tensor import DTensor

    from .parallel.collectives import gather_rows
    return gather_rows(x, mesh) if isinstance(x, DTensor) else x


def _full(x, mesh) -> torch.Tensor:
    return _f64(_gather(x, mesh))


def _caqr_rank(mesh, ns: dict):
    """Rank body of ``caqr``: every rank builds A from the seed on the host
    and factors its own rows; the record is the same on every rank."""
    from .models.caqr import caqr
    from .parallel.mesh import mesh_device
    from .utils.timing import bench

    args = argparse.Namespace(**ns)
    cfg = _config(args)
    dev = mesh_device(mesh)
    A = np.random.default_rng(args.seed).standard_normal((args.m, args.n))
    Ad = _rank_rows(A, mesh, cfg)
    r = bench(lambda a: caqr(a, mesh, cfg, layout=args.layout), Ad, reps=args.trials)
    rec = {"cmd": "caqr", "m": args.m, "n": args.n, "devices": mesh.size(0),
           "layout": args.layout, "dtype": args.dtype, **_timing(r)}
    if not args.no_verify:
        Q, R = caqr(Ad, mesh, cfg, layout=args.layout)
        rec |= _gates(_check(torch.as_tensor(A, device=dev), _gather(Q, mesh), R))
    return rec


def cmd_caqr(args):
    from .parallel.launch import run_ranks

    rec = run_ranks(args.devices, _caqr_rank, vars(args), device=args.platform)[0]
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


def _dist_rank(mesh, ns: dict):
    """Rank body of ``dist KIND``: every rank builds the input from the seed
    on the host, runs the ``*_dist`` solver on its own rows and checks the
    result with the reference's formulas in float64 on its device."""
    from .parallel.mesh import mesh_device
    from .utils.timing import bench

    args = argparse.Namespace(**ns)
    cfg = _config(args)
    dev = mesh_device(mesh)
    rng = np.random.default_rng(args.seed)
    kind, m, n = args.kind, args.m, args.n
    rec = {"cmd": f"{kind}_dist", "m": m, "n": n, "devices": mesh.size(0), "dtype": args.dtype}
    eps, k = _eps(args), min(m, n)

    def on_dev(x):       # a float64 host array on this rank's device
        return torch.as_tensor(x, device=dev)

    if kind == "tsqr":
        from .parallel.tsqr_dist import tsqr_dist
        A = rng.standard_normal((m, n))
        Ad = _rank_rows(A, mesh, cfg)
        r = bench(lambda a: tsqr_dist(a, mesh, cfg, strategy=args.strategy), Ad,
                  reps=args.trials)
        rec["strategy"] = args.strategy
        if not args.no_verify:
            Q, R = tsqr_dist(Ad, mesh, cfg, strategy=args.strategy)
            rec |= _gates(_check(on_dev(A), _gather(Q, mesh), R))
    elif kind == "lstsq":
        from .models.lstsq import lstsq_dist
        A = rng.standard_normal((m, n))
        b = rng.standard_normal((m,))
        Ad, bd = _rank_rows(A, mesh, cfg), _rank_rows(b, mesh, cfg)
        r = bench(lambda a: lstsq_dist(a, bd, mesh, cfg).x, Ad, reps=args.trials)
        if not args.no_verify:
            x = _f64(lstsq_dist(Ad, bd, mesh, cfg).x)
            x_ref = torch.linalg.lstsq(on_dev(A), on_dev(b)[:, None]).solution[:, 0]
            err = _norm(x - x_ref) / max(_norm(x_ref), 1e-30)
            # cond(A) ~ sqrt(m/n) here; the forward error amplifies eps by cond
            rec |= {"x_rel_err": err, "ok": err < 100 * n * eps}
    elif kind in ("polar", "svd"):
        from .models.polar import polar_dist, svd_dist
        s_true = np.geomspace(1.0, 1.0 / max(args.cond, 1.0), k)
        A64 = _spectrum_matrix(rng, m, n, s_true)
        Ad = _rank_rows(A64, mesh, cfg)
        A64 = on_dev(A64)
        rec["cond"] = args.cond
        if kind == "polar":
            r = bench(lambda a: polar_dist(a, mesh, config=cfg)[0], Ad, reps=args.trials)
            if not args.no_verify:
                Up, Hp = polar_dist(Ad, mesh, config=cfg)
                Up, Hp = _full(Up, mesh), _full(Hp, mesh)
                orth = _norm(_eye_defect(Up.T @ Up))
                resid = _norm(Up @ Hp - A64) / _norm(A64)
                rec |= {"residual": resid, "orthogonality": orth,
                        "ok": resid < k * eps and orth < k * eps}
        else:
            r = bench(lambda a: svd_dist(a, mesh, config=cfg, eigh_impl=args.eigh_impl)[0], Ad,
                      reps=args.trials)
            rec["eigh_impl"] = args.eigh_impl
            if not args.no_verify:
                Us, ss, Vh = (_full(t, mesh) for t in svd_dist(Ad, mesh, config=cfg,
                                                               eigh_impl=args.eigh_impl))
                resid = _norm((Us * ss) @ Vh - A64) / _norm(A64)
                orth = max(_norm(_eye_defect(Us.T @ Us)), _norm(_eye_defect(Vh @ Vh.T)))
                rec |= {"residual": resid, "orthogonality": orth,
                        "sv_rel_err": float((ss - on_dev(s_true)).abs().max() / s_true[0]),
                        "ok": resid < k * eps and orth < 4 * k * eps}
    elif kind == "rsvd":
        from .models.rsvd import rsvd_dist
        r_full = min(m, n, 4 * args.rank)
        s = args.decay ** np.arange(r_full)
        A64 = _spectrum_matrix(rng, m, n, s)
        Ad = _rank_rows(A64, mesh, cfg)
        rec["rank"] = args.rank
        r = bench(lambda a: rsvd_dist(a, args.rank, mesh, n_iter=args.iters, config=cfg)[0], Ad,
                  reps=args.trials)
        if not args.no_verify:
            Uk, sk, Vtk = (_full(t, mesh) for t in rsvd_dist(Ad, args.rank, mesh,
                                                             n_iter=args.iters, config=cfg))
            err = _norm((Uk * sk) @ Vtk - on_dev(A64), 2)
            tail = s[args.rank] if args.rank < r_full else 0.0
            rec |= {"err2": err, "s_next": float(tail),
                    "ok": bool(err < 3 * tail + max(m, n) * 1e-6)}
    else:  # eigh-rand
        from .models.rsvd import eigh_rand_dist
        r_full = min(m, 4 * args.rank)
        V = np.linalg.qr(rng.standard_normal((m, r_full)))[0]
        w = args.decay ** np.arange(r_full) * np.where(np.arange(r_full) % 2, -1.0, 1.0)
        A64 = (V * w) @ V.T
        Ad = _rank_rows(A64, mesh, cfg)
        rec["rank"] = args.rank
        r = bench(lambda a: eigh_rand_dist(a, args.rank, mesh, n_iter=args.iters, config=cfg)[1],
                  Ad, reps=args.trials)
        if not args.no_verify:
            wk, Vk = (_full(t, mesh) for t in eigh_rand_dist(Ad, args.rank, mesh,
                                                             n_iter=args.iters, config=cfg))
            err = _norm((Vk * wk) @ Vk.T - on_dev(A64), 2)
            tail = abs(w[args.rank]) if args.rank < r_full else 0.0
            rec |= {"err2": err, "w_next": float(tail), "ok": bool(err < 3 * tail + m * 1e-6)}
    return rec | _timing(r)


def cmd_dist(args):
    """Distributed-solver harness over a row mesh (``dist KIND m n``): the
    ``*_dist`` solver on ``--devices`` ranks, checked with the same float64
    formulas as the single-device commands."""
    from .parallel.launch import run_ranks

    n_dev = args.devices
    if args.m % n_dev:
        print(f"error: m={args.m} must divide the mesh ({n_dev} shards)", file=sys.stderr)
        return 2
    # tsqr/polar/svd run a shard-local thin QR of an (m/P x n) block, so
    # m/P >= n; the randomized kinds factor (m/P x rank+8) iterates
    # instead, and lstsq's augmented CAQR only needs m % P == 0.
    min_cols = {"tsqr": args.n, "polar": args.n, "svd": args.n,
                "rsvd": args.rank + 8, "eigh-rand": args.rank + 8,
                "lstsq": 0}[args.kind]
    if args.m // n_dev < min_cols:
        print(f"error: {args.kind} needs m/devices >= {min_cols}, got "
              f"{args.m}/{n_dev} = {args.m // n_dev}", file=sys.stderr)
        return 2
    rec = run_ranks(n_dev, _dist_rank, vars(args), device=args.platform)[0]
    _emit(rec)
    return 0 if rec.get("ok", True) else 2


COMMANDS = {"factor": cmd_factor, "tsqr": cmd_tsqr, "lstsq": cmd_lstsq,
            "compare": cmd_compare, "oracle": cmd_oracle, "caqr": cmd_caqr,
            "pivoted": cmd_pivoted, "batched": cmd_batched, "update": cmd_update,
            "decomp": cmd_decomp, "rsvd": cmd_rsvd, "polar": cmd_polar, "eigh": cmd_eigh,
            "svd": cmd_svd, "dist": cmd_dist}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_qr_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--platform", choices=["cpu", "cuda"], default="cuda",
                   help="where the port runs (QRConfig.device and the ranks' "
                        "device); the card by default")
    p.add_argument("--dtype", choices=list(DTYPES), default="f32")
    p.add_argument("--trials", type=int, default=3)  # qr.cu:25
    p.add_argument("--seed", type=int, default=12)   # qr.cu:765
    p.add_argument("--no-verify", action="store_true")
    p.add_argument("--no-pallas", action="store_true",
                   help="no kernel: the plain geqr2 panels (use_kernels=False)")
    p.add_argument("--mixed", action="store_true",
                   help="MIXED_CONFIG: the trailing-update GEMMs in 3xTF32 (three TF32 "
                        "passes on hi/lo-split operands), panels and orgqr in full "
                        "float32; the gates (resid < n*eps, orth < 4n*eps) stay on")
    p.add_argument("--tsqr-leaf", choices=["householder", "cholqr2"], default="householder")
    p.add_argument("--stages", type=int, default=None,
                   help="scan driver stages (QRConfig.scan_stages)")
    p.add_argument("--lookahead", type=int, default=None,
                   help="factor lookahead group width")
    p.add_argument("--stage-schedule", type=str, default=None,
                   help="comma-separated panels-per-stage (overrides --stages; must sum to "
                        "the panel count), e.g. 2,2,2,8 -- see QRConfig.stage_schedule. Only "
                        "applies to direct QR factorization subcommands "
                        "(factor/tsqr/compare): composite solvers run internal QRs whose "
                        "panel counts the schedule cannot match")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("factor", "tsqr", "compare"):
        sp = sub.add_parser(name)
        sp.add_argument("m", type=int)
        sp.add_argument("n", type=int)
    sp = sub.add_parser("lstsq")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("k", type=int, nargs="?", default=1)
    sp = sub.add_parser("oracle")
    for name in ("m", "n", "pr", "pc"):
        sp.add_argument(name, type=int)
    sp = sub.add_parser("caqr")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--devices", type=int, default=None,
                   help="ranks (default: the card count, 1 on the CPU)")
    sp.add_argument("--layout", choices=["block", "cyclic"], default="block")
    sp = sub.add_parser("pivoted")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--rank", type=int, default=None)
    sp.add_argument("--decay", type=float, default=1.0)
    sp = sub.add_parser("batched")
    for name in ("b", "m", "n"):
        sp.add_argument(name, type=int)
    sp = sub.add_parser("update")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp = sub.add_parser("decomp")
    sp.add_argument("kind", choices=["lq", "rq", "ql"])
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp = sub.add_parser("rsvd")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--rank", type=int, default=16)
    sp.add_argument("--iters", type=int, default=2)
    sp.add_argument("--decay", type=float, default=0.8)
    sp.add_argument("--sym", action="store_true",
                    help="square symmetric input: benchmark eigh_rand instead of rsvd "
                         "(n is ignored)")
    sp = sub.add_parser("polar")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--cond", type=float, default=100.0)
    sp = sub.add_parser("eigh")
    sp.add_argument("m", type=int)
    sp.add_argument("--base-n", type=int, default=128)
    sp = sub.add_parser("svd")
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--cond", type=float, default=100.0)
    sp.add_argument("--eigh-impl", choices=("torch", "qdwh"), default="torch")
    sp = sub.add_parser("dist")
    sp.add_argument("kind", choices=["tsqr", "lstsq", "polar", "svd", "rsvd", "eigh-rand"])
    sp.add_argument("m", type=int)
    sp.add_argument("n", type=int)
    sp.add_argument("--devices", type=int, default=None,
                    help="ranks (default: the card count, 1 on the CPU)")
    sp.add_argument("--strategy", choices=["allgather", "butterfly", "cholesky"],
                    default="allgather", help="tsqr combine strategy")
    sp.add_argument("--cond", type=float, default=100.0)
    sp.add_argument("--rank", type=int, default=16)
    sp.add_argument("--iters", type=int, default=2)
    sp.add_argument("--decay", type=float, default=0.8)
    sp.add_argument("--eigh-impl", choices=("torch", "qdwh"), default="torch",
                    help="Hermitian eigensolver of `dist svd` (torch = torch.linalg.eigh; "
                         "qdwh = the QDWH-eig divide and conquer)")
    return p


def main(argv=None):
    p = parser()
    args = p.parse_args(argv)
    if args.stage_schedule and args.cmd not in ("factor", "tsqr", "compare"):
        p.error("--stage-schedule only applies to the direct QR "
                "factorization subcommands (factor/tsqr/compare)")
    for dim in ("m", "n", "k", "pr", "pc", "b"):
        if getattr(args, dim, 1) < 1:
            p.error(f"{dim} must be >= 1, got {getattr(args, dim)}")
    if (args.cmd not in ("decomp", "rsvd", "polar")  # those take wide inputs
            and getattr(args, "n", 0) > getattr(args, "m", 0)):
        p.error(f"need n <= m, got m={args.m} n={args.n}")
    if getattr(args, "devices", 0) is None:
        args.devices = max(1, torch.cuda.device_count()) if args.platform == "cuda" else 1
    if getattr(args, "devices", 1) < 1:
        p.error(f"devices must be >= 1, got {args.devices}")
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
