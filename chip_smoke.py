#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of cuda_qr_tpu_torch/csrc from this checkout,
holds each kernel against its plain PyTorch version on the card, drives the
port's paths (8192^2 float32 ``qr`` at the default configuration, the geqrt
panel path at 4096^2, the column-pivoted ``qr_pivoted`` at 8192^2, and the
rank-revealing solvers and ``lstsq`` at 8192 x 2048), checks the results
against the residual and orthogonality gates and known answers, and prints
timings beside the card's name and power limit.  Every phase raises on
failure, so any failure exits non-zero; it also fails on a machine without
a CUDA device.

The second-to-last line is a JSON object of the kernels (launch counts from
the main-path run, errors against the plain versions, times); the last line
is {"ok": true, "device": {...}}.  Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_MAIN = 8192
N_GEQRT = 4096
N_RANK = (8192, 2048, 1536)   # BASELINE config 4's shape; rank of the solver phase
RANK_TRUNC = 1024
# (l, cand, nb, seed): the default block step's tile, and the gate's extremes
SELECT_TILES = ((160, 512, 128, 5), (64, 128, 32, 1), (288, 1024, 256, 0))
MIN_GAP = 1e-5  # "well separated": float32 rounding moves a downdated norm ~1e-7
TOL32 = 1e-4    # kernel vs plain, float32: other summation order; L^-1 x cond(G)
TOL64 = 1e-10


def say(*parts) -> None:
    print(*parts, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_device(torch):
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build():
    from cuda_qr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.load()._name
    say(f"build: nvcc {_build.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s -> "
        f"{Path(path).relative_to(HERE)}")


def phase_chol(torch, np, dev):
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.smalllinalg import cholesky_with_inv
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    rng = np.random.default_rng(1)

    def spd(n, dtype, batch=()):
        B = rng.standard_normal(batch + (n, n))
        G = B @ np.swapaxes(B, -1, -2) + n * np.eye(n)
        return torch.from_numpy(G).to(dev, dtype)

    out = {}
    for dtype, tol, nbs in ((torch.float32, TOL32, (16, 128, 256, 512)),
                            (torch.float64, TOL64, (128,))):
        for nb in nbs:
            G = spd(nb, dtype)
            L, Li = chol_with_inv_kernel(G)
            Lp, Lip = cholesky_with_inv(G)
            torch.cuda.synchronize()
            eye = torch.eye(nb, dtype=torch.float64, device=dev)
            inv_res = float((L.double() @ Li.double() - eye).abs().max())
            eL, eLi = rel_err(L, Lp), rel_err(Li, Lip)
            say(f"chol_inv {str(dtype)[6:]} nb={nb}: rel err L {eL:.2e}, L^-1 {eLi:.2e}; "
                f"|L L^-1 - I| {inv_res:.2e} (tol {tol:g})")
            if not (eL < tol and eLi < tol and inv_res < tol):
                raise AssertionError(f"chol_inv disagrees with its plain version at nb={nb}")
            if dtype == torch.float32 and nb == 128:
                out["max_abs_err"] = max(abs_err(L, Lp), abs_err(Li, Lip))
                out["ms"] = cuda_time_ms(lambda: chol_with_inv_kernel(G), reps=50)
                out["plain_ms"] = cuda_time_ms(lambda: cholesky_with_inv(G), reps=10)
    Gs = spd(128, torch.float32, (3,))
    L, Li = chol_with_inv_kernel(Gs)
    for b in range(3):
        Lp, Lip = cholesky_with_inv(Gs[b])
        if not (rel_err(L[b], Lp) < TOL32 and rel_err(Li[b], Lip) < TOL32):
            raise AssertionError(f"chol_inv stack disagrees at matrix {b}")
    L, _ = chol_with_inv_kernel(-torch.eye(32, device=dev))
    if torch.isfinite(L).all():
        raise AssertionError("chol_inv: non-PD input gave finite output")
    say(f"chol_inv: stack of 3 ok, non-PD -> non-finite ok; nb=128 f32 kernel "
        f"{out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms")
    return out


def phase_geqrt(torch, np, dev):
    from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_base_plain
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    rng = np.random.default_rng(2)
    out = {}
    cases = [(torch.float32, TOL32, 256, 32, 0, False),
             (torch.float32, TOL32, 8192, 32, 0, False),
             (torch.float32, TOL32, 8192, 32, 40, False),
             (torch.float32, TOL32, 256, 32, 0, True),
             (torch.float32, TOL32, 1024, 128, 16, False),
             (torch.float64, TOL64, 8192, 32, 40, False)]
    for dtype, tol, m, w, off, zero in cases:
        P = rng.standard_normal((m, w))
        if zero:
            P[:, 0] = 0.0
            P[:, 5] = 0.0
        P = torch.from_numpy(P).to(dev, dtype)
        pk, tau, T = geqrt_base(P, off)
        pp, taup, Tp = geqrt_base_plain(P, off)
        torch.cuda.synchronize()
        errs = (rel_err(pk, pp), rel_err(tau, taup), rel_err(T, Tp))
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(T).all())
        say(f"geqrt {str(dtype)[6:]} m={m} w={w} off={off}{' zero cols' if zero else ''}: "
            f"rel err packed {errs[0]:.2e}, tau {errs[1]:.2e}, T {errs[2]:.2e} (tol {tol:g})")
        if not (finite and max(errs) < tol and torch.equal(pk[:off], P[:off])):
            raise AssertionError(f"geqrt disagrees with its plain version at {(m, w, off)}")
        if dtype == torch.float32 and (m, w, off) == (8192, 32, 0):
            out["max_abs_err"] = max(abs_err(pk, pp), abs_err(tau, taup), abs_err(T, Tp))
            out["ms"] = cuda_time_ms(lambda: geqrt_base(P, 0), reps=20)
            out["plain_ms"] = cuda_time_ms(lambda: geqrt_base_plain(P, 0), reps=5)
    say(f"geqrt: 8192x32 f32 kernel {out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms")
    return out


def phase_select(torch, np, dev):
    from cuda_qr_tpu_torch.ops.select_kernel import (select_pivots_kernel, select_pivots_plain,
                                                     selection_margin)
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    out = {"max_abs_err": 0}
    for l, cand, nb, seed in SELECT_TILES:
        S = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (l, cand), dtype=np.float32)).to(dev)
        norms = (S.double() ** 2).sum(0).float()
        tiles = [("gaussian", S, norms)]
        if (l, cand, nb) == SELECT_TILES[0][:3]:
            T = S.clone()
            T[:, [40, 300]] = T[:, [7, 7]]          # duplicates of column 7
            T[:, [3, 200, 511]] = 0                 # zero columns
            tn = (T.double() ** 2).sum(0).float()
            inactive = tn.clone()
            inactive[::3] = -1                      # ineligible columns
            tiles += [("duplicate+zero", T, tn), ("inactive", T, inactive)]
        for name, T, tn in tiles:
            gap = selection_margin(T, tn, nb)
            T0 = T.clone()
            got = select_pivots_kernel(T, tn, nb)
            want = select_pivots_plain(T, tn, nb)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            picks = torch.sort(got[got >= 0]).values
            say(f"select_pivots l={l} cand={cand} nb={nb} {name}: min gap {gap:.2e} "
                f"(>= {MIN_GAP:g}), ord identical {same}")
            if gap < MIN_GAP:
                raise AssertionError(f"select tile {name} {(l, cand, nb)} is not well separated")
            if not (same and torch.equal(T, T0) and torch.equal(
                    picks, torch.arange(nb, dtype=torch.int32, device=dev))):
                raise AssertionError(f"select_pivots disagrees with its plain version "
                                     f"at {(l, cand, nb)} on the {name} tile")
            if name == "inactive" and not bool((got[::3] == -1).all()):
                raise AssertionError("select_pivots picked an ineligible column")
            out["max_abs_err"] = max(out["max_abs_err"], int((got - want).abs().max()))
        if (l, cand, nb) == SELECT_TILES[0][:3]:
            out["ms"] = cuda_time_ms(lambda: select_pivots_kernel(S, norms, nb), reps=20)
            out["plain_ms"] = cuda_time_ms(lambda: select_pivots_plain(S, norms, nb), reps=3)
    say(f"select_pivots: 160x512 nb=128 kernel {out['ms']:.4f} ms vs plain "
        f"{out['plain_ms']:.4f} ms")
    return out


def phase_rank(torch, np, ct, cfg, dev):
    """Rank-revealing solvers on an exactly rank-r 8192 x 2048 A = B C, and
    full-rank lstsq on a Gaussian of the same shape."""
    m, n, r = N_RANK
    rng = np.random.default_rng(4)
    B = torch.from_numpy(rng.standard_normal((m, r))).to(dev)
    C = torch.from_numpy(rng.standard_normal((r, n))).to(dev)
    b = torch.from_numpy(rng.standard_normal(m)).to(dev)
    A = (B @ C).float()
    eps = float(torch.finfo(torch.float32).eps)
    t0 = time.perf_counter()
    rank = ct.matrix_rank(A, config=cfg)
    t_rank = time.perf_counter() - t0
    say(f"matrix_rank {m}x{n} (rank {r} by construction): {rank}, {t_rank:.3f} s")
    if rank != r:
        raise AssertionError(f"matrix_rank gave {rank}, expected {r}")
    t0 = time.perf_counter()
    x, resid, rk, _ = ct.lstsq_rr(A, b.float(), config=cfg)
    torch.cuda.synchronize()
    t_rr = time.perf_counter() - t0
    # Minimum-norm solution from the known factors, float64 on the card:
    # x = C^T (C C^T)^{-1} (B^T B)^{-1} B^T b.
    y = torch.linalg.solve(B.T @ B, B.T @ b)
    x_mn = C.T @ torch.linalg.solve(C @ C.T, y)
    err = float((x.double() - x_mn).norm() / x_mn.norm())
    # float32 COD of a matrix with cond ~35 (Gaussian factors): expect
    # ~cond * sqrt(n) * eps ~ 2e-4; the gate allows 5x that.
    say(f"lstsq_rr: rank {rk}, rel err vs min-norm float64 {err:.3e} (< 1e-3), "
        f"residual {float(resid):.4e}, {t_rr:.3f} s")
    if not (rk == r and err < 1e-3):
        raise AssertionError("lstsq_rr does not give the minimum-norm solution")
    N = ct.null_space(A, config=cfg).double()
    G = N.T @ N
    G.diagonal().sub_(1.0)
    orth = float(G.norm())
    an = float((A.double() @ N).norm() / A.double().norm())
    say(f"null_space: {tuple(N.shape)}, ||N^T N - I|| {orth:.3e} (< {4 * n * eps:.3e}), "
        f"||A N||/||A|| {an:.3e} (< {n * eps:.3e})")
    if not (N.shape == (n, n - r) and orth < 4 * n * eps and an < n * eps):
        raise AssertionError("null_space fails its gates")
    del B, C, A, N
    Af = torch.from_numpy(rng.standard_normal((m, n), dtype=np.float32)).to(dev)
    bf = torch.from_numpy(rng.standard_normal(m, dtype=np.float32)).to(dev)
    t0 = time.perf_counter()
    res = ct.lstsq(Af, bf, cfg)
    torch.cuda.synchronize()
    t_ls = time.perf_counter() - t0
    want = torch.linalg.lstsq(Af.double(), bf.double()[:, None]).solution[:, 0]
    rres = float((Af.double() @ want - bf.double()).norm())
    ex = float((res.x.double() - want).norm() / want.norm())
    er = abs(float(res.residual_norm) - rres) / rres
    say(f"lstsq full rank {m}x{n}: rel err x {ex:.3e}, residual {er:.3e} vs torch.linalg.lstsq "
        f"float64 (< 1e-4), {t_ls:.3f} s")
    if not (ex < 1e-4 and er < 1e-4):
        raise AssertionError("lstsq disagrees with torch.linalg.lstsq in float64")


def gate(name, chk) -> None:
    say(f"{name}: residual {chk.residual:.3e} (< {chk.n * chk.eps:.3e}), "
        f"orthogonality {chk.orthogonality:.3e} (< {4 * chk.n * chk.eps:.3e}), "
        f"tril(R) {chk.r_triangular:g}")
    if not chk.ok:
        raise AssertionError(f"{name} fails the residual/orthogonality gates")


def main() -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    import cuda_qr_tpu_torch as ct
    if Path(ct.__file__).resolve().parent != HERE / "cuda_qr_tpu_torch":
        raise RuntimeError(f"cuda_qr_tpu_torch imported from {ct.__file__}, "
                           f"not from this checkout")
    from cuda_qr_tpu_torch.ops import smalllinalg
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.geqrt import geqrt_base
    from cuda_qr_tpu_torch.ops.qrcp import qrcp_blocked
    from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms, qr_flops

    smi = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # HIGHEST: full float32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    chol = phase_chol(torch, np, dev)
    geqrt = phase_geqrt(torch, np, dev)
    select = phase_select(torch, np, dev)

    # ---- main path: 8192^2 float32 qr at DEFAULT_CONFIG, then geqrt 4096^2
    cfg = ct.DEFAULT_CONFIG.replace(device="cuda")
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_MAIN, N_MAIN), dtype=np.float32)).to(dev)
    A4 = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (N_GEQRT, N_GEQRT), dtype=np.float32)).to(dev)
    gcfg = cfg.replace(panel_method="geqrt")
    torch.cuda.synchronize()
    chol_with_inv_kernel.launches = 0
    geqrt_base.launches = 0
    smalllinalg.host_syncs = 0
    t0 = time.perf_counter()
    Q, R = ct.qr(A, cfg)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    chol_main, syncs_main = chol_with_inv_kernel.launches, smalllinalg.host_syncs
    t0 = time.perf_counter()
    fac4 = ct.qr_blocked(A4, gcfg)
    Q4, R4 = ct.orgqr(fac4, N_GEQRT, N_GEQRT, gcfg), ct.extract_r(fac4, N_GEQRT)
    torch.cuda.synchronize()
    t_geqrt = time.perf_counter() - t0
    launches = {"chol_inv": chol_with_inv_kernel.launches,
                "geqrt": geqrt_base.launches}
    say(f"main path: qr {N_MAIN}^2 f32 {cfg.panel_method} nb={cfg.panel_width} "
        f"lookahead={cfg.factor_lookahead}: {t_main:.3f} s first call, "
        f"chol_inv launches {chol_main}, host syncs {syncs_main}")
    gate(f"qr {N_MAIN}^2 f32", ct.check_qr_device(A, Q, R))
    if chol_main < N_MAIN // cfg.panel_width:
        raise AssertionError(f"chol_inv launched {chol_main} times, expected >= "
                             f"{N_MAIN // cfg.panel_width} (one per panel)")
    say(f"geqrt path: qr_blocked+orgqr {N_GEQRT}^2 f32: {t_geqrt:.3f} s first call, "
        f"geqrt launches {launches['geqrt']}")
    gate(f"geqrt {N_GEQRT}^2 f32", ct.check_qr_device(A4, Q4, R4))
    if launches["geqrt"] == 0:
        raise AssertionError("geqrt path launched no geqrt kernel")
    del Q, R, Q4, R4, fac4, A4

    # ---- QRCP path: 8192^2 float32 qr_pivoted at DEFAULT_CONFIG
    torch.cuda.synchronize()
    chol_with_inv_kernel.launches = 0
    geqrt_base.launches = 0
    select_pivots_kernel.launches = 0
    smalllinalg.host_syncs = 0
    t0 = time.perf_counter()
    Qp, Rp, piv = ct.qr_pivoted(A, cfg)
    torch.cuda.synchronize()
    t_piv = time.perf_counter() - t0
    launches["select_pivots"] = select_pivots_kernel.launches
    chol_piv, syncs_piv = chol_with_inv_kernel.launches, smalllinalg.host_syncs
    panels = N_MAIN // cfg.panel_width
    say(f"QRCP path: qr_pivoted {N_MAIN}^2 f32: {t_piv:.3f} s first call, select_pivots "
        f"launches {launches['select_pivots']}, chol_inv launches {chol_piv}, "
        f"host syncs {syncs_piv}")
    if not torch.equal(torch.sort(piv).values, torch.arange(N_MAIN, device=dev)):
        raise AssertionError("qr_pivoted: piv is not a permutation")
    gate(f"qr_pivoted {N_MAIN}^2 f32", ct.check_qr_device(A[:, piv], Qp, Rp))
    if launches["select_pivots"] < panels or chol_piv < panels:
        raise AssertionError(f"qr_pivoted launched select_pivots {launches['select_pivots']} "
                             f"and chol_inv {chol_piv} times, expected >= {panels} each")
    del Qp, Rp
    Qt, Rt, pt = ct.qr_pivoted(A, cfg, rank=RANK_TRUNC)
    if Qt.shape != (N_MAIN, RANK_TRUNC) or Rt.shape != (RANK_TRUNC, N_MAIN):
        raise AssertionError(f"qr_pivoted rank={RANK_TRUNC}: shapes {Qt.shape}, {Rt.shape}")
    # The factored columns are exact: A[:, pt[:k]] = Q R11, and R12 = Q^T A[:, pt[k:]].
    gate(f"qr_pivoted rank={RANK_TRUNC} factored columns",
         ct.check_qr_device(A[:, pt[:RANK_TRUNC]], Qt, Rt[:, :RANK_TRUNC]))
    A2 = A[:, pt[RANK_TRUNC:]].double()
    r12 = float((Qt.double().T @ A2 - Rt[:, RANK_TRUNC:].double()).norm() / A2.norm())
    r12_tol = N_MAIN * float(torch.finfo(torch.float32).eps)
    say(f"qr_pivoted rank={RANK_TRUNC}: ||Q^T A2 - R12|| / ||A2|| {r12:.3e} (< {r12_tol:.3e})")
    if not r12 < r12_tol:
        raise AssertionError("qr_pivoted truncated: R12 is not Q^T A2")
    del Qt, Rt, A2
    phase_rank(torch, np, ct, cfg, dev)

    # ---- timings (informational)
    flops = qr_flops(N_MAIN, N_MAIN)
    t_fac = cuda_time_ms(lambda: ct.qr_blocked(A, cfg), reps=3, warmup=1)
    smalllinalg.host_syncs = 0
    ct.qr_blocked(A, cfg)
    syncs_fac = smalllinalg.host_syncs

    def factor_and_q():
        f = ct.qr_blocked(A, cfg)
        return ct.orgqr(f, N_MAIN, N_MAIN, cfg), ct.extract_r(f, N_MAIN)

    t_qr = cuda_time_ms(factor_and_q, reps=3, warmup=1)
    mixed = ct.MIXED_CONFIG.replace(device="cuda")
    t_mixed = cuda_time_ms(lambda: ct.qr_blocked(A, mixed), reps=3, warmup=1)
    fm = ct.qr_blocked(A, mixed)
    chk_m = ct.check_qr_device(A, ct.orgqr(fm, N_MAIN, N_MAIN, mixed),
                               ct.extract_r(fm, N_MAIN))
    del fm
    t_torch = cuda_time_ms(lambda: torch.linalg.qr(A), reps=3, warmup=1)
    t_qrcp = cuda_time_ms(lambda: qrcp_blocked(A, cfg), reps=3, warmup=1)
    smalllinalg.host_syncs = 0
    qrcp_blocked(A, cfg)
    syncs_qrcp = smalllinalg.host_syncs
    say(f"timings on {smi}:")
    say(f"  factor {N_MAIN}^2 f32 highest: {t_fac:.2f} ms ({flops / t_fac / 1e6:.0f} GFLOP/s), "
        f"{syncs_fac} host syncs")
    say(f"  factor + orgqr highest: {t_qr:.2f} ms")
    say(f"  factor trailing-tf32 (MIXED): {t_mixed:.2f} ms; residual {chk_m.residual:.3e} "
        f"ok={chk_m.residual_ok}, orthogonality {chk_m.orthogonality:.3e} "
        f"ok={chk_m.orthogonality_ok}")
    say(f"  torch.linalg.qr (reduced, Q and R): {t_torch:.2f} ms")
    say(f"  pivoted factor qrcp_blocked {N_MAIN}^2 f32 highest: {t_qrcp:.2f} ms, "
        f"{syncs_qrcp} host syncs (unpivoted factor above: {t_fac:.2f} ms)")

    kernels = [
        {"name": "chol_inv", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/chol_inv.cu",
         "replaces": "cuda_qr_tpu/ops/pallas_chol.py:40",
         "launches": launches["chol_inv"], **chol},
        {"name": "geqrt", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/geqrt.cu",
         "replaces": "cuda_qr_tpu/ops/geqrt.py:38",
         "launches": launches["geqrt"], **geqrt},
        {"name": "select_pivots", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/select_pivots.cu",
         "replaces": "cuda_qr_tpu/ops/pallas_select.py:40",
         "launches": launches["select_pivots"], **select},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
