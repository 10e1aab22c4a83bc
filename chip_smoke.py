#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of cuda_qr_tpu_torch/csrc from this checkout,
holds each kernel against its plain PyTorch version on the card, drives the
port's main path (8192^2 float32 ``qr`` at the default configuration, then
the geqrt panel path at 4096^2), checks the results against the residual and
orthogonality gates, and prints timings beside the card's name and power
limit.  Every phase raises on failure, so any failure exits non-zero; it
also fails on a machine without a CUDA device.

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
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms, qr_flops

    smi = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False   # HIGHEST: full float32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    chol = phase_chol(torch, np, dev)
    geqrt = phase_geqrt(torch, np, dev)

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
    say(f"timings on {smi}:")
    say(f"  factor {N_MAIN}^2 f32 highest: {t_fac:.2f} ms ({flops / t_fac / 1e6:.0f} GFLOP/s), "
        f"{syncs_fac} host syncs")
    say(f"  factor + orgqr highest: {t_qr:.2f} ms")
    say(f"  factor trailing-tf32 (MIXED): {t_mixed:.2f} ms; residual {chk_m.residual:.3e} "
        f"ok={chk_m.residual_ok}, orthogonality {chk_m.orthogonality:.3e} "
        f"ok={chk_m.orthogonality_ok}")
    say(f"  torch.linalg.qr (reduced, Q and R): {t_torch:.2f} ms")

    kernels = [
        {"name": "chol_inv", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/chol_inv.cu",
         "replaces": "cuda_qr_tpu/ops/pallas_chol.py:40",
         "launches": launches["chol_inv"], **chol},
        {"name": "geqrt", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/geqrt.cu",
         "replaces": "cuda_qr_tpu/ops/geqrt.py:38",
         "launches": launches["geqrt"], **geqrt},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
