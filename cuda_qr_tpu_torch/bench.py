"""Headline record: the MIXED blocked QR at 8192^2 float32 on one card.

    python -m cuda_qr_tpu_torch.bench [--device cuda|cpu] [--size 8192]

Counterpart of the repo's ``bench.py``, with its phases, configurations,
gates and record keys:

  1. MIXED headline: ``qr_blocked`` at ``scan_stages=16``,
     ``factor_lookahead=4``, trailing update "high" (3xTF32, the
     counterpart of Precision.HIGH) timed over 60 calls, then Q from
     ``orgqr`` at the HIGHEST configuration and R from ``extract_r``, gated
     on ||QR - A||_F/||A||_F < n eps and ||Q^T Q - I||_F < 4n eps
     (``verified_ok``);
  2. HIGHEST control: ``scan_stages=32``, ``factor_lookahead=4``, every
     GEMM in full float32, 30 calls;
  3. Q+R: the HIGHEST factor's time plus ``orgqr`` + ``extract_r``'s, then
     the same gates on the HIGHEST factors (``highest_ok``);
  4. the geqrt kernel: 512 x 256 on ``panel_method="geqrt"``,
     ``scan_stages=1``, gated on residual < 256 eps (``geqrt_kernel_ok``);
  5. bfloat16 end to end at min(size, 4096)^2 (``scan_stages=8``) and one
     float32 CholeskyQR refinement of Q (``ops/smalllinalg.cholesky_with_inv``):
     ``bf16_ok`` is refined orthogonality < 4n eps and refined residual
     < 8 * 2^-8, recorded and not gated, as in ``bench.py``.

The input is ``default_rng(12)`` float32 Gaussian; the 1024^2 draw of
``bench.py``'s first phase is still taken, so the geqrt and bfloat16 phases
factor ``bench.py``'s own inputs.  Times are ``utils.timing.bench``'s: the
first synchronized call by the host clock (``compile_s``: on a fresh
``build/`` the kernels' nvcc build), then the mean of the steady calls by
CUDA events, which take in the panel loop's host time.  The gates' norms
run on the result's device in float32 with TF32 off.  The record is
printed as one JSON line after every phase, so the last JSON line is the
most complete record; ``device`` is nvidia-smi's name and power limit of
the card.  Exit code 1 unless ``verified_ok``, ``highest_ok`` and
``geqrt_kernel_ok`` hold.

``--device cuda`` (the default) runs on the card; without one torch raises
its own error, and nothing falls back to the host.  ``--device cpu`` runs
the kernels' plain versions.  ``--size`` sets the headline's m = n.

Not ported, each a workaround of the TPU or its remote link: the 1024^2
insurance rung, the round-trip ("net") correction and its ``*_net_ms`` and
``rtt_ms`` keys, the soft deadline, the watchdog and the retry loop (a
retry would hide a kernel fault).  The geqrt phase's keys drop the TPU
compiler's name: ``geqrt_kernel_residual`` and ``geqrt_kernel_ok``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .ops.blocked import extract_r, orgqr, qr_blocked
from .ops.gemm import gemm
from .ops.smalllinalg import cholesky_with_inv
from .utils.config import QRConfig
from .utils.timing import bench, card_name, qr_flops

# MAGMA magma_sgeqrf2_gpu at 4096^2 float32 (the reference's timing.txt:23,
# BASELINE.md): the best vendor-library number the reference published.
BASELINE_GFLOPS = 299.0
HEADLINE_REPS = 60
REPS = 30
GEQRT_SHAPE = (512, 256)
BF16_MAX = 4096
INSURANCE_DRAW = 1024      # bench.py's first phase draws a 1024^2 input here


def residuals(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor):
    """(||QR - A||_F / ||A||_F, ||Q^T Q - I||_F) in float32, TF32 off."""
    resid = torch.linalg.norm(gemm(Q, R, "highest") - A) / torch.linalg.norm(A)
    G = gemm(Q.mT, Q, "highest")
    G.diagonal().sub_(1.0)
    return float(resid), float(torch.linalg.norm(G))


def sci(x: float) -> float:
    return float(f"{x:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cuda_qr_tpu_torch.bench",
                                 description="Headline record of the port's blocked QR.")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", type=int, default=8192,
                    help="m = n of the headline; the bfloat16 phase runs at min(size, 4096)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.empty(0, device=dev)       # no card: torch's own error, before any work
    record: dict = {"device": card_name() if dev.type == "cuda" else "cpu"}

    def emit():
        print(json.dumps(record), flush=True)

    m = n = args.size
    cfg = QRConfig(scan_stages=32, factor_lookahead=4, device=args.device)
    mcfg = QRConfig(scan_stages=16, factor_lookahead=4, trailing_precision="high",
                    device=args.device)
    rng = np.random.default_rng(12)
    A = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(dev)
    rng.standard_normal((INSURANCE_DRAW, INSURANCE_DRAW))
    eps = float(torch.finfo(torch.float32).eps)

    def q_and_r(fac):
        # orgqr at the HIGHEST configuration under both factors, as bench.py
        return orgqr(fac, m, n, cfg), extract_r(fac, n)

    # ---- phase 1: the MIXED headline and its gates
    r = bench(lambda a: qr_blocked(a, mcfg), A, reps=HEADLINE_REPS, flops=qr_flops(m, n))
    record.update({
        "metric": f"qr_gflops_{m}x{n}_fp32",
        "value": round(r.gflops, 1),
        "unit": "GFLOP/s",
        "vs_baseline": round(r.gflops / BASELINE_GFLOPS, 2),
        "precision_mode": "mixed_certified (panels full float32, trailing 3xTF32; "
                          "resid and orth gated below)",
        "steady_ms": round(r.steady_s * 1e3, 3),
        "reps": HEADLINE_REPS,
        "compile_s": round(r.compile_s, 3),
        "backend": dev.type,
    })
    emit()
    fac = qr_blocked(A, mcfg)
    resid, orth = residuals(A, *q_and_r(fac))
    del fac
    verified_ok = resid < n * eps and orth < 4 * n * eps
    record.update(residual=sci(resid), orthogonality=sci(orth), verified_ok=verified_ok)
    emit()

    # ---- phase 2: the HIGHEST control factor
    rh = bench(lambda a: qr_blocked(a, cfg), A, reps=REPS, flops=qr_flops(m, n))
    record.update(highest_ms=round(rh.steady_s * 1e3, 3), highest_gflops=round(rh.gflops, 1),
                  highest_compile_s=round(rh.compile_s, 3))
    emit()

    # ---- phase 3: Q + R as the sum of the factor's and orgqr + extract_r's times
    fach = qr_blocked(A, cfg)
    r_q = bench(q_and_r, fach, reps=REPS)
    record.update(q_plus_r_ms=round((rh.steady_s + r_q.steady_s) * 1e3, 3),
                  q_plus_r_form="factor+orgqr program sum (HIGHEST)",
                  q_plus_r_compile_s=round(r_q.compile_s, 3))
    emit()
    residh, orthh = residuals(A, *q_and_r(fach))
    del fach, A
    highest_ok = residh < n * eps and orthh < 4 * n * eps
    record.update(highest_residual=sci(residh), highest_orthogonality=sci(orthh),
                  highest_ok=highest_ok)
    emit()

    # ---- phase 4: the geqrt kernel on its own panel path
    gm, gn = GEQRT_SHAPE
    gcfg = QRConfig(panel_method="geqrt", scan_stages=1, device=args.device)
    Ag = torch.from_numpy(rng.standard_normal((gm, gn)).astype(np.float32)).to(dev)
    facg = qr_blocked(Ag, gcfg)
    geqrt_resid, _ = residuals(Ag, orgqr(facg, gm, gn, gcfg), extract_r(facg, gn))
    geqrt_ok = geqrt_resid < gn * eps
    record.update(geqrt_kernel_residual=sci(geqrt_resid), geqrt_kernel_ok=geqrt_ok)
    emit()
    del facg, Ag

    # ---- phase 5: bfloat16 end to end, then one float32 CholeskyQR refinement of Q
    nb16 = min(args.size, BF16_MAX)
    bcfg = QRConfig(dtype=torch.bfloat16, scan_stages=8, device=args.device)
    A32 = torch.from_numpy(rng.standard_normal((nb16, nb16)).astype(np.float32)).to(dev)
    Ab = A32.to(torch.bfloat16)
    rb = bench(lambda a: qr_blocked(a, bcfg), Ab, reps=REPS, flops=qr_flops(nb16, nb16))
    facb = qr_blocked(Ab, bcfg)
    Qb = orgqr(facb, nb16, nb16, bcfg).float()
    Rb = extract_r(facb, nb16).float()
    del facb, Ab
    _, Li = cholesky_with_inv(gemm(Qb.mT, Qb, "highest"), "highest")
    Qr = gemm(Qb, Li.mT, "highest")
    Rr = torch.triu(gemm(Qr.mT, A32, "highest"))
    raw_res, raw_orth = residuals(A32, Qb, Rb)
    ref_res, ref_orth = residuals(A32, Qr, Rr)
    del A32, Qb, Rb, Qr, Rr, Li
    record.update(bf16_e2e_ms=round(rb.steady_s * 1e3, 3),
                  bf16_e2e_gflops=round(rb.gflops, 1), bf16_e2e_size=nb16,
                  bf16_raw_residual=sci(raw_res), bf16_raw_orthogonality=sci(raw_orth),
                  bf16_refined_residual=sci(ref_res),
                  bf16_refined_orthogonality=sci(ref_orth),
                  bf16_ok=bool(ref_orth < 4 * nb16 * eps and ref_res < 8 * 2.0 ** -8))
    emit()
    return 0 if verified_ok and highest_ok and geqrt_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
