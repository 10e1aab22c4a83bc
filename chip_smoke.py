#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--only rotation_bias,eigh,orgqr_groups,update,factor,mixed,bench,
                                  stages,precision,slogdet,newton,geqrt_pair]

Builds the CUDA kernels of cuda_qr_tpu_torch/csrc from this checkout,
holds each kernel against its plain PyTorch version on the card (the geqrt
kernel's batch grid with its blocked body for TSQR leaves and its
triangle-pair body for TSQR tree nodes, and
the chol_inv kernel's stack included), drives the
port's paths (8192^2 float32 ``qr`` at the default configuration, the geqrt
panel path at 4096^2, the column-pivoted ``qr_pivoted`` at 8192^2, the
rank-revealing solvers and ``lstsq`` at 8192 x 2048, ``slogdet``'s sign at
4096^2 on 8 seeds beside the reference's rule, ``tsqr``/``tsqr_r`` at
1,048,576 x 128 with both leaves and an ill-conditioned input that takes
the fallback, ``qr_batched`` on 8192 x 256 x 64, lq/rq/ql and
``qr_multiply`` in float64, the QR updates on an 8192 x 1024 thin QR,
orgqr's panel groups (the reference's stages) at 512^2 and 1024^2 on both
kernels' panels, the reference's panel-grouping ladder at 8192^2 (its
stage counts, tuned stage schedules and unrolled driver, each timed and
gated, and ``--stage-schedule`` on the command line), MIXED_CONFIG's 3xTF32 trailing update (its GEMMs against
float64 beside "highest" and one TF32 pass, the factor's residual and
orthogonality at 2,048^2-16,384^2 against DEFAULT_CONFIG's, and the
command line's ``--mixed``), every GEMM's precision as an argument (``qr``
at 1,024^2 under each of five ways a caller leaves PyTorch's float32 GEMM
mode set, each in a child process, ``python3 chip_smoke.py --caller-state
NAME``; the 8,192^2 factor + Q with every GEMM at ``precision="high"`` on
both kernels' panels beside "highest" and "tf32" panels, ``qr_pivoted``
and ``tsqr`` at "high"), and the spectral family: ``rsvd`` at 65,536 x 4,096 and ``eigh_rand`` at 8,192^2
on known spectra, ``norm2_est``/``cond_est``, ``orth(rcond=...)``, QDWH
``polar`` at 16,384 x 512 and 1,048,576 x 128, ``svd`` at 4,096^2 with both
eigensolvers, the Jacobi rotation's c^2 + s^2 - 1 over 10^6 angles a scale
(no one-sided bias; the Givens rotation's beside it), and ``eigh`` at
2,048^2 plus a clustered spectrum and ``eigh_batched`` on 4,096 x 64 x 64; then the distributed path on 4 ranks,
sharing the card over gloo when there is one card: ``tsqr_dist`` at
1,048,576 x 128 with every strategy, ``caqr`` at 16,384^2, the CAQR variants,
``caqr_ormqr`` and a crash-and-resume at 8,192^2, ``lstsq_dist``,
``polar_dist``/``svd_dist``, ``rsvd_dist`` and ``eigh_rand_dist``, a complex64
``caqr`` on the allgather combine, the complex64 ``lstsq_dist``,
``polar_dist``/``svd_dist``, ``rsvd_dist`` and ``eigh_rand_dist``, each also
against the single-device function on the same input, and ``caqr`` on one
rank over NCCL), the command line (``cli.main`` in process for every
command, at full width for factor, compare, tsqr, pivoted, lstsq, batched
and the oracle, then one ``python -m cuda_qr_tpu_torch``), the headline
record (``python -m cuda_qr_tpu_torch.bench`` in a process of its own, its
four gates held), complex QR
(complex64/128 ``qr`` in every mode and at MIXED_CONFIG, ``lstsq``, ``lq``,
``tsqr``/``tsqr_r``) and the rest of complex input (``qr_pivoted`` at
8,192^2, the rank solvers, the six Givens updates, ``rsvd``/``orth``,
``eigh_rand``, ``norm2_est``/``cond_est``, ``polar`` in complex64 and
complex128, ``svd``, ``eigh``, ``eigh_batched``), every complex call with no
kernel launch,
checks the results against the residual and orthogonality gates and known
answers, and prints timings beside the card's name and power limit.  The
main path factors a numpy array with no config: the entry points place it
on the card by default.  Each kernel is timed beside its bound (the larger
of its float32 operations over the FP32 peak and its bytes over HBM's rate)
and, where one exists, the PyTorch call that computes the same function
(``library_ms``; a yardstick only, the port never calls it); the geqrt
lines say which kernel body (shared-memory sub-panels or L2 streaming) each
shape took.  The pivot selection (B3, a thread block cluster) is checked
on ties, a tie across the cluster's CTAs and a NaN, and timed on every tile
shape.  The Newton-Schulz inverse with its certificate (B4, a cluster too)
is held to its plain twin on live panels' M at nb 32, 64 and 128 and on a
NaN, and timed on the M of every panel of the 8192^2 factor beside the plain
chain and torch.linalg.inv.  Every phase raises on
failure, so any failure exits non-zero; it also fails on a machine without
a CUDA device.

The second-to-last line is a JSON object of the kernels (launch counts from
the main-path run, errors against the plain versions, times); the last line
is {"ok": true, "device": {...}}.  Imports neither JAX nor the JAX package.
``--only`` runs just the named phases (of ``STANDALONE``: the rotation's
bias, the eigh phase, the panel groups of orgqr, the QR updates, the main
factor alone, MIXED_CONFIG's phase, the headline record, the grouping
ladder, the precision phase, slogdet, B4 on its own, B2's batch grid with
its triangle-pair body) and ends with
the same last line, "only" added.  Run from another checkout's root, a
copy of this script with ``--only factor`` times that checkout's factor.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_MAIN = 8192
N_GEQRT = 4096
N_RANK = (8192, 2048, 1536)   # BASELINE config 4's shape; rank of the solver phase
RANK_TRUNC = 1024
N_SLOGDET = (4096, 8)         # n, seeds 0..7: slogdet's sign at DEFAULT_CONFIG (fault C12)
# (l, cand, nb, seed): the default block step's tile, and the gate's extremes
SELECT_TILES = ((160, 512, 128, 5), (64, 128, 32, 1), (288, 1024, 256, 0))
MIN_GAP = 1e-5  # "well separated": float32 rounding moves a downdated norm ~1e-7
TOL32 = 1e-4    # kernel vs plain, float32: other summation order; L^-1 x cond(G)
TOL64 = 1e-10
# A distributed result vs the single-device function on the same input:
# 20x the largest gap read on an H100 80GB HBM3 at 700 W (caqr 32768^2's R,
# 4.99e-06), well under what a TF32 product or a missing CholeskyQR2 round
# would leave
DIST_TOL = 1e-4
FP32_PEAK = 67e12   # FLOP/s, H100 SXM float32 outside the tensor cores (NVIDIA data sheet)
HBM_PEAK = 3.35e12  # bytes/s, H100 SXM HBM3
# geqrt batch grid (L, m, w, off, float64?, zero panels): the TSQR leaf shape
# at 1M x 128 (first), a tree-node-like stack, an odd width with an offset,
# zero panels, and the rsvd path's own stacks at k + p = 72: its leaves
# (65,536 rows in blocks of 1,024) and a level of its tree
GEQRT_BATCHED = ((1024, 1024, 128, 0, False, False), (64, 256, 128, 0, False, False),
                 (8, 2048, 77, 3, True, False), (16, 512, 64, 0, False, True),
                 (64, 1024, 72, 0, False, False), (32, 144, 72, 0, False, False))
# B2's triangle-pair body (a TSQR tree node [R_i; R_j]): (L, w, float64?)
# against the plain version, the 1M x 128 tree's first level first; then
# one node and that level timed beside the dense body and torch.geqrf
GEQRT_PAIR = ((512, 128, False), (512, 128, True), (3, 77, False), (64, 72, False),
              (3, 32, True), (5, 1, False))
CHOL_STACK = (4096, 64)
# B4 against its plain twin: M of live panels of these rows at these widths
NEWTON_ROWS = (8192, 2048, 512, 160, 128)
NEWTON_NBS = (32, 64, 128)
NEWTON_TOL = 1e-5   # N where the certificate passes: converged, so rounding only
N_TSQR = (1 << 20, 128)          # BASELINE config 3
N_TSQR_ILL = (65536, 128, 7)     # cond 1e7: the cholqr2 path must fall back
N_BATCHED = (8192, 256, 64)
N_DECOMP = (8192, 2048, 64)      # tall shape; lq takes its transpose; C columns
N_UPDATE = (8192, 1024, 100)     # thin QR; insert/delete index
N_RSVD = (65536, 4096, 64, 8, 2)  # m, n, k, p, n_iter; singular values DECAY^i
N_EIGH_RAND = (8192, 64, 8, 4)    # n, k, p, n_iter; eigenvalues (-1)^i DECAY^i
DECAY = 0.9
N_COND = (16384, 512, 1e3)        # singular values geomspace(1, 1/cond)
N_POLAR = ((16384, 512), (1 << 20, 128))   # blocked-QR route; TSQR route
N_SVD = 4096
N_EIGH = 2048
N_EIGH_CLUSTER = 512
N_EIGH_BATCHED = (4096, 64)
N_CHOL_PAD = 509                  # a QDWH Cholesky step on an exact-size eigh node
# The Jacobi rotation's c^2 + s^2 - 1 over seeded angles |tau| in a decade
# around each scale, float32 and float64: its mean, in eps, must stay within
# ROT_BIAS_TOL (a one-sided bias grows V's orthogonality defect linearly in
# the rotation rounds)
N_ROT_ANGLES = 1_000_000
ROT_SCALES = (1.0, 1e3, 1e5)
ROT_BIAS_TOL = 0.1
GIVENS_RATIOS = (1.0, 1e-3, 1e-5)   # |b|/|a| of the Givens rotations (models/update.py)
N_ORGQR_GROUPS = (512, 1024)        # k = 4 and 8 panels at nb = 128
# MIXED_CONFIG's 3xTF32 trailing update (fault C9).  GEMMs at the 8192^2
# factor's trailing shapes (name, m, k, n): one panel's V^H rest, a group
# of 4 merged panels' V^H rest, and V W.  "high" within MIXED_GEMM_HIGHEST x
# "highest"'s normwise error and under 1/MIXED_GEMM_TF32 of "tf32"'s, and
# "tf32" at least MIXED_GEMM_TF32_ON x "highest"'s (TF32 was on).
MIXED_GEMMS = (("V^H rest", 128, 8192, 8064), ("V^H rest, group of 4", 512, 8192, 7680),
               ("V W", 8192, 128, 8064))
MIXED_GEMM_HIGHEST, MIXED_GEMM_TF32, MIXED_GEMM_TF32_ON = 16, 100, 50
# qr_blocked + orgqr at DEFAULT, trailing "tf32" and MIXED: MIXED's residual
# under n eps / MIXED_RESID_DIV, its orthogonality within MIXED_ORTH_RATIO x
# DEFAULT's; "tf32" printed, ungated (the fault's record).
N_MIXED = (2048, 4096, 8192, 16384)
MIXED_RESID_DIV, MIXED_ORTH_RATIO = 10, 1.1
# Fault C11 and A7 (``--only precision``): the five ways a caller leaves
# PyTorch's float32 GEMM mode set, each in a process of its own; the port
# must work under each and leave it as it was.
CALLER_STATES = ("untouched", "allow_tf32", "matmul_precision_high", "matmul_fp32_precision",
                 "fp32_precision")
N_C11 = 1024                        # ct.qr under each state: cholqr2_bk, B1 every panel
C11_GEMM = (128, 8192, 8064)        # the 8192^2 factor's V^H rest
C11_HIGHEST_RATIO = 2.0             # "highest" error over the untouched state's, at most
C11_TF32_RATIO = 50.0               # "tf32" error over the untouched "highest", at least
C11_TIMEOUT_S = 300
# the 8192^2 factor at DEFAULT_CONFIG (PERF.md): B1 launches, and 3 host syncs
# a panel (round 2's test, B4's certificate, the fallback test)
DEFAULT_B1, DEFAULT_SYNCS = 65, 192
MIXED_CLI_FACTOR = ["--mixed", "factor", "4096", "4096"]
MIXED_CLI_TSQR = ["--tsqr-leaf", "cholqr2", "tsqr", "1048576", "128"]
MIXED_TSQR_RATIO = 2.0              # MIXED cholqr2 tsqr residual over DEFAULT's
# The distributed path: P_DIST ranks (sharing the card when there are fewer
# cards), at BASELINE config 3 (tsqr), config 5 cut to 16,384^2 on 4 ranks
# (caqr; 32,768^2 until the command line and complex phases came, which
# the time limit made room for), 8,192^2 for the CAQR variants, config 4
# (lstsq), and the spectral phases' shapes; then caqr at N_NCCL^2 on one
# rank over NCCL.
P_DIST = 4
N_CAQR_LEAF = 8192   # rows of a rank's leaf in caqr at N_NCCL^2 on one rank
DIST_SIZES = {"tsqr": N_TSQR, "caqr": 16384, "variants": 8192, "lstsq": N_RANK[:2],
              "polar": N_POLAR[0], "rsvd": N_RSVD, "eigh_rand": N_EIGH_RAND,
              "complex": (8192, 2048),
              # the complex *_dist solvers, complex64
              "cx_lstsq": (8192, 1024), "cx_polar": (16384, 256), "cx_rsvd": N_RSVD,
              "cx_eigh_rand": N_EIGH_RAND}
N_NCCL = 8192
DIST_JOIN_S = 700
# The command line (PR 8), in process: (argv, kernels each call must launch).
# Full width first; then every other command once at a size of seconds.
# The reference's panel-grouping ladder at 8192^2 (nb 128: 64 panels), each
# row a DEFAULT_CONFIG change: its default stages, the two headline
# groupings (bench.py), its tuned schedules (benchmarks/sweep_r4c.py) and
# its unrolled driver as config_from_reference maps it (factor_lookahead=1).
TAIL8X2 = (2,) * 24 + (8,) * 2
PROG248 = (2,) * 16 + (4,) * 4 + (8,) * 2
STAGE_LADDER = (("s4_g4", {"scan_stages": 4, "factor_lookahead": 4}),
                ("s16_g4", {"scan_stages": 16, "factor_lookahead": 4}),
                ("s32_g4", {"scan_stages": 32, "factor_lookahead": 4}),
                ("tail8x2_g8", {"stage_schedule": TAIL8X2, "factor_lookahead": 8}),
                ("prog248_g8", {"stage_schedule": PROG248, "factor_lookahead": 8}),
                ("unrolled", {"factor_lookahead": 1}))
STAGE_REPS = 10     # timed factor calls a row, after one warm-up, in rounds
STAGES_CLI = ["--stage-schedule", ",".join(map(str, TAIL8X2)), "factor", str(N_MAIN),
              str(N_MAIN)]
CLI_TRIALS = 3
CLI_FULL = ((["factor", "8192", "8192"], ("chol_inv",)),
            (["--mixed", "factor", "8192", "8192"], ("chol_inv",)),
            (["compare", "8192", "8192"], ("chol_inv",)),
            (["tsqr", "1048576", "128"], ("geqrt_batched",)),
            (["--tsqr-leaf", "cholqr2", "tsqr", "1048576", "128"], ("chol_inv",)),
            (["pivoted", "8192", "8192"], ("select_pivots", "chol_inv")),
            (["lstsq", "8192", "2048", "1"], ("chol_inv",)),
            (["batched", "8192", "256", "64"], ("chol_inv",)),
            (["oracle", "1024", "1024", "64", "16"], ()),        # BASELINE config 1
            (["--dtype", "f64", "factor", "1024", "1024"], ()))
CLI_SMALL = tuple((["--trials", "1", *argv], needs) for argv, needs in (
    (["update", "4096", "512"], ()),
    (["decomp", "lq", "1024", "4096"], ("chol_inv",)),
    (["decomp", "rq", "1024", "4096"], ("chol_inv",)),
    (["decomp", "ql", "4096", "1024"], ("chol_inv",)),
    (["rsvd", "8192", "1024"], ("geqrt_batched",)),
    (["rsvd", "2048", "2048", "--sym"], ()),
    (["polar", "4096", "1024"], ("chol_inv",)),
    (["eigh", "512"], ("chol_inv",)),
    (["svd", "1024", "512"], ("chol_inv",)),
    (["svd", "512", "512", "--eigh-impl", "qdwh"], ("chol_inv",)),
    (["svd", "2048", "2048", "--eigh-impl", "qdwh"], ("chol_inv",)),
    (["caqr", "8192", "4096", "--devices", "4"], ()),     # ranks: their own counts
    (["dist", "tsqr", "262144", "128", "--devices", "4"], ()),
    (["dist", "lstsq", "8192", "1024", "--devices", "4"], ()),
    (["dist", "polar", "8192", "256", "--devices", "4"], ()),
    (["dist", "svd", "8192", "256", "--devices", "4"], ()),
    (["dist", "rsvd", "8192", "1024", "--devices", "4"], ()),
    (["dist", "eigh-rand", "2048", "2048", "--devices", "4"], ())))
CLI_SUBPROCESS = ["--trials", "1", "factor", "4096", "4096"]
N_ORACLE = (1024, 64, 16)           # BASELINE config 1: n, pr, pc (float64)
ORACLE_R_TOL = 1e-9                 # R vs the oracle's, relative to max |R|, float64
# Complex QR (PR 8) on the card: no kernel may launch.
N_CX_QR = 8192                      # complex64 qr, reduced
N_CX_COMPLETE = (8192, 1024, 16)    # mode="complete"; apply_q(apply_qt(B)) with 16 columns
N_CX128 = 4096
N_CX_LSTSQ = (8192, 1024, 4)
N_CX_LQ = (1024, 8192)
N_CX_TSQR = (262144, 64)
N_CX_MIXED = 4096                   # complex64 qr at MIXED_CONFIG: gated (C3 repaired)
# The rest of complex input, complex64 unless noted: pivoted QR at the
# main path's width, the rank solvers on an exactly rank-r input, the Givens
# updates, the randomized tools on known spectra, QDWH polar / svd, eigh.
N_CX_PIVOTED = 8192
N_CX_RANK = (2048, 1024, 768)       # m, n, rank; rcond 1e-4 (cut from 4096 x 2048 for the time limit)
N_CX_UPDATE = (2048, 512, 100)      # thin QR; insert/delete index
N_CX_RSVD = (32768, 2048, 64, 8, 2)  # m, n, k, p, n_iter; singular values DECAY^i
N_CX_EIGH_RAND = (4096, 64, 8, 4)    # n, k, p, n_iter; eigenvalues (-1)^i DECAY^i
N_CX_COND = (2048, 1e3)             # n; singular values geomspace(1, 1/cond) (cut from 4096)
N_CX_POLAR = ((16384, 512, "complex64"), (4096, 256, "complex128"))
N_CX_SVD = 1024                     # cut from 2048^2 for the time limit
N_CX_EIGH = (512, 128)              # n, base_n (1024^2 took 23.2 s: cut for the time limit)
N_CX_EIGH_BATCHED = (1024, 64)


def say(*parts) -> None:
    print(*parts, flush=True)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a - b).abs().max())


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: float32 operations over the FP32
    peak or bytes (inputs read once, outputs written once) over HBM's rate,
    whichever is larger."""
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_PEAK * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes
            else "bytes"}


def chol_bound(b: int, nb: int) -> dict:
    """Cholesky (nb^3/3) plus triangular inverse (nb^3/3); read G, write L, L^-1."""
    return bound(b * 2 * nb ** 3 / 3, b * 3 * nb * nb * 4)


def geqrt_bound(b: int, m: int, w: int) -> dict:
    """geqr2 (2mw^2 - 2w^3/3) plus larft (w^2 (m - w/3)); read the panel,
    write the packed panel, tau and T."""
    return bound(b * (3 * m * w * w - w ** 3), b * (2 * m * w + w + w * w) * 4)


def pair_bound(b: int, w: int) -> dict:
    """geqr2 + larft of b triangle pairs [R_i; R_j] counted over the live
    triangles: step j updates w - 1 - j columns over top row j and bottom
    rows 0..j (4j + 8 each), the Gram's column j takes j(j + 1), T's
    column j the same; read the triangles, write the packed pair, tau
    and T."""
    flops = sum((w - 1 - j) * (4 * j + 8) + 2 * j * (j + 1) for j in range(w))
    return bound(b * flops, b * (w * (w + 1) + 2 * w * w + w + w * w) * 4)


def triangle_pairs(torch, np, L: int, w: int, seed: int, dtype, dev):
    """L stacked pairs [R_i; R_j] (L x 2w x w) of upper triangles shaped as
    a TSQR level's: N(0, 1) above the diagonal, exact zeros below, and on it
    +-sqrt(4w - i), the size of a Gaussian block's R."""
    rng = np.random.default_rng(seed)
    R = np.triu(rng.standard_normal((L, 2, w, w)))
    i = np.arange(w)
    R[..., i, i] = np.sqrt(4.0 * w - i) * rng.choice([-1.0, 1.0], size=(L, 2, w))
    return torch.from_numpy(R.reshape(L, 2 * w, w)).to(dev, dtype)


def select_bound(l: int, cand: int, nb: int) -> dict:
    """nb greedy steps, each a projection and a rank-1 update of the tile
    (4 l cand); read the tile and the norms, write the order."""
    return bound(4 * l * cand * nb, (l * cand + 2 * cand) * 4)


def newton_bound(nb: int, iters: int) -> dict:
    """iters Newton-Schulz iterations (two nb^3 products each, 4 nb^3) and
    the certificate's product (2 nb^3); read M, write N."""
    return bound((4 * iters + 2) * nb ** 3, 2 * nb * nb * 4)


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
    """Build every kernel library from this checkout (one nvcc per source, in
    parallel) and print what ptxas reports for each kernel."""
    from cuda_qr_tpu_torch.ops import _build
    t0 = time.perf_counter()
    paths = _build.load().paths
    say(f"build: nvcc {_build.build_seconds:.1f} s (parallel), load "
        f"{time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(str(p.relative_to(HERE)) for p in paths.values())}")
    for src, log in _build.build_log.items():
        say(f"ptxas {src}:\n{log}")


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
    for dtype, tol, nbs in ((torch.float32, TOL32, (16, 32, 48, 128, 160, 192, 256, 512)),
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
                out["library_ms"] = cuda_time_ms(lambda: chol_library(torch, G), reps=50)
                out["cholesky_ex_ms"] = cuda_time_ms(lambda: torch.linalg.cholesky_ex(G), reps=50)
                out.update(chol_bound(1, nb))
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
        f"{out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms, library (cholesky_ex + "
        f"solve_triangular) {out['library_ms']:.4f} ms (cholesky_ex alone "
        f"{out['cholesky_ex_ms']:.4f} ms), bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
    return out


def panel_M(torch, np, ct, dev, m: int, nb: int, seed: int):
    """M = I - S Q_J of the basis-kernel panel of a Gaussian m x nb panel, Q
    from CholeskyQR2 on the card, as ``panel_factor_cholqr2bk`` forms it."""
    from cuda_qr_tpu_torch.ops.fast_panel import _cholqr2
    A = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, nb), dtype=np.float32)).to(dev)
    Q, _, _ = _cholqr2(A, ct.DEFAULT_CONFIG)
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(Q.dtype)
    return torch.eye(nb, device=dev) - s[:, None] * QJ


def phase_newton(torch, np, ct, dev):
    """B4 (an 8-CTA cluster: Newton-Schulz and its certificate) against its
    plain twin ``newton_certified`` on M of live panels of NEWTON_ROWS rows at
    every NEWTON_NBS width (the same certificate decision, iterations within
    one, N within NEWTON_TOL where the certificate passes) and on a NaN; then
    the M of every panel of the 8192^2 factor at DEFAULT_CONFIG (one B4
    launch a panel, DEFAULT_SYNCS host syncs), each timed by CUDA events:
    the kernel, the plain chain (host syncs included) and
    torch.linalg.inv, beside the bound of its iterations."""
    from cuda_qr_tpu_torch.ops import _build, newton_kernel, smalllinalg
    from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    _build.load()
    say(f"ptxas newton_inv.cu:\n{_build.build_log.get('newton_inv.cu', '(cached library)')}")
    thr = 100 * torch.finfo(torch.float32).eps
    out = {"max_abs_err": 0.0, "body": "cluster", "cluster": 8}
    for nb in NEWTON_NBS:
        for m in NEWTON_ROWS:
            m = max(m, nb)
            M = panel_M(torch, np, ct, dev, m, nb, seed=m + nb)
            N, err, cert, iters = newton_certified_kernel(M)
            Np, errp, certp, iters_p = smalllinalg.newton_certified(M)
            iters_p = int(iters_p)
            ok, ok_p = bool(cert <= thr), bool(certp <= thr)
            e = rel_err(N, Np)
            say(f"newton_inv nb={nb}, {m} live rows: iterations {int(iters)} (plain {iters_p}), "
                f"err {float(err):.2e} ({float(errp):.2e}), cert {float(cert):.2e} "
                f"({float(certp):.2e}; passes at <= {thr:.2e}: {ok}, plain {ok_p}); rel err N "
                f"{e:.2e} (< {NEWTON_TOL:g} where it passes)")
            require(ok == ok_p and abs(int(iters) - iters_p) <= 1 and (not ok or e < NEWTON_TOL),
                    f"newton_inv disagrees with its plain twin at nb={nb}, {m} rows")
            if ok:
                out["max_abs_err"] = max(out["max_abs_err"], abs_err(N, Np))
    M = panel_M(torch, np, ct, dev, 2048, 128, seed=1)
    M[7, 100] = float("nan")
    N, err, cert, iters = newton_certified_kernel(M)
    require(not bool(torch.isfinite(N).any()) and bool(torch.isnan(err)) and int(iters) == 1
            and not bool(cert <= thr), f"newton_inv on a NaN: iters {int(iters)}, err "
            f"{float(err)}, cert {float(cert)}")
    say("newton_inv: a NaN in M -> non-finite N, NaN err and cert after 1 iteration: ok")

    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_MAIN, N_MAIN), dtype=np.float32)).to(dev)
    recorded = []
    launch = newton_kernel.newton_certified_kernel

    def record(M, *args, **kwargs):
        recorded.append(M.clone())
        return launch(M, *args, **kwargs)

    newton_kernel.newton_certified_kernel = record
    try:
        _, c, _ = run_counted(torch, lambda: ct.qr_blocked(A, ct.DEFAULT_CONFIG))
    finally:
        newton_kernel.newton_certified_kernel = launch
    panels = N_MAIN // ct.DEFAULT_CONFIG.panel_width
    say(f"newton_inv: factor {N_MAIN}^2 f32 DEFAULT_CONFIG: {counts_str(c)} (newton_inv == "
        f"{panels}, host syncs == {DEFAULT_SYNCS})")
    require(c["newton_inv"] == panels == len(recorded) and c["host_syncs"] == DEFAULT_SYNCS,
            f"newton_inv factor: {counts_str(c)}")
    iters = [int(newton_certified_kernel(M)[3]) for M in recorded]
    t_k = [cuda_time_ms(lambda M=M: newton_certified_kernel(M), reps=20) for M in recorded]
    t_p = [cuda_time_ms(lambda M=M: smalllinalg.newton_certified(M), reps=3, warmup=1)
           for M in recorded]
    t_l = [cuda_time_ms(lambda M=M: torch.linalg.inv(M), reps=20) for M in recorded]
    t_b = [newton_bound(128, i)["bound_ms"] for i in iters]
    slope, fixed = np.polyfit(iters, t_k, 1) if len(set(iters)) > 1 else (0.0, t_k[0])
    out.update(ms=statistics.median(t_k), plain_ms=statistics.median(t_p),
               library_ms=statistics.median(t_l), bound_ms=statistics.median(t_b),
               bound_by="operations", iters_min=min(iters),
               iters_median=statistics.median(iters), iters_max=max(iters),
               us_per_iteration=1e3 * slope, fixed_us=1e3 * fixed,
               factor_ms=sum(t_k), factor_plain_ms=sum(t_p), factor_library_ms=sum(t_l),
               factor_bound_ms=sum(t_b))
    say(f"newton_inv on the {panels} panels of the {N_MAIN}^2 factor (nb 128): iterations "
        f"{min(iters)}-{max(iters)} (median {out['iters_median']}); kernel median "
        f"{out['ms']:.4f} ms a launch ({out['us_per_iteration']:.2f} us an iteration + "
        f"{out['fixed_us']:.2f} us, least squares over the panels), plain chain "
        f"{out['plain_ms']:.4f} ms, torch.linalg.inv {out['library_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.6f} ms (operations); a factor's panels: kernel "
        f"{out['factor_ms']:.3f} ms, plain {out['factor_plain_ms']:.3f} ms, torch.linalg.inv "
        f"{out['factor_library_ms']:.3f} ms, bound {out['factor_bound_ms']:.4f} ms")
    return out


def chol_library(torch, G):
    """The PyTorch yardstick of B1: no single call returns L and L^-1."""
    L, _ = torch.linalg.cholesky_ex(G)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device).expand_as(G)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def phase_geqrt(torch, np, dev):
    from cuda_qr_tpu_torch.ops.geqrt import body, geqrt_base, geqrt_base_plain, plan
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
        say(f"geqrt {str(dtype)[6:]} m={m} w={w} off={off}{' zero cols' if zero else ''} "
            f"({body(m, w, off, dtype)} body, kb={plan(m, w, off, dtype).kb}): rel err packed "
            f"{errs[0]:.2e}, tau {errs[1]:.2e}, T {errs[2]:.2e} (tol {tol:g})")
        if not (finite and max(errs) < tol and torch.equal(pk[:off], P[:off])):
            raise AssertionError(f"geqrt disagrees with its plain version at {(m, w, off)}")
        if dtype == torch.float32 and (m, w, off) == (8192, 32, 0):
            out["max_abs_err"] = max(abs_err(pk, pp), abs_err(tau, taup), abs_err(T, Tp))
            out["ms"] = cuda_time_ms(lambda: geqrt_base(P, 0), reps=20)
            out["plain_ms"] = cuda_time_ms(lambda: geqrt_base_plain(P, 0), reps=5)
            out["library_ms"] = cuda_time_ms(lambda: torch.geqrf(P), reps=20)
            out.update(geqrt_bound(1, m, w))
    say(f"geqrt: 8192x32 f32 kernel {out['ms']:.4f} ms vs plain {out['plain_ms']:.4f} ms, "
        f"torch.geqrf {out['library_ms']:.4f} ms (computes less: no T), bound "
        f"{out['bound_ms']:.6f} ms ({out['bound_by']})")
    # The distributed CAQR's leaf: a 128-column slice of a rank's rows of a
    # wider matrix, read in place (row stride 512 here), from a live offset.
    m, w = N_CAQR_LEAF, 128
    W = torch.from_numpy(rng.standard_normal((m, 4 * w))).to(dev, torch.float32)
    panel = W[:, w:2 * w]
    for off in (0, m // 2):
        pk, tau, T = geqrt_base(panel, off)
        pp, taup, Tp = geqrt_base_plain(panel, off)
        torch.cuda.synchronize()
        errs = (rel_err(pk, pp), rel_err(tau, taup), rel_err(T, Tp))
        say(f"geqrt CAQR leaf f32 m={m} w={w} column slice (lda {W.stride(0)}) off={off} "
            f"({body(m, w, off, torch.float32)} body): rel err packed {errs[0]:.2e}, tau "
            f"{errs[1]:.2e}, T {errs[2]:.2e} (tol {TOL32:g})")
        require(max(errs) < TOL32 and torch.equal(pk[:off], panel[:off]),
                f"geqrt disagrees with its plain version on the CAQR leaf, off={off}")
    out["caqr_leaf_ms"] = cuda_time_ms(lambda: geqrt_base(panel, 0), reps=10)
    out["caqr_leaf_plain_ms"] = cuda_time_ms(lambda: geqrt_base_plain(panel, 0), reps=3)
    out["caqr_leaf_library_ms"] = cuda_time_ms(lambda: torch.geqrf(panel), reps=10)
    out["caqr_leaf_bound_ms"] = geqrt_bound(1, m, w)["bound_ms"]
    say(f"geqrt CAQR leaf {m}x{w} f32: kernel {out['caqr_leaf_ms']:.4f} ms vs plain "
        f"{out['caqr_leaf_plain_ms']:.4f} ms, torch.geqrf {out['caqr_leaf_library_ms']:.4f} ms, "
        f"bound {out['caqr_leaf_bound_ms']:.6f} ms")
    return out


def phase_select(torch, np, dev):
    """B3 (an 8-CTA thread block cluster) against its plain version on
    every SELECT_TILES shape; on the first shape also with ties, ineligible
    columns, a tie across the cluster's CTAs and a NaN; then each shape
    timed."""
    from cuda_qr_tpu_torch.ops.select_kernel import (select_pivots_kernel, select_pivots_plain,
                                                     selection_margin)
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    out = {"max_abs_err": 0, "body": "cluster", "cluster": 8, "shapes": []}
    for l, cand, nb, seed in SELECT_TILES:
        S = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (l, cand), dtype=np.float32)).to(dev)
        norms = (S.double() ** 2).sum(0).float()
        tiles = [("gaussian", S, norms, nb)]        # (name, tile, norms, steps before a stop)
        first = (l, cand, nb) == SELECT_TILES[0][:3]
        if first:
            T = S.clone()
            T[:, [40, 300]] = T[:, [7, 7]]          # duplicates of column 7
            T[:, [3, 200, 511]] = 0                 # zero columns
            tn = (T.double() ** 2).sum(0).float()
            inactive = tn.clone()
            inactive[::3] = -1                      # ineligible columns
            X = S.clone()                           # the largest column thrice, across CTAs
            X[:, [63, 64, 500]] = 2 * S[:, [int(torch.argmax(norms))]]
            N = S.clone()
            N[17, 200] = float("nan")               # column 200's norm is NaN from step 1 on
            tiles += [("duplicate+zero", T, tn, nb), ("inactive", T, inactive, nb),
                      ("cross-CTA tie", X, (X.double() ** 2).sum(0).float(), nb),
                      ("NaN at step 1", N, norms, 1)]
        for name, T, tn, k in tiles:
            gap = selection_margin(T, tn, k)
            if gap < MIN_GAP:
                raise AssertionError(f"select tile {name} {(l, cand, nb)} is not well separated")
            want = select_pivots_plain(T, tn, nb)
            if k < nb:                              # the kernel stops where a norm is NaN
                want = torch.where((want >= 0) & (want < k), want, -1)
            T0 = T.clone()
            got = select_pivots_kernel(T, tn, nb)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want))
            picks = torch.sort(got[got >= 0]).values
            say(f"select_pivots l={l} cand={cand} nb={nb} {name}: min gap {gap:.2e} "
                f"(>= {MIN_GAP:g}), ord identical {same}")
            if not (same and torch.equal(T.view(torch.int32), T0.view(torch.int32))):
                raise AssertionError(f"select_pivots disagrees with its plain version "
                                     f"at {(l, cand, nb)} on the {name} tile")
            if not torch.equal(picks, torch.arange(k, dtype=torch.int32, device=dev)):
                raise AssertionError(f"select_pivots picked {picks.numel()} columns of "
                                     f"{(l, cand, nb)} {name}, expected {k}")
            if name == "inactive" and not bool((got[::3] == -1).all()):
                raise AssertionError("select_pivots picked an ineligible column")
            out["max_abs_err"] = max(out["max_abs_err"], int((got - want).abs().max()))
        ms = cuda_time_ms(lambda: select_pivots_kernel(S, norms, nb), reps=20)
        rec = {"l": l, "cand": cand, "nb": nb, "ms": ms, "us_per_step": ms * 1e3 / nb,
               **select_bound(l, cand, nb)}
        line = (f"select_pivots: {l}x{cand} nb={nb} cluster of 8: {ms:.4f} ms "
                f"({rec['us_per_step']:.2f} us/step), bound {rec['bound_ms']:.6f} ms")
        if first:
            out.update(ms=ms, us_per_step=rec["us_per_step"])
            out["plain_ms"] = cuda_time_ms(lambda: select_pivots_plain(S, norms, nb), reps=3)
            line += f", plain {out['plain_ms']:.4f} ms"
        say(line)
        out["shapes"].append(rec)
    return out


def phase_rank(torch, np, ct, cfg, dev):
    """Rank-revealing solvers on an exactly rank-r 8192 x 2048 A = B C,
    full-rank lstsq on a Gaussian of the same shape, then phase_slogdet,
    whose counts it returns."""
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
    return phase_slogdet(torch, np, ct, cfg, dev)


def phase_slogdet(torch, np, ct, cfg, dev):
    """slogdet of N_SLOGDET Gaussian float32 n^2 inputs (n a multiple of the
    panel width: the last panel is square), sign held to
    torch.linalg.slogdet in float64 (no wrong sign), logabsdet to 1e-4
    relative.  Beside it, the reference's rule (the parity of tau != 0) on
    the same factors: qr_blocked at the cholqr2_hr panels slogdet swaps in,
    whose logabsdet must equal slogdet's bit for bit.  Times (one call a
    seed, CUDA events, median): slogdet, that factor alone (the rest is the
    sign rule), the default cholqr2_bk factor, and torch.linalg.slogdet in
    float32.  Returns the counts of the slogdet calls."""
    n, seeds = N_SLOGDET
    hr = cfg.replace(panel_method="cholqr2_hr")
    total, wrong, wrong_old, errs, same = {}, 0, 0, [], True
    ms = {"slogdet": [], "factor": [], "bk factor": [], "library": []}
    for seed in range(seeds):
        A = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (n, n), dtype=np.float32)).to(dev)
        (sign, logabs), c, _ = run_counted(torch, lambda: ct.slogdet(A, cfg))
        add_counts(total, c)
        for key, fn in (("slogdet", lambda: ct.slogdet(A, cfg)),
                        ("factor", lambda: ct.qr_blocked(A, hr)),
                        ("bk factor", lambda: ct.qr_blocked(A, cfg)),
                        ("library", lambda: torch.linalg.slogdet(A))):
            ms[key].append(event_call_ms(torch, fn))
        want_sign, want_logabs = torch.linalg.slogdet(A.double())
        fac = ct.qr_blocked(A, hr)
        d = torch.diagonal(fac.packed)[:n]
        same &= torch.equal(torch.log(d.abs()).sum(), logabs)
        flips = int((fac.taus.reshape(-1)[:n] != 0).sum())
        old = float(torch.prod(torch.sign(d))) * (-1.0) ** flips
        wrong += float(sign) != float(want_sign)
        wrong_old += old != float(want_sign)
        errs.append(abs(float(logabs) - float(want_logabs)) / abs(float(want_logabs)))
    say(f"slogdet {n}^2 f32 at DEFAULT_CONFIG, seeds 0-{seeds - 1}: wrong signs {wrong} of "
        f"{seeds} vs torch.linalg.slogdet float64 (must be 0); the reference's tau != 0 rule "
        f"on the same factors: {wrong_old} of {seeds} wrong (factors the same: {same}); "
        f"logabsdet rel err max {max(errs):.3e} (< 1e-4); chol_inv launches "
        f"{total['chol_inv']} ({total['chol_inv'] / seeds:.2f} a call), host syncs "
        f"{total['host_syncs']}")
    med = {key: sorted(v)[seeds // 2] for key, v in ms.items()}
    say(f"slogdet {n}^2 ms a call (median of {seeds}): {med['slogdet']:.3f}; its cholqr2_hr "
        f"factor alone {med['factor']:.3f}; the default cholqr2_bk factor "
        f"{med['bk factor']:.3f}; torch.linalg.slogdet f32 {med['library']:.3f}")
    require(wrong == 0, f"slogdet: {wrong} of {seeds} signs wrong")
    require(same, "slogdet's logabsdet differs from qr_blocked's at cholqr2_hr")
    require(max(errs) < 1e-4, f"slogdet: logabsdet rel err {max(errs)} over 1e-4")
    require(total["chol_inv"] >= seeds * n // cfg.panel_width,
            f"slogdet launched chol_inv {total['chol_inv']} times, expected >= "
            f"{seeds * n // cfg.panel_width} (one per panel)")
    return total


def dense_body(torch, P):
    """A call of the dense sub-panel body on a float32 stack that ``plan``
    sends to the blocked body (its C entry with the dense plan): the
    yardstick the blocked body replaces.  Returns (packed, tau, T)."""
    from cuda_qr_tpu_torch.ops import _build
    from cuda_qr_tpu_torch.ops.geqrt import plan
    L, m, w = P.shape
    p = plan(m, w, 0, P.dtype)
    packed, tau, T = torch.empty_like(P), P.new_empty((L, w)), P.new_empty((L, w, w))
    fn = _build.load().cqt_geqrt_batched_f32
    _build.check(fn(P.data_ptr(), w, packed.data_ptr(), tau.data_ptr(), T.data_ptr(), L, m, w,
                    0, p.kb, int(p.resident), p.slices,
                    torch.cuda.current_stream().cuda_stream), "dense body")
    return packed, tau, T


def phase_geqrt_batched(torch, np, dev):
    """The geqrt kernel's batch grid against its plain version; at the TSQR
    leaf stack (the blocked body), the node stack and one node it is timed
    beside torch.geqrf (which computes less: no T), the leaf stack also
    beside the dense sub-panel body it replaces."""
    from cuda_qr_tpu_torch.ops.geqrt import body, geqrt_batched, geqrt_batched_plain, plan
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    rng = np.random.default_rng(6)
    out = {}
    for L, m, w, off, f64, zero in GEQRT_BATCHED:
        dtype, tol = (torch.float64, TOL64) if f64 else (torch.float32, TOL32)
        P = torch.from_numpy(rng.standard_normal((L, m, w), dtype=np.float32)).to(dev, dtype)
        if zero:
            P[5] = 0.0                  # one panel of zero columns only
            P[9, :, [0, 7]] = 0.0
        pk, tau, T = geqrt_batched(P, off)
        pp, taup, Tp = geqrt_batched_plain(P, off)
        torch.cuda.synchronize()
        errs = (rel_err(pk, pp), rel_err(tau, taup), rel_err(T, Tp))
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(T).all())
        say(f"geqrt_batched {str(dtype)[6:]} {L} x {m}x{w} off={off}"
            f"{' zero panel' if zero else ''} ({body(m, w, off, dtype)} body, "
            f"kb={plan(m, w, off, dtype).kb}): rel err packed {errs[0]:.2e}, "
            f"tau {errs[1]:.2e}, T {errs[2]:.2e} (tol {tol:g})")
        if not (finite and max(errs) < tol and torch.equal(pk[:, :off], P[:, :off])
                and pk.is_contiguous()):
            raise AssertionError(f"geqrt_batched disagrees with its plain version at "
                                 f"{(L, m, w, off)}")
        if zero and not bool((tau[5] == 0).all()):
            raise AssertionError("geqrt_batched: a zero panel gave a nonzero tau")
        if (L, m, w, off) == GEQRT_BATCHED[0][:4]:          # the TSQR leaves
            out["max_abs_err"] = max(abs_err(pk, pp), abs_err(tau, taup), abs_err(T, Tp))
            out["body"] = body(m, w, off, dtype)
            dense = dense_body(torch, P)
            out["dense_rel_err"] = max(rel_err(a, b) for a, b in zip(dense, (pp, taup, Tp)))
            require(out["dense_rel_err"] < tol, "the dense body disagrees with the plain version")
            del dense
            out["ms"] = cuda_time_ms(lambda: geqrt_batched(P, 0), reps=5, warmup=1)
            out["dense_ms"] = cuda_time_ms(lambda: dense_body(torch, P), reps=5, warmup=1)
            out["plain_ms"] = cuda_time_ms(lambda: geqrt_batched_plain(P, 0), reps=2, warmup=1)
            out["library_ms"] = cuda_time_ms(lambda: torch.geqrf(P), reps=2, warmup=1)
            out.update(geqrt_bound(L, m, w))
        if (L, m, w, off) == GEQRT_BATCHED[1][:4]:          # a tree level, and one node
            P1 = P[:1].contiguous()
            out["node_stack_ms"] = cuda_time_ms(lambda: geqrt_batched(P, 0), reps=20)
            out["node_stack_library_ms"] = cuda_time_ms(lambda: torch.geqrf(P), reps=5)
            out["node_ms"] = cuda_time_ms(lambda: geqrt_batched(P1, 0), reps=20)
            out["node_library_ms"] = cuda_time_ms(lambda: torch.geqrf(P1[0]), reps=20)
            out["node_bound_ms"] = geqrt_bound(1, m, w)["bound_ms"]
        del P, pk, pp, T, Tp
    (L, m, w), (Ln, mn, wn) = GEQRT_BATCHED[0][:3], GEQRT_BATCHED[1][:3]
    say(f"geqrt_batched: {L} x {m}x{w} f32 kernel ({out['body']} body) {out['ms']:.4f} ms vs "
        f"the dense body {out['dense_ms']:.4f} ms (rel err {out['dense_rel_err']:.2e}), plain "
        f"{out['plain_ms']:.4f} ms, torch.geqrf {out['library_ms']:.4f} ms (no T), bound "
        f"{out['bound_ms']:.4f} ms ({out['bound_by']})")
    say(f"geqrt_batched: {Ln} x {mn}x{wn} f32 kernel {out['node_stack_ms']:.4f} ms, torch.geqrf "
        f"{out['node_stack_library_ms']:.4f} ms; one {mn}x{wn} node {out['node_ms']:.4f} ms, "
        f"torch.geqrf {out['node_library_ms']:.4f} ms, bound {out['node_bound_ms']:.6f} ms")
    return out


def phase_geqrt_pair(torch, np, dev):
    """B2's triangle-pair body against the plain version on stacked upper
    triangles (a zero bottom block, the odd level's phantom sibling, and a
    zero column among them), with exact zeros where the pair structure puts
    them; its occupancy; then one 256 x 128 node and the 512-node level
    timed beside the dense resident body on the same input and
    torch.geqrf, and the live triangles' bound."""
    from cuda_qr_tpu_torch.ops.geqrt import geqrt_batched, geqrt_batched_plain, pair_occupancy
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    out = {}
    for L, w, f64 in GEQRT_PAIR:
        dtype, tol = (torch.float64, TOL64) if f64 else (torch.float32, TOL32)
        P = triangle_pairs(torch, np, L, w, L + w, dtype, dev)
        if L > 2:
            P[1, w:] = 0.0                   # the phantom sibling
            P[2, :, min(5, w - 1)] = 0.0     # a zero column in both halves
        before = (geqrt_batched.launches, geqrt_batched.pair_launches)
        pk, tau, T = geqrt_batched(P, 0, pair=True)
        pp, taup, Tp = geqrt_batched_plain(P, 0)
        torch.cuda.synchronize()
        errs = (rel_err(pk, pp), rel_err(tau, taup), rel_err(T, Tp))
        lower = torch.ones(w, w, dtype=torch.bool, device=dev).tril(-1)
        zeros = bool((pk[:, :w][:, lower] == 0).all() and (pk[:, w:][:, lower] == 0).all()
                     and (T[:, lower] == 0).all())
        finite = bool(torch.isfinite(pk).all() and torch.isfinite(T).all())
        say(f"geqrt_batched pair {str(dtype)[6:]} {L} x {2 * w}x{w}: rel err packed "
            f"{errs[0]:.2e}, tau {errs[1]:.2e}, T {errs[2]:.2e} (tol {tol:g}); structural "
            f"zeros exact {zeros}; launches +{geqrt_batched.launches - before[0]}, pair "
            f"+{geqrt_batched.pair_launches - before[1]}")
        require(finite and max(errs) < tol and zeros,
                f"geqrt_batched pair body disagrees with its plain version at {(L, w, dtype)}")
        require((geqrt_batched.launches - before[0], geqrt_batched.pair_launches - before[1])
                == (1, 1), "geqrt_batched pair=True must launch once, counted as a pair launch")
        if L > 2:
            require(float(tau[2, min(5, w - 1)]) == 0.0, "a zero column must give tau = 0")
        if (L, w, f64) == GEQRT_PAIR[0]:
            out["pair_max_abs_err"] = max(abs_err(pk, pp), abs_err(tau, taup), abs_err(T, Tp))
        del pk, pp, T, Tp
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        out[f"pair_ctas_per_sm_{name}"] = pair_occupancy(128, dtype)
        say(f"geqrt pair body at w = 128 {name}: {out[f'pair_ctas_per_sm_{name}']} CTAs an SM "
            f"by the runtime's occupancy")
    require(out["pair_ctas_per_sm_float32"] >= 2, "the pair body must fit 2 CTAs an SM at "
            "256 x 128 float32")
    L, w = GEQRT_PAIR[0][:2]
    P = triangle_pairs(torch, np, L, w, 7, torch.float32, dev)
    P1 = P[:1].contiguous()
    out["pair_node_ms"] = cuda_time_ms(lambda: geqrt_batched(P1, 0, pair=True), reps=50)
    out["pair_node_dense_ms"] = cuda_time_ms(lambda: geqrt_batched(P1, 0), reps=20)
    out["pair_node_library_ms"] = cuda_time_ms(lambda: torch.geqrf(P1[0]), reps=20)
    out["pair_node_bound_ms"] = pair_bound(1, w)["bound_ms"]
    out["pair_level_ms"] = cuda_time_ms(lambda: geqrt_batched(P, 0, pair=True), reps=20)
    out["pair_level_dense_ms"] = cuda_time_ms(lambda: geqrt_batched(P, 0), reps=5)
    out["pair_level_library_ms"] = cuda_time_ms(lambda: torch.geqrf(P), reps=3)
    out["pair_level_bound_ms"] = pair_bound(L, w)["bound_ms"]
    say(f"geqrt pair body, one {2 * w}x{w} f32 node: {out['pair_node_ms']:.4f} ms; the dense "
        f"resident body {out['pair_node_dense_ms']:.4f} ms, torch.geqrf "
        f"{out['pair_node_library_ms']:.4f} ms (no T); live-triangle bound "
        f"{out['pair_node_bound_ms']:.6f} ms ({pair_bound(1, w)['bound_by']})")
    say(f"geqrt pair body, a level of {L} nodes: {out['pair_level_ms']:.4f} ms; the dense "
        f"resident body {out['pair_level_dense_ms']:.4f} ms, torch.geqrf "
        f"{out['pair_level_library_ms']:.4f} ms (no T); live-triangle bound "
        f"{out['pair_level_bound_ms']:.6f} ms ({pair_bound(L, w)['bound_by']})")
    return out


def phase_chol_stack(torch, np, ct, dev):
    """A stack of Gram matrices through chol_with_inv_auto: one launch of
    the chol_inv kernel's batch grid, against the batched plain recursion."""
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_auto, chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.smalllinalg import cholesky_with_inv
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    b, n = CHOL_STACK
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((b, n, 2 * n))).to(dev)
    G = (B @ B.mT / (2 * n)).float()
    cfg = ct.DEFAULT_CONFIG
    before = chol_with_inv_kernel.launches
    L, Li = chol_with_inv_auto(G, cfg)
    launched = chol_with_inv_kernel.launches - before
    Lp, Lip = cholesky_with_inv(G)
    torch.cuda.synchronize()
    eL, eLi = rel_err(L, Lp), rel_err(Li, Lip)
    t_k = cuda_time_ms(lambda: chol_with_inv_auto(G, cfg), reps=10)
    t_p = cuda_time_ms(lambda: cholesky_with_inv(G), reps=3)
    t_l = cuda_time_ms(lambda: chol_library(torch, G), reps=10)
    t_c = cuda_time_ms(lambda: torch.linalg.cholesky_ex(G), reps=10)
    bnd = chol_bound(b, n)["bound_ms"]
    say(f"chol_inv stack {b} x {n}x{n} f32 via chol_with_inv_auto: {launched} launch, rel err "
        f"L {eL:.2e}, L^-1 {eLi:.2e} (tol {TOL32:g}); kernel {t_k:.4f} ms vs batched plain "
        f"{t_p:.4f} ms, library (cholesky_ex + solve_triangular) {t_l:.4f} ms (cholesky_ex "
        f"alone {t_c:.4f} ms), bound {bnd:.4f} ms")
    if not (launched == 1 and eL < TOL32 and eLi < TOL32):
        raise AssertionError("chol_inv stack disagrees with the batched plain recursion")
    return {"stack_ms": t_k, "stack_plain_ms": t_p, "stack_library_ms": t_l, "stack_bound_ms": bnd}


def counters():
    from cuda_qr_tpu_torch.ops import smalllinalg
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_batched
    from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
    from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
    return smalllinalg, (chol_with_inv_kernel, geqrt_base, geqrt_batched, select_pivots_kernel,
                         newton_certified_kernel)


def reset_counts(torch) -> None:
    torch.cuda.synchronize()
    sl, fns = counters()
    sl.host_syncs = 0
    for fn in fns:
        fn.launches = 0
    geqrt_base, geqrt_batched = fns[1], fns[2]
    geqrt_batched.pair_launches = 0
    geqrt_batched.leaf_launches = geqrt_base.leaf_launches = 0


def read_counts() -> dict:
    sl, (chol, base, batched, select, newton) = counters()
    return {"chol_inv": chol.launches, "geqrt": base.launches,
            "geqrt_batched": batched.launches, "geqrt_pair": batched.pair_launches,
            "geqrt_leaf": batched.leaf_launches + base.leaf_launches,
            "select_pivots": select.launches, "newton_inv": newton.launches,
            "host_syncs": sl.host_syncs}


def counts_str(c: dict) -> str:
    return (f"launches chol_inv {c['chol_inv']}, geqrt {c['geqrt']}, geqrt_batched "
            f"{c['geqrt_batched']} (pair body {c['geqrt_pair']}), blocked leaf body "
            f"{c['geqrt_leaf']}, select_pivots "
            f"{c['select_pivots']}, newton_inv {c['newton_inv']}; host syncs {c['host_syncs']}")


def run_counted(torch, fn):
    """fn() with the counts set to 0 just before and read just after:
    (result, counts, seconds of this first call)."""
    reset_counts(torch)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, read_counts(), seconds


def add_counts(total: dict, c: dict) -> None:
    for key, v in c.items():
        total[key] = total.get(key, 0) + v


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def orth_defect(torch, Q) -> float:
    """||Q^H Q - I||_F in float64 on Q's device."""
    Q64 = wide(torch, Q)
    G = Q64.mH @ Q64
    G.diagonal().sub_(1.0)
    return float(G.norm())


def haar(torch, rows: int, cols: int, seed: int, dev):
    """An orthonormal (rows x cols) float64 factor: Q of a seeded Gaussian."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.linalg.qr(torch.randn(rows, cols, generator=g, dtype=torch.float64,
                                       device=dev)).Q


def phase_tsqr(torch, np, ct, dev, smi):
    """BASELINE config 3: tsqr / tsqr_r at 1,048,576 x 128 float32 with both
    leaves, then an ill-conditioned input that must take the fallback."""
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    m, n = N_TSQR
    A = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (m, n), dtype=np.float32)).to(dev)
    eps = float(torch.finfo(torch.float32).eps)
    result = {}
    for leaf, orth_gate in (("householder", 4 * n * eps), ("cholqr2", 4 * m ** 0.5 * eps)):
        cfg = ct.QRConfig(tsqr_leaf=leaf)
        reset_counts(torch)
        t0 = time.perf_counter()
        Q, R = ct.tsqr(A, cfg)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        counts = read_counts()
        chk = ct.check_qr_device(A, Q, R)
        say(f"tsqr {m}x{n} f32 {leaf}: residual {chk.residual:.3e} (< {n * eps:.3e}), "
            f"orthogonality {chk.orthogonality:.3e} (< {orth_gate:.3e}), tril(R) "
            f"{chk.r_triangular:g}; {t_first:.3f} s first call, launches geqrt_batched "
            f"{counts['geqrt_batched']} (pair body {counts['geqrt_pair']}, blocked leaf body "
            f"{counts['geqrt_leaf']}), chol_inv "
            f"{counts['chol_inv']}, host syncs {counts['host_syncs']}")
        if not (chk.residual < n * eps and chk.orthogonality < orth_gate
                and chk.r_triangular == 0.0):
            raise AssertionError(f"tsqr {leaf} fails its gates")
        kernel = "geqrt_batched" if leaf == "householder" else "chol_inv"
        if counts[kernel] == 0:
            raise AssertionError(f"tsqr {leaf} launched no {kernel} kernel")
        # the leaves on the blocked body, then each of the 10 tree levels on
        # the pair body
        tree = (counts[kernel], counts["geqrt_pair"], counts["geqrt_leaf"])
        require(leaf != "householder" or tree == (11, 10, 1),
                f"tsqr householder launched geqrt_batched {tree[0]} times, {tree[1]} of them "
                f"the pair body and {tree[2]} the blocked leaf body; expected 11, 10 and 1")
        reset_counts(torch)
        Rr = ct.tsqr_r(A, cfg)
        counts_r = read_counts()
        e_r = rel_err(Rr, R)
        say(f"tsqr_r {leaf}: rel diff to tsqr's R {e_r:.2e} (< {TOL32:g}); launches "
            f"geqrt_batched {counts_r['geqrt_batched']} (pair body {counts_r['geqrt_pair']}, "
            f"blocked leaf body {counts_r['geqrt_leaf']}), "
            f"chol_inv {counts_r['chol_inv']}, host syncs {counts_r['host_syncs']}")
        if not e_r < TOL32:
            raise AssertionError(f"tsqr_r {leaf} disagrees with tsqr's R")
        tree_r = (counts_r["geqrt_batched"], counts_r["geqrt_pair"], counts_r["geqrt_leaf"])
        require(leaf != "householder" or tree_r == (11, 10, 1),
                f"tsqr_r householder launched geqrt_batched {tree_r[0]} times, {tree_r[1]} of "
                f"them the pair body and {tree_r[2]} the blocked leaf body; expected 11, 10 "
                f"and 1")
        del Q, R, Rr
        result[leaf] = (counts, cuda_time_ms(lambda: ct.tsqr(A, cfg), reps=5, warmup=1),
                        cuda_time_ms(lambda: ct.tsqr_r(A, cfg), reps=5, warmup=1))
    t_torch = cuda_time_ms(lambda: torch.linalg.qr(A), reps=5, warmup=1)
    t_torch_r = cuda_time_ms(lambda: torch.linalg.qr(A, mode="r"), reps=5, warmup=1)
    del A

    mi, ni, cexp = N_TSQR_ILL
    rng = np.random.default_rng(14)
    U, _ = np.linalg.qr(rng.standard_normal((mi, ni)))
    V, _ = np.linalg.qr(rng.standard_normal((ni, ni)))
    Ai = torch.from_numpy(((U * np.logspace(0, -cexp, ni)) @ V.T).astype(np.float32)).to(dev)
    reset_counts(torch)
    Q, R = ct.tsqr(Ai, ct.QRConfig(tsqr_leaf="cholqr2"))
    counts = read_counts()
    chk = ct.check_qr_device(Ai, Q, R)
    say(f"tsqr {mi}x{ni} f32 cholqr2, cond 1e{cexp}: residual {chk.residual:.3e}, orthogonality "
        f"{chk.orthogonality:.3e} (< {4 * ni * eps:.3e}); fell back to the Householder tree: "
        f"geqrt_batched launches {counts['geqrt_batched']} (pair body {counts['geqrt_pair']}), "
        f"chol_inv {counts['chol_inv']}, host syncs {counts['host_syncs']}")
    if not (chk.ok and counts["geqrt_batched"] > 0):
        raise AssertionError("ill-conditioned tsqr did not take the Householder fallback "
                             "or fails its gates")
    say(f"tsqr timings on {smi}:")
    for leaf, (counts, t_q, t_r) in result.items():
        say(f"  tsqr {m}x{n} f32 {leaf}: {t_q:.2f} ms (tsqr_r {t_r:.2f} ms), "
            f"{counts['host_syncs']} host syncs")
    say(f"  torch.linalg.qr reduced: {t_torch:.2f} ms; mode='r': {t_torch_r:.2f} ms")
    return {k: result["householder"][0][k] for k in ("geqrt_batched", "geqrt_pair", "geqrt_leaf")}


def phase_qr_batched(torch, np, ct, dev):
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    b, m, n = N_BATCHED
    A = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (b, m, n), dtype=np.float32)).to(dev)
    cfg = ct.DEFAULT_CONFIG
    reset_counts(torch)
    Q, R = ct.qr_batched(A, cfg)
    counts = read_counts()
    A64, Q64 = A.double(), Q.double()
    resid = float(((A64 - Q64 @ R.double()).norm(dim=(1, 2)) / A64.norm(dim=(1, 2))).max())
    orth = float((Q64.mT @ Q64 - torch.eye(n, dtype=torch.float64, device=dev))
                 .norm(dim=(1, 2)).max())
    eps = float(torch.finfo(torch.float32).eps)
    tri = float(torch.tril(R, -1).abs().max())
    pos = bool((torch.diagonal(R, 0, -2, -1) > 0).all())
    del A64, Q64
    t_b = cuda_time_ms(lambda: ct.qr_batched(A, cfg), reps=5, warmup=1)
    t_t = cuda_time_ms(lambda: torch.linalg.qr(A), reps=5, warmup=1)
    say(f"qr_batched {b} x {m}x{n} f32: max residual {resid:.3e} (< {n * eps:.3e}), max "
        f"orthogonality {orth:.3e} (< {4 * n * eps:.3e}), tril(R) {tri:g}, diag(R) > 0 {pos}; "
        f"chol_inv launches {counts['chol_inv']}, host syncs {counts['host_syncs']}; "
        f"{t_b:.2f} ms vs batched torch.linalg.qr {t_t:.2f} ms")
    if not (resid < n * eps and orth < 4 * n * eps and tri == 0.0 and pos
            and counts["chol_inv"] > 0):
        raise AssertionError("qr_batched fails its checks")


def phase_decomp(torch, np, ct, dev):
    """lq / rq / ql and qr_multiply in float64 on the card."""
    m, n, p = N_DECOMP
    cfg = ct.QRConfig(dtype=torch.float64)
    rng = np.random.default_rng(16)
    A = torch.from_numpy(rng.standard_normal((m, n))).to(dev)
    eps = float(torch.finfo(torch.float64).eps)
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for name, M in (("lq", A.T.contiguous()), ("rq", A), ("ql", A)):
        X, Y = getattr(ct, name)(M, cfg)
        T, O = (Y, X) if name == "ql" else (X, Y)       # triangular, orthogonal factor
        rows, cols = T.shape
        if name == "rq":                                 # upper-trapezoidal R (m x k)
            tri = float(torch.tril(T, cols - rows - 1).abs().max())
        else:                                            # lower L
            tri = float(torch.triu(T, 1 + max(cols - rows, 0) if name == "ql" else 1)
                        .abs().max())
        res = float((M - X @ Y).norm() / M.norm())
        G = O.T @ O if name == "ql" else O @ O.T
        orth = float((G - eye).norm())
        say(f"{name} {tuple(M.shape)} f64: {tuple(X.shape)} @ {tuple(Y.shape)}, triangle "
            f"{tri:g}, residual {res:.3e} (< {n * eps:.3e}), orthogonality {orth:.3e} "
            f"(< {4 * n * eps:.3e})")
        if not (tri == 0.0 and res < n * eps and orth < 4 * n * eps):
            raise AssertionError(f"{name} fails its checks")
    Q, _ = ct.qr(A, cfg)
    for mode, transpose, shape in (("left", False, (n, p)), ("left", True, (m, p)),
                                   ("right", False, (p, m)), ("right", True, (p, n))):
        C = torch.from_numpy(rng.standard_normal(shape)).to(dev)
        out, _ = ct.qr_multiply(A, C, mode=mode, transpose=transpose, config=cfg)
        Qop = Q.T if transpose else Q
        want = Qop @ C if mode == "left" else C @ Qop
        err = rel_err(out, want)
        say(f"qr_multiply {mode} transpose={transpose} C {shape}: rel err vs Q from qr "
            f"{err:.2e} (< {TOL64:g})")
        if not err < TOL64:
            raise AssertionError(f"qr_multiply {mode}/{transpose} disagrees with Q from qr")
    torch.cuda.synchronize()
    say(f"decomp phase: {time.perf_counter() - t0:.3f} s")


def phase_update(torch, np, ct, dev, smi):
    """Givens-chain updates of an 8192 x 1024 float32 thin QR, each checked
    on the modified A, run with CUDA's sync debug mode set to raise (no
    host sync in a chain), and timed beside a refactor."""
    from cuda_qr_tpu_torch.models import scipy_compat as sc
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    m, n, k = N_UPDATE
    rng = np.random.default_rng(17)
    cfg = ct.DEFAULT_CONFIG

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    A = t(m, n)
    Q, R = ct.qr(A, cfg)
    u1, v1, U4, V4, row, col = t(m), t(n), t(m, 4), t(n, 4), t(n), t(m)
    cases = (
        ("qr_update rank 1", lambda: sc.qr_update(Q, R, u1, v1), A + torch.outer(u1, v1)),
        ("qr_update rank 4", lambda: sc.qr_update(Q, R, U4, V4), A + U4 @ V4.T),
        ("qr_insert row", lambda: sc.qr_insert(Q, R, row, k, which="row"),
         torch.cat([A[:k], row[None], A[k:]])),
        ("qr_insert col", lambda: sc.qr_insert(Q, R, col, k, which="col"),
         torch.cat([A[:, :k], col[:, None], A[:, k:]], 1)),
        ("qr_delete row", lambda: sc.qr_delete(Q, R, k, which="row"),
         torch.cat([A[:k], A[k + 1:]])),
        ("qr_delete col", lambda: sc.qr_delete(Q, R, k, which="col"),
         torch.cat([A[:, :k], A[:, k + 1:]], 1)),
    )
    say(f"update timings on {smi}:")
    for name, fn, A1 in cases:
        reset_counts(torch)
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")   # any synchronizing op raises
        try:
            Q1, R1 = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = read_counts()["host_syncs"]
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        chk = ct.check_qr_device(A1, Q1, R1)
        t_upd = cuda_time_ms(fn, reps=1, warmup=0)
        t_ref = cuda_time_ms(lambda: ct.qr(A1, cfg), reps=2, warmup=1)
        say(f"  {name}: residual {chk.residual:.3e}, orthogonality {chk.orthogonality:.3e} "
            f"= {chk.orthogonality / chk.eps:.1f} eps, ok={chk.ok}, host syncs {syncs}; "
            f"{t_upd:.2f} ms ({t_first:.3f} s first call) vs refactor qr {tuple(A1.shape)} "
            f"{t_ref:.2f} ms")
        if not (chk.ok and syncs == 0):
            raise AssertionError(f"{name} fails its gates or took a host sync")


def phase_orgqr_groups(torch, np, ct, dev):
    """Panel groups as the reference's default stages form them (fault C5):
    float32 qr_blocked + orgqr at 512^2 (k = 4) and 1024^2 (k = 8) on
    cholqr2_bk (B1) and geqrt (B2) panels.  Q is formed at the default
    apply_aggregate, at 1 (no merge), and in the groups the port formed
    before C5's repair (chunks of apply_aggregate panels: scan_stages=1).
    At k = 4 the default's groups are single panels, so its Q must equal
    the unmerged one: bit for bit when orgqr repeats bit for bit on the
    card, else within 2 eps ||Q||_F.  At k = 8 they are pairs: Q must equal
    the one formed with apply_aggregate=2 the same way, and be no less
    orthogonal than the old chunks' Q.  The default's orthogonality over
    the unmerged one's is printed: merging a pair costs that much in the
    reference's grouping too.  Returns this path's counts."""
    total = {}
    eps = float(torch.finfo(torch.float32).eps)
    for n in N_ORGQR_GROUPS:
        A = torch.from_numpy(np.random.default_rng(70).standard_normal(
            (n, n), dtype=np.float32)).to(dev)
        for method in ("cholqr2_bk", "geqrt"):
            cfg = ct.DEFAULT_CONFIG.replace(panel_method=method)
            k = n // cfg.panel_width
            fac, c, _ = run_counted(torch, lambda: ct.qr_blocked(A, cfg))
            add_counts(total, c)
            R = ct.extract_r(fac, n)
            Q = ct.orgqr(fac, n, n, cfg)
            same = cfg.replace(apply_aggregate=1 if k == 4 else 2)
            forms = {"default": Q, "apply_aggregate 1": ct.orgqr(fac, n, n, cfg.replace(
                apply_aggregate=1)), "old chunks": ct.orgqr(fac, n, n, cfg.replace(
                    scan_stages=1))}
            chk = {name: ct.check_qr_device(A, Qf, R) for name, Qf in forms.items()}
            say(f"orgqr groups {n}^2 f32 {method} (k = {k}), orthogonality / residual in eps: "
                + "; ".join(f"{name} {x.orthogonality / eps:.2f} / {x.residual / eps:.3f}"
                            for name, x in chk.items()) + f"; {counts_str(c)}")
            repeats = torch.equal(Q, ct.orgqr(fac, n, n, cfg))
            Qs = ct.orgqr(fac, n, n, same)
            diff = float((Q.double() - Qs.double()).norm())
            limit = 2 * eps * float(Q.double().norm())
            ratio = chk["default"].orthogonality / chk["apply_aggregate 1"].orthogonality
            say(f"  orgqr repeats bit for bit: {repeats}; default Q equals apply_aggregate "
                f"{same.apply_aggregate}'s: {torch.equal(Q, Qs)}, ||difference||_F {diff:.3e} "
                f"(2 eps ||Q||_F {limit:.3e}); default / apply_aggregate 1 orthogonality "
                f"{ratio:.3f}")
            require(torch.equal(Q, Qs) if repeats else diff <= limit,
                    f"orgqr groups {n}^2 {method}: default Q differs from apply_aggregate "
                    f"{same.apply_aggregate}'s")
            require(chk["default"].orthogonality <= chk["old chunks"].orthogonality,
                    f"orgqr groups {n}^2 {method}: default Q less orthogonal than the old "
                    f"chunks'")
            gate(f"orgqr groups {n}^2 f32 {method}", chk["default"])
    require(total["chol_inv"] > 0 and total["geqrt"] > 0,
            f"orgqr groups launched no chol_inv or geqrt kernel: {total}")
    return total


def mixed_gemms(torch, dev, smi):
    """"highest", "tf32" and "high" (3xTF32) at MIXED_GEMMS: normwise error
    ||C - C64||_F / (||A||_F ||B||_F) against a float64 product on the card,
    CUDA-event time and TFLOP/s; beside them the one-call form of 3xTF32
    (operands concatenated along K), the split of the K x n operand, and
    the accumulation alone: hi_a hi_b (exact in TF32) as one TF32 product,
    in K_CHUNK-deep chunks (what "high" runs) and in float32, with the mean
    relative error of one TF32 product on positive operands (its bias)."""
    from cuda_qr_tpu_torch.ops.gemm import K_CHUNK, _tf32_chunked, _tf32_product, gemm, split_tf32
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms

    def concatenated(a, b):
        hi_a, lo_a = split_tf32(a)
        hi_b, lo_b = split_tf32(b)
        return _tf32_product(torch.cat([hi_a, lo_a, hi_a], 1), torch.cat([lo_b, hi_b, hi_b], 0))

    g = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, m, k, n in MIXED_GEMMS:
        A = torch.randn(m, k, generator=g, device=dev)
        B = torch.randn(k, n, generator=g, device=dev)
        C64 = A.double() @ B.double()
        scale = float(A.double().norm() * B.double().norm())
        fns = {p: (lambda p=p: gemm(A, B, p)) for p in ("highest", "tf32", "high")}
        fns["high, one call on K-concatenated operands"] = lambda: concatenated(A, B)
        err, ms = {}, {}
        for p, fn in fns.items():
            err[p] = float((fn().double() - C64).norm()) / scale
            ms[p] = cuda_time_ms(fn, reps=10, warmup=2)
            say(f"  gemm {name} ({m} x {k} by {k} x {n}) '{p}': error {err[p]:.3e}, "
                f"{ms[p]:.4f} ms, {2 * m * k * n / ms[p] / 1e9:.1f} TFLOP/s ({smi})")
        t_split = cuda_time_ms(lambda: split_tf32(B), reps=10, warmup=2)
        hA, hB = split_tf32(A)[0], split_tf32(B)[0]
        H64 = hA.double() @ hB.double()
        hscale = float(hA.double().norm() * hB.double().norm())
        acc = {"one TF32 product": _tf32_product(hA, hB),
               f"chunks of {K_CHUNK}": _tf32_chunked(hA, hB), "float32": gemm(hA, hB, "highest")}
        say(f"  gemm {name}: hi_a hi_b (exact in TF32) summed as " + ", ".join(
            f"{key} {float((c.double() - H64).norm()) / hscale:.3e}" for key, c in acc.items()))
        del hA, hB, H64, acc
        say(f"  gemm {name}: 'high' / 'highest' error {err['high'] / err['highest']:.3f} "
            f"(<= {MIXED_GEMM_HIGHEST}), 'tf32' / 'high' {err['tf32'] / err['high']:.1f} (>= "
            f"{MIXED_GEMM_TF32}), 'tf32' / 'highest' {err['tf32'] / err['highest']:.1f} (>= "
            f"{MIXED_GEMM_TF32_ON}); time 'high' / 'highest' {ms['high'] / ms['highest']:.3f}; "
            f"split_tf32 of the {k} x {n} operand {t_split:.4f} ms")
        require(err["high"] <= MIXED_GEMM_HIGHEST * err["highest"],
                f"gemm {name}: 'high' error {err['high']} over {MIXED_GEMM_HIGHEST}x "
                f"'highest''s {err['highest']}")
        require(err["high"] <= err["tf32"] / MIXED_GEMM_TF32,
                f"gemm {name}: 'high' error {err['high']} not under 'tf32''s {err['tf32']} / "
                f"{MIXED_GEMM_TF32}")
        require(err["tf32"] >= MIXED_GEMM_TF32_ON * err["highest"],
                f"gemm {name}: 'tf32' error {err['tf32']} not {MIXED_GEMM_TF32_ON}x 'highest''s "
                f"{err['highest']}: was TF32 on?")
        rows.append({"gemm": name, "shape": [m, k, n], "error": err, "ms": ms,
                     "split_ms": t_split})
        del A, B, C64
    # the sign of one TF32 product's accumulation error (positive operands)
    m, k, n = MIXED_GEMMS[0][1:]
    hA = split_tf32(torch.rand(m, k, generator=g, device=dev))[0]
    hB = split_tf32(torch.rand(k, n, generator=g, device=dev))[0]
    H64 = hA.double() @ hB.double()
    bias = {key: float(((c.double() - H64) / H64).mean()) for key, c in (
        ("one TF32 product", _tf32_product(hA, hB)), (f"chunks of {K_CHUNK}", _tf32_chunked(hA, hB)),
        ("float32", gemm(hA, hB, "highest")))}
    say(f"  gemm {m} x {k} by {k} x {n}, positive operands exact in TF32: mean relative error "
        + ", ".join(f"{key} {v:.3e}" for key, v in bias.items()))
    return rows


def mixed_factor_ladder(torch, np, ct, dev, smi, sizes):
    """qr_blocked + orgqr + check_qr_device of default_rng(12) float32 at
    each n of ``sizes``, at DEFAULT_CONFIG, trailing "tf32" and
    MIXED_CONFIG: residual, orthogonality, factor ms (CUDA events); MIXED
    gated, "tf32" printed."""
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    configs = (("DEFAULT", ct.DEFAULT_CONFIG),
               ("trailing 'tf32'", ct.QRConfig(trailing_precision="tf32")),
               ("MIXED (3xTF32)", ct.MIXED_CONFIG))
    out = {}
    for n in sizes:
        A = torch.from_numpy(np.random.default_rng(12).standard_normal(
            (n, n), dtype=np.float32)).to(dev)
        chks = {}
        for name, cfg in configs:
            t = cuda_time_ms(lambda: ct.qr_blocked(A, cfg), reps=1, warmup=1 if n <= 8192 else 0)
            f = ct.qr_blocked(A, cfg)
            chk = chks[name] = ct.check_qr_device(A, ct.orgqr(f, n, n, cfg), ct.extract_r(f, n))
            del f
            say(f"  factor {n}^2 f32 {name}: residual {chk.residual:.3e} (n eps {n * chk.eps:.3e}),"
                f" orthogonality {chk.orthogonality:.3e}; factor {t:.2f} ms ({smi})")
            out[(n, name)] = {"residual": chk.residual, "orthogonality": chk.orthogonality,
                              "factor_ms": t}
        d, m = chks["DEFAULT"], chks["MIXED (3xTF32)"]
        say(f"  factor {n}^2: MIXED residual {m.residual:.3e} (< n eps / {MIXED_RESID_DIV} = "
            f"{n * m.eps / MIXED_RESID_DIV:.3e}), {m.residual / d.residual:.3f}x DEFAULT's; "
            f"orthogonality {m.orthogonality / d.orthogonality:.3f}x DEFAULT's (<= "
            f"{MIXED_ORTH_RATIO}); trailing 'tf32' residual {chks[configs[1][0]].residual:.3e}")
        require(m.ok and m.residual < n * m.eps / MIXED_RESID_DIV,
                f"MIXED {n}^2: residual {m.residual} not under n eps / {MIXED_RESID_DIV}")
        require(m.orthogonality <= MIXED_ORTH_RATIO * d.orthogonality,
                f"MIXED {n}^2: orthogonality {m.orthogonality} over {MIXED_ORTH_RATIO}x "
                f"DEFAULT's {d.orthogonality}")
        del A
    return out


def mixed_unchunked(torch, np, ct, dev, smi):
    """The first design of "high", hi_a hi_b as ONE TF32 product (no
    K-chunks), printed beside the chunked one, ungated: the 8192^2 factor
    and the cholqr2 tsqr at 1,048,576 x 128, at MIXED_CONFIG."""
    from cuda_qr_tpu_torch.ops import gemm as gemm_mod
    n = N_MAIN
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    T = torch.from_numpy(np.random.default_rng(12).standard_normal(
        N_TSQR, dtype=np.float32)).to(dev)
    tcfg = ct.MIXED_CONFIG.replace(tsqr_leaf="cholqr2")
    chunked = gemm_mod._tf32_chunked
    for label, fn in (("in K-chunks", chunked), ("as one TF32 product", gemm_mod._tf32_product)):
        gemm_mod._tf32_chunked = fn
        try:
            f = ct.qr_blocked(A, ct.MIXED_CONFIG)
            chk = ct.check_qr_device(A, ct.orgqr(f, n, n, ct.MIXED_CONFIG), ct.extract_r(f, n))
            del f
            tchk = ct.check_qr_device(T, *ct.tsqr(T, tcfg))
        finally:
            gemm_mod._tf32_chunked = chunked
        say(f"  MIXED, hi_a hi_b {label}: factor {n}^2 residual {chk.residual:.3e}, "
            f"orthogonality {chk.orthogonality:.3e}; cholqr2 tsqr {N_TSQR[0]} x {N_TSQR[1]} "
            f"residual {tchk.residual:.3e}, orthogonality {tchk.orthogonality:.3e} ({smi})")
    del A, T


def mixed_cli(smi):
    """``--mixed factor 4096 4096`` (record ok), and the cholqr2 ``tsqr`` at
    1,048,576 x 128 without and with ``--mixed`` (MIXED's residual within
    MIXED_TSQR_RATIO x DEFAULT's), through ``cli.main`` in process."""
    import contextlib
    import io
    from cuda_qr_tpu_torch import cli
    recs = {}
    for key, argv in (("factor", MIXED_CLI_FACTOR), ("tsqr", MIXED_CLI_TSQR),
                      ("tsqr --mixed", ["--mixed", *MIXED_CLI_TSQR])):
        argv = ["--trials", str(CLI_TRIALS), *argv]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        rec = recs[key] = json.loads(buf.getvalue().strip().splitlines()[-1])
        say(f"  cli {' '.join(argv)}: rc {rc}, {json.dumps(rec)} ({smi})")
        require(rc == 0 and rec.get("ok") is True, f"cli {argv}: rc {rc}, record {rec}")
    d, m = recs["tsqr"]["residual"], recs["tsqr --mixed"]["residual"]
    say(f"  cholqr2 tsqr: MIXED residual {m:.3e}, {m / d:.3f}x DEFAULT's {d:.3e} (<= "
        f"{MIXED_TSQR_RATIO})")
    require(m <= MIXED_TSQR_RATIO * d,
            f"MIXED cholqr2 tsqr residual {m} over {MIXED_TSQR_RATIO}x DEFAULT's {d}")
    return recs


def phase_mixed_precision(torch, np, ct, dev, smi, sizes=N_MIXED):
    """MIXED_CONFIG, the trailing update in 3xTF32 (fault C9): the GEMMs at
    the trailing shapes, the factor ladder, the command line.  Returns this
    path's counts (set to 0 at its start)."""
    reset_counts(torch)
    say(f"MIXED_CONFIG: trailing precision {ct.MIXED_CONFIG.trailing_precision!r} (3xTF32):")
    mixed_gemms(torch, dev, smi)
    mixed_factor_ladder(torch, np, ct, dev, smi, sizes)
    mixed_unchunked(torch, np, ct, dev, smi)
    mixed_cli(smi)
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["chol_inv"] > 0, f"MIXED phase launched no chol_inv kernel: {counts}")
    return counts


def factor_timings(torch, ct, A):
    """The n^2 float32 factor at DEFAULT_CONFIG: (factor ms, its host syncs,
    factor + orgqr ms)."""
    from cuda_qr_tpu_torch.ops import smalllinalg
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    cfg, n = ct.DEFAULT_CONFIG, A.shape[0]
    t_fac = cuda_time_ms(lambda: ct.qr_blocked(A, cfg), reps=3, warmup=1)
    smalllinalg.host_syncs = 0
    ct.qr_blocked(A, cfg)
    syncs = smalllinalg.host_syncs

    def factor_and_q():
        f = ct.qr_blocked(A, cfg)
        return ct.orgqr(f, n, n, cfg), ct.extract_r(f, n)

    return t_fac, syncs, cuda_time_ms(factor_and_q, reps=3, warmup=1)


def phase_factor(torch, np, ct, dev, smi):
    """The main path's factor alone, for comparing two checkouts on one card:
    qr of the N_MAIN^2 float32 input (launches, host syncs, gates), then the
    factor's and factor + orgqr's times.  Uses only what every checkout of
    the port has."""
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_MAIN, N_MAIN), dtype=np.float32)).to(dev)
    (Q, R), c, sec = run_counted(torch, lambda: ct.qr(A))
    say(f"factor phase ({HERE.name}): qr {N_MAIN}^2 f32: {sec:.3f} s first call; "
        f"{counts_str(c)}")
    gate(f"qr {N_MAIN}^2 f32", ct.check_qr_device(A, Q, R))
    del Q, R
    t_fac, syncs, t_qr = factor_timings(torch, ct, A)
    say(f"factor phase ({HERE.name}) on {smi}: factor {N_MAIN}^2 f32 {t_fac:.2f} ms, "
        f"{syncs} host syncs; factor + orgqr {t_qr:.2f} ms")


def event_call_ms(torch, fn) -> float:
    """Device ms of one call of ``fn`` between its own CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def phase_stages(torch, np, ct, dev, smi):
    """The reference's panel-grouping ladder on phase_factor's N_MAIN^2
    float32 input at DEFAULT_CONFIG's precisions: for each row of
    STAGE_LADDER, its B1 launches (one a panel at least) and host syncs,
    the gates, factor + orgqr ms, and the factor's median and min-max ms
    over STAGE_REPS calls after one warm-up, timed in rounds that take every
    row in turn (the host's speed drifts within a call), and the mean of
    STAGE_REPS chained calls between one event pair (``cuda_time_ms``, the
    CLI's and the headline's timer); then the command line's
    ``--stage-schedule`` factor.  Times are printed, not gated.
    Returns this path's counts."""
    import contextlib
    import io
    import statistics
    from cuda_qr_tpu_torch import cli
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms, qr_flops
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_MAIN, N_MAIN), dtype=np.float32)).to(dev)
    panels = N_MAIN // ct.DEFAULT_CONFIG.panel_width
    total, rows, factors = {}, [], []
    for name, knobs in STAGE_LADDER:
        cfg = ct.DEFAULT_CONFIG.replace(**knobs)
        fac, c, _ = run_counted(torch, lambda: ct.qr_blocked(A, cfg))
        add_counts(total, c)
        Q, R = ct.orgqr(fac, N_MAIN, N_MAIN, cfg), ct.extract_r(fac, N_MAIN)
        del fac
        chk = ct.check_qr_device(A, Q, R)
        del Q, R

        def factor_and_q():
            f = ct.qr_blocked(A, cfg)
            return ct.orgqr(f, N_MAIN, N_MAIN, cfg), ct.extract_r(f, N_MAIN)

        t_qr = cuda_time_ms(factor_and_q, reps=3, warmup=1)
        say(f"  {name} {knobs}: factor + orgqr {t_qr:.3f} ms; {counts_str(c)} ({smi})")
        gate(f"  {name} {N_MAIN}^2 f32", chk)
        require(c["chol_inv"] >= panels,
                f"{name}: chol_inv launched {c['chol_inv']} times, expected >= {panels}")
        rows.append({"name": name, **{k: v for k, v in knobs.items() if k != "stage_schedule"},
                     "chol_inv": c["chol_inv"], "host_syncs": c["host_syncs"],
                     "factor_orgqr_ms": round(t_qr, 3), "residual": chk.residual,
                     "orthogonality": chk.orthogonality})
        factors.append(lambda cfg=cfg: ct.qr_blocked(A, cfg))
    times = [[] for _ in factors]
    for fn in factors:                        # the warm-up
        event_call_ms(torch, fn)
    for r in range(STAGE_REPS):
        for i in range(len(factors)):
            j = (i + r) % len(factors)        # each round starts one row later
            times[j].append(event_call_ms(torch, factors[j]))
    for row, t, fn in zip(rows, times, factors):
        med = statistics.median(t)
        chained = cuda_time_ms(fn, reps=STAGE_REPS, warmup=0)
        row.update(factor_ms_median=round(med, 3), factor_ms_min=round(min(t), 3),
                   factor_ms_max=round(max(t), 3), factor_ms_chained=round(chained, 3),
                   gflops=round(qr_flops(N_MAIN, N_MAIN) / med / 1e6, 1))
        say(f"  {row['name']}: factor {N_MAIN}^2 f32 median {med:.3f} ms (min {min(t):.3f}, "
            f"max {max(t):.3f}, {STAGE_REPS} calls), {row['gflops']} GFLOP/s; "
            f"{STAGE_REPS} chained calls between one event pair {chained:.3f} ms a call ({smi})")
    say(f"stages ladder on {smi}: {json.dumps(rows)}")
    argv = ["--trials", str(CLI_TRIALS), *STAGES_CLI]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, c, sec = run_counted(torch, lambda: cli.main(argv))
    add_counts(total, c)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    say(f"  cli {' '.join(argv)}: rc {rc}, {json.dumps(rec)}; {counts_str(c)}; {sec:.3f} s "
        f"({smi})")
    require(rc == 0 and rec.get("ok") is True, f"cli {argv}: rc {rc}, record {rec}")
    require(c["chol_inv"] > 0, f"cli {argv} launched no chol_inv kernel")
    return total


def phase_rsvd(torch, np, ct, cfg, dev, smi):
    """The randomized tools on known spectra: rsvd 65,536 x 4,096, eigh_rand
    8,192^2, norm2_est / cond_est, and orth(rcond) on phase_rank's rank-1536
    input.  Returns this path's counts."""
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    eps = float(torch.finfo(torch.float32).eps)
    total = {}
    m, n, k, p, it = N_RSVD
    sig = DECAY ** torch.arange(n, dtype=torch.float64, device=dev)
    A = ((haar(torch, m, n, 30, dev) * sig) @ haar(torch, n, n, 31, dev).T).float()
    (U, s, Vt), c, sec = run_counted(torch, lambda: ct.rsvd(A, k, p, it, config=cfg))
    add_counts(total, c)
    E = A.double() - (U.double() * s.double()) @ Vt.double()
    err2 = float(torch.linalg.eigvalsh(E.T @ E)[-1].clamp_min(0).sqrt())
    del E
    tail = float(sig[k])
    s_err = float(((s.double() - sig[:k]).abs() / (1e-3 * sig[:k] + 50 * eps)).max())
    ou, ov = orth_defect(torch, U), orth_defect(torch, Vt.T)
    say(f"rsvd {m}x{n} f32 k={k} p={p} n_iter={it}: ||A - U S V^T||_2 {err2:.3e} (< 3 sigma_"
        f"{k + 1} = {3 * tail:.3e}), max |s - sigma| / (1e-3 sigma + 50 eps) {s_err:.3f} (< 1), "
        f"||U^T U - I|| {ou:.3e}, ||V V^T - I|| {ov:.3e} (< {16 * (k + p) * eps:.3e}); "
        f"{sec:.3f} s first call, {counts_str(c)}")
    require(err2 < 3 * tail and s_err < 1 and max(ou, ov) < 16 * (k + p) * eps,
            "rsvd fails its gates")
    require(c["geqrt_batched"] > 0, "rsvd's thin QRs launched no batched geqrt kernel")
    t_rsvd = cuda_time_ms(lambda: ct.rsvd(A, k, p, it, config=cfg), reps=3, warmup=1)
    t_low = cuda_time_ms(lambda: torch.svd_lowrank(A, q=k + p, niter=it), reps=3, warmup=1)
    (est, c, _) = run_counted(torch, lambda: float(ct.norm2_est(A, config=cfg)))
    add_counts(total, c)
    say(f"norm2_est of the same matrix (sigma_max 1): {est:.6f} (in [0.95, 1.0001])")
    require(0.95 <= est <= 1.0001, "norm2_est is no lower bound near sigma_max")
    del A, U, Vt

    mc, nc, cond = N_COND
    sc = torch.from_numpy(np.geomspace(1.0, 1.0 / cond, nc)).to(dev)
    Ac = ((haar(torch, mc, nc, 32, dev) * sc) @ haar(torch, nc, nc, 33, dev).T).float()
    (got, c, sec) = run_counted(torch, lambda: (float(ct.norm2_est(Ac, config=cfg)),
                                                float(ct.cond_est(Ac, config=cfg))))
    add_counts(total, c)
    say(f"norm2_est / cond_est {mc}x{nc} f32, sigma in [1/{cond:g}, 1]: norm {got[0]:.6f} "
        f"(in [0.95, 1.0001]), cond {got[1]:.2f} (in [{0.8 * cond:g}, {1.05 * cond:g}]); "
        f"{sec:.3f} s, {counts_str(c)}")
    require(0.95 <= got[0] <= 1.0001 and 0.8 * cond <= got[1] <= 1.05 * cond,
            "norm2_est / cond_est miss the known spectrum")
    del Ac

    ne, ke, pe, ite = N_EIGH_RAND
    w_true = (DECAY ** torch.arange(ne, dtype=torch.float64, device=dev)
              * (1 - 2 * (torch.arange(ne, device=dev) % 2)))
    Ve = haar(torch, ne, ne, 34, dev)
    S = (Ve * w_true) @ Ve.T
    S = ((S + S.T) * 0.5).float()
    del Ve
    ((w, V), c, sec) = run_counted(torch, lambda: ct.eigh_rand(S, ke, pe, ite, config=cfg))
    add_counts(total, c)
    E = S.double() - (V.double() * w.double()) @ V.double().T
    errf = float(E.norm())
    tailf = float(w_true[ke:].norm())
    del E
    w_err = float(((w.double() - w_true[:ke]).abs()
                   / (1e-3 * w_true[:ke].abs() + 50 * eps)).max())
    ov = orth_defect(torch, V)
    say(f"eigh_rand {ne}^2 f32 k={ke} p={pe} n_iter={ite}: ||S - V W V^T||_F {errf:.3e} "
        f"(< 1.5 x the tail's {tailf:.3e}), max |w - w_true| / (1e-3 |w| + 50 eps) "
        f"{w_err:.3f} (< 1), ||V^T V - I|| {ov:.3e} (< {16 * (ke + pe) * eps:.3e}); "
        f"{sec:.3f} s first call, {counts_str(c)}")
    require(errf < 1.5 * tailf and w_err < 1 and ov < 16 * (ke + pe) * eps,
            "eigh_rand fails its gates")
    del S, V

    mr, nr, r = N_RANK
    rng = np.random.default_rng(4)          # phase_rank's rank-r input
    B = torch.from_numpy(rng.standard_normal((mr, r))).to(dev)
    C = torch.from_numpy(rng.standard_normal((r, nr))).to(dev)
    Ar = (B @ C).float()
    del B, C
    (Q, c, sec) = run_counted(torch, lambda: ct.orth(Ar, rcond=1e-4, config=cfg))
    add_counts(total, c)
    oq = orth_defect(torch, Q)
    proj = float((Q.double() @ (Q.double().T @ Ar.double()) - Ar.double()).norm()
                 / Ar.double().norm())
    say(f"orth(rcond=1e-4) {mr}x{nr} rank {r}: {tuple(Q.shape)}, ||Q^T Q - I|| {oq:.3e} "
        f"(< {4 * nr * eps:.3e}), ||Q Q^T A - A||/||A|| {proj:.3e} (< {nr * eps:.3e}); "
        f"{sec:.3f} s, {counts_str(c)}")
    require(tuple(Q.shape) == (mr, r) and oq < 4 * nr * eps and proj < nr * eps,
            "orth(rcond) fails its gates")
    require(c["select_pivots"] > 0, "orth(rcond) launched no select_pivots kernel")
    say(f"rsvd timings on {smi}: rsvd {m}x{n} k={k} {t_rsvd:.2f} ms vs torch.svd_lowrank "
        f"(q={k + p}, niter={it}) {t_low:.2f} ms")
    return total


def polar_gates(torch, name, A, U, H):
    n = A.shape[1]
    eps = float(torch.finfo(torch.float32).eps)
    ou = orth_defect(torch, U)
    res = float((A.double() - U.double() @ H.double()).norm() / A.double().norm())
    asym = float((H - H.T).abs().max())
    ev = torch.linalg.eigvalsh(H.double())
    hn = float(ev.abs().max())
    say(f"{name}: ||U^T U - I|| {ou:.3e} (< {4 * n * eps:.3e}), ||A - U H||/||A|| {res:.3e} "
        f"(< {n * eps:.3e}), |H - H^T| {asym:g}, min eig(H) {float(ev[0]):.3e} "
        f"(>= {-n * eps * hn:.3e})")
    require(ou < 4 * n * eps and res < n * eps and asym == 0.0 and float(ev[0]) >= -n * eps * hn,
            f"{name} fails its gates")


def phase_chol_pad(torch, np, cfg, dev):
    """One QDWH Cholesky step at a side that is no multiple of 16: grown with
    an identity block onto the chol_inv kernel (the route every QDWH
    Cholesky step takes), against and beside the plain recursion at the
    exact size."""
    from cuda_qr_tpu_torch.models.polar import _chol_inv_padded
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.smalllinalg import cholesky_with_inv
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    n = N_CHOL_PAD
    B = torch.from_numpy(np.random.default_rng(43).standard_normal((n, 2 * n))).to(dev)
    Z = (torch.eye(n, device=dev, dtype=torch.float64) + B @ B.T / (2 * n)).float()
    before = chol_with_inv_kernel.launches
    L, Li = _chol_inv_padded(Z, cfg)
    launched = chol_with_inv_kernel.launches - before
    Lp, Lip = cholesky_with_inv(Z)
    torch.cuda.synchronize()
    eL, eLi = rel_err(L, Lp), rel_err(Li, Lip)
    t_k = cuda_time_ms(lambda: _chol_inv_padded(Z, cfg), reps=10)
    t_p = cuda_time_ms(lambda: cholesky_with_inv(Z), reps=3)
    say(f"QDWH Cholesky step {n}^2 f32: padded onto chol_inv ({launched} launch) vs the plain "
        f"recursion at {n}: rel err L {eL:.2e}, L^-1 {eLi:.2e} (tol {TOL32:g}); padded kernel "
        f"route {t_k:.4f} ms vs plain route {t_p:.4f} ms")
    require(launched == 1 and tuple(L.shape) == (n, n) and eL < TOL32 and eLi < TOL32,
            "the padded Cholesky step disagrees with the plain recursion")


def phase_polar(torch, np, ct, cfg, dev, smi):
    """QDWH polar at 16,384 x 512 (stacked QRs on the blocked route, Cholesky
    steps on the chol_inv kernel at 512) and 1,048,576 x 128 (stacked QRs on
    the TSQR route), then svd at 4,096^2 with both eigensolvers.  Returns
    this path's counts."""
    from cuda_qr_tpu_torch.models import eigh as eigh_mod
    from cuda_qr_tpu_torch.models.polar import _qdwh_schedule
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    eps = float(torch.finfo(torch.float32).eps)
    total = {}
    times = []
    phase_chol_pad(torch, np, cfg, dev)
    for (m, n), seed in zip(N_POLAR, (40, 41)):
        g = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn(m, n, generator=g, dtype=torch.float32, device=dev)
        sched = _qdwh_schedule(eps / 10.0 / (m * n) ** 0.25, eps)
        n_chol = sum(not st[3] for st in sched)
        ((U, H), c, sec) = run_counted(torch, lambda: ct.polar(A, config=cfg))
        add_counts(total, c)
        say(f"polar {m}x{n} f32: schedule {len(sched) - n_chol} QR + {n_chol} Cholesky steps; "
            f"{sec:.3f} s first call, {counts_str(c)}")
        polar_gates(torch, f"polar {m}x{n}", A, U, H)
        require(c["chol_inv"] >= n_chol >= 1,
                f"polar {m}x{n}: chol_inv launched {c['chol_inv']} times in {n_chol} "
                f"Cholesky steps")
        if n <= cfg.panel_width:
            require(c["geqrt_batched"] > 0, "polar's TSQR route launched no batched geqrt")
        del U, H
        times.append((m, n, cuda_time_ms(lambda: ct.polar(A, config=cfg), reps=2, warmup=0)))
        del A
    n = N_SVD
    g = torch.Generator(device=dev).manual_seed(42)
    A = torch.randn(n, n, generator=g, dtype=torch.float32, device=dev)
    s_ref = torch.linalg.svdvals(A.double())
    t_svd = {}
    for impl in ("torch", "qdwh"):
        ((U, s, Vh), c, sec) = run_counted(torch, lambda: ct.svd(A, config=cfg, eigh_impl=impl))
        add_counts(total, c)
        t_svd[impl] = sec
        res = float((A.double() - (U.double() * s.double()) @ Vh.double()).norm()
                    / A.double().norm())
        ou, ov = orth_defect(torch, U), orth_defect(torch, Vh.T)
        serr = float((s.double() - s_ref).abs().max() / s_ref[0])
        desc = bool((s[1:] <= s[:-1]).all())
        extra = f", eigh {eigh_mod.last_stats}" if impl == "qdwh" else ""
        say(f"svd {n}^2 f32 eigh_impl={impl}: residual {res:.3e} (< {n * eps:.3e}), "
            f"||U^T U - I|| {ou:.3e}, ||V V^T - I|| {ov:.3e} (< {16 * n * eps:.3e}), "
            f"max |s - svdvals64| / s_max {serr:.3e} (< {n * eps:.3e}), descending {desc}; "
            f"{sec:.3f} s first call, {counts_str(c)}{extra}")
        require(res < n * eps and max(ou, ov) < 16 * n * eps and serr < n * eps and desc,
                f"svd eigh_impl={impl} fails its gates")
        del U, s, Vh
    t0 = time.perf_counter()
    torch.linalg.svd(A)
    torch.cuda.synchronize()
    t_lib = time.perf_counter() - t0
    say(f"polar/svd timings on {smi}:")
    for m, n_, t in times:
        say(f"  polar {m}x{n_} f32: {t:.2f} ms")
    say(f"  svd {n}^2 f32: eigh_impl=torch {t_svd['torch'] * 1e3:.2f} ms, eigh_impl=qdwh "
        f"{t_svd['qdwh'] * 1e3:.2f} ms (first calls), torch.linalg.svd {t_lib * 1e3:.2f} ms")
    return total


def rotation_defect(torch, c, s, eps: float):
    """(c^2 + s^2 - 1) / eps with no rounding of its own worth counting: in
    float64, each square split into its rounded value and its exact error
    (Dekker's product; one torch op each, so nothing is fused)."""
    def square(a):
        p = a * a
        t = 134217729.0 * a                      # 2^27 + 1
        hi = t - (t - a)
        lo = a - hi
        return p, ((hi * hi - p) + 2.0 * hi * lo) + lo * lo
    (p1, e1), (p2, e2) = square(c.double()), square(s.double())
    return (((p1 - 1.0) + p2) + (e1 + e2)) / eps


def phase_rotation_bias(torch, dev):
    """The Jacobi rotation of models/eigh.py (``_rotation``) on CUDA tensors:
    mean and mean |.| of (c^2 + s^2 - 1) / eps over N_ROT_ANGLES seeded angles
    at each of ROT_SCALES, float32 and float64; |mean| <= ROT_BIAS_TOL.
    Beside it, ungated, the same angle with the reference's literal c =
    1/sqrt(1 + t^2) and with c = 1/hypot(1, t).  Then, ungated, the Givens
    rotation of models/update.py (``_givens``: c = a/r, s = -b/r, r =
    hypot(a, b)) at |b|/|a| of GIVENS_RATIOS."""
    from cuda_qr_tpu_torch.models.eigh import _rotation
    from cuda_qr_tpu_torch.models.update import _givens

    def other(tau, form):
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0, 1.0, t)
        r = torch.sqrt(1.0 + t * t) if form == "sqrt" else torch.hypot(torch.ones_like(t), t)
        c = 1.0 / r
        return c, t * c

    g = torch.Generator(device=dev).manual_seed(60)
    for dt, dname in ((torch.float32, "float32"), (torch.float64, "float64")):
        eps = float(torch.finfo(dt).eps)
        for scale in ROT_SCALES:
            u = torch.rand(N_ROT_ANGLES, generator=g, dtype=torch.float64, device=dev)
            sign = torch.where(torch.rand(N_ROT_ANGLES, generator=g, device=dev) < 0.5, -1.0, 1.0)
            tau = (sign * scale * 10.0 ** (u - 0.5)).to(dt)
            d = {name: rotation_defect(torch, *f(tau), eps) for name, f in (
                ("port", _rotation), ("sqrt", lambda x: other(x, "sqrt")),
                ("hypot", lambda x: other(x, "hypot")))}
            mean = {k: float(v.mean()) for k, v in d.items()}
            say(f"rotation {dname} |tau| ~ {scale:g}: (c^2 + s^2 - 1)/eps mean "
                f"{mean['port']:+.4f} (|.| <= {ROT_BIAS_TOL}), mean |.| "
                f"{float(d['port'].abs().mean()):.4f}; 1/sqrt(1 + t^2) {mean['sqrt']:+.4f} / "
                f"{float(d['sqrt'].abs().mean()):.4f}, 1/hypot(1, t) {mean['hypot']:+.4f} / "
                f"{float(d['hypot'].abs().mean()):.4f}")
            require(abs(mean["port"]) <= ROT_BIAS_TOL,
                    f"Jacobi rotation biased: {dname} |tau| ~ {scale:g}, mean "
                    f"{mean['port']:+.4f} eps")
        for ratio in GIVENS_RATIOS:
            # a of any sign over a decade; b of any sign, |b| ~ ratio |a|
            u = torch.rand(2, N_ROT_ANGLES, generator=g, dtype=torch.float64, device=dev)
            sign = torch.where(torch.rand(2, N_ROT_ANGLES, generator=g, device=dev) < 0.5,
                               -1.0, 1.0)
            a = (sign[0] * 10.0 ** (u[0] - 0.5)).to(dt)
            b = (sign[1] * ratio * a.double().abs() * 10.0 ** (u[1] - 0.5)).to(dt)
            c, s_, _ = _givens(a, b)
            d = rotation_defect(torch, c, s_, eps)
            say(f"givens {dname} |b|/|a| ~ {ratio:g}: (c^2 + s^2 - 1)/eps mean "
                f"{float(d.mean()):+.4f}, mean |.| {float(d.abs().mean()):.4f} (ungated; "
                f"C6 asks |mean| <= {ROT_BIAS_TOL})")


def eigh_gates(torch, name, A, w, V):
    """Residual < n eps, orthogonality < 4 n eps (the command line's gate,
    cli.py's cmd_eigh), eigenvalues within n eps max|w| of
    torch.linalg.eigvalsh in float64, ascending."""
    n = A.shape[0]
    eps = float(torch.finfo(torch.float32).eps)
    A64, V64, w64 = A.double(), V.double(), w.double()
    res = float((A64 @ V64 - V64 * w64).norm() / A64.norm())
    ov = orth_defect(torch, V)
    w_ref = torch.linalg.eigvalsh(A64)
    werr = float((w64 - w_ref).abs().max() / w_ref.abs().max().clamp_min(1.0))
    asc = bool((w[1:] >= w[:-1]).all())
    say(f"{name}: ||A V - V W||/||A|| {res:.3e} (< {n * eps:.3e}), ||V^T V - I|| {ov:.3e} "
        f"= {ov / eps:.1f} eps (< {4 * n * eps:.3e}), max |w - eigvalsh64| {werr:.3e} "
        f"(< {n * eps:.3e}), ascending {asc}")
    require(res < n * eps and ov < 4 * n * eps and werr < n * eps and asc,
            f"{name} fails its gates")


def phase_eigh(torch, np, ct, cfg, dev, smi):
    """QDWH-eig: eigh at 2,048^2 (Gaussian), a clustered spectrum at 512^2,
    eigh_batched on 4,096 x 64 x 64.  Returns this path's counts."""
    from cuda_qr_tpu_torch.models import eigh as eigh_mod
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    total = {}

    def drive(name, A):
        ((w, V), c, sec) = run_counted(torch, lambda: ct.eigh(A, cfg))
        add_counts(total, c)
        st = dict(eigh_mod.last_stats)
        say(f"{name}: {sec:.3f} s first call; split nodes {st['split_nodes']}, leaves "
            f"{st['leaves']}, diagonal exits {st['diag_exits']}, Jacobi fallbacks "
            f"{st['fallbacks']}, Jacobi sweeps {st['jacobi_sweeps']}; {counts_str(c)}")
        eigh_gates(torch, name, A, w, V)
        return sec, c

    n = N_EIGH
    g = torch.Generator(device=dev).manual_seed(50)
    G = torch.randn(n, n, generator=g, dtype=torch.float32, device=dev)
    S = (G + G.T) * 0.5
    sec_main, c_main = drive(f"eigh {n}^2 f32 Gaussian", S)
    require(c_main["chol_inv"] > 0, "eigh launched no chol_inv kernel")
    nt = n if sec_main < 60 else n // 2     # the timed repetition, at half the size if slow
    St = S[:nt, :nt].contiguous()
    t_eigh = cuda_time_ms(lambda: ct.eigh(St, cfg), reps=1, warmup=0)
    t_lib = cuda_time_ms(lambda: torch.linalg.eigh(St), reps=2, warmup=1)
    del S, G

    # repeated eigenvalues plus a tight cluster (tests/test_eigh.py:96-106, scaled up)
    nc = N_EIGH_CLUSTER
    third = nc // 3
    w_true = torch.cat([torch.full((third,), 1.0), torch.full((third,), 1.0 + 3e-3),
                        torch.linspace(2, 5, nc - 2 * third)]).double().to(dev)
    Qc = haar(torch, nc, nc, 51, dev)
    C = (Qc * w_true) @ Qc.T
    drive(f"eigh {nc}^2 f32 clustered", ((C + C.T) * 0.5).float())

    b, nb = N_EIGH_BATCHED
    g = torch.Generator(device=dev).manual_seed(52)
    As = torch.randn(b, nb, nb, generator=g, dtype=torch.float32, device=dev)
    As = (As + As.mT) * 0.5
    ((ws, Vs), c, sec) = run_counted(torch, lambda: ct.eigh_batched(As))
    add_counts(total, c)
    eps = float(torch.finfo(torch.float32).eps)
    A64, V64 = As.double(), Vs.double()
    res = float(((A64 @ V64 - V64 * ws.double()[:, None, :]).norm(dim=(1, 2))
                 / A64.norm(dim=(1, 2))).max())
    ov = float((V64.mT @ V64 - torch.eye(nb, dtype=torch.float64, device=dev))
               .norm(dim=(1, 2)).max())
    werr = float((ws.double() - torch.linalg.eigvalsh(A64)).abs().max())
    tol = 5e-6 * nb                     # tests/test_eigh.py's bound for the batched Jacobi
    say(f"eigh_batched {b} x {nb}x{nb} f32: max residual {res:.3e} (< {tol:.3e}), max "
        f"orthogonality {ov:.3e} = {ov / eps:.1f} eps (< {4 * nb * eps:.3e}), max |w - "
        f"eigvalsh64| {werr:.3e} (< {tol * float(ws.abs().max()):.3e}); Jacobi sweeps "
        f"{eigh_mod.last_stats['jacobi_sweeps']}, host syncs {c['host_syncs']}, {sec:.3f} s")
    require(res < tol and ov < 4 * nb * eps and werr < tol * float(ws.abs().max()),
            "eigh_batched fails its gates")
    t_b = cuda_time_ms(lambda: ct.eigh_batched(As), reps=1, warmup=0)
    t_bl = cuda_time_ms(lambda: torch.linalg.eigh(As), reps=2, warmup=1)
    say(f"eigh timings on {smi}:")
    say(f"  eigh {nt}^2 f32: {t_eigh:.2f} ms vs torch.linalg.eigh {t_lib:.2f} ms")
    say(f"  eigh_batched {b} x {nb}x{nb} f32: {t_b:.2f} ms vs batched torch.linalg.eigh "
        f"{t_bl:.2f} ms")
    return total


# ---- the distributed path: P ranks over torch.distributed ------------------
# Each rank body below runs in a process of its own (``run_ranks``): gloo with
# every rank on card 0 when there are more ranks than cards, NCCL with a card
# per rank otherwise.  Rank 0 prints each phase's line as it ends; every body
# returns, per phase, its launch counts (summed over ranks by the caller).


def d_timed(torch, fn):
    """(fn(), seconds on rank 0's clock from a barrier before to a barrier
    after every rank has finished)."""
    import torch.distributed as dist
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dist.barrier()
    return out, time.perf_counter() - t0


def wide(torch, x):
    """x in float64, or complex128 for complex x."""
    return x.to(torch.complex128 if x.is_complex() else torch.float64)


def d_norm(torch, x, mesh) -> float:
    """Frobenius norm of a row-sharded matrix (x this rank's rows), float64."""
    from cuda_qr_tpu_torch.parallel.collectives import psum
    return float(psum(wide(torch, x).abs().square().sum(), mesh).sqrt())


def d_orth(torch, Q, mesh, blk: int = 2048) -> float:
    """||Q^H Q - I||_F of a row-sharded Q, in float64, the Gram all-reduced
    one block of columns at a time."""
    from cuda_qr_tpu_torch.parallel.collectives import psum
    Q64 = wide(torch, Q)
    total = 0.0
    for c0 in range(0, Q.shape[1], blk):
        G = psum(Q64.mH @ Q64[:, c0:c0 + blk], mesh)
        G[c0:c0 + blk].diagonal().sub_(1.0)
        total += float(G.abs().square().sum())
        del G
    return total ** 0.5


def d_resid(torch, a, Q, R, mesh, blk: int = 2048) -> float:
    """||A - Q R||_F / ||A||_F of row-sharded A and Q, R replicated, in float64
    by blocks of columns."""
    from cuda_qr_tpu_torch.parallel.collectives import psum
    Q64 = wide(torch, Q)
    num = torch.zeros((), dtype=torch.float64, device=a.device)
    for c0 in range(0, R.shape[1], blk):
        num += (wide(torch, a[:, c0:c0 + blk]) - Q64 @ wide(torch, R[:, c0:c0 + blk])
                ).abs().square().sum()
    return float(psum(num, mesh).sqrt()) / d_norm(torch, a, mesh)


def d_qr_gates(torch, name, a, Q, R, mesh, width=None):
    """The residual / orthogonality / triangle gates of a distributed thin QR
    (n eps, 4 n eps, 0, with eps of float32); the values as a dict."""
    n = width or R.shape[1]
    eps = float(torch.finfo(torch.float32).eps)
    g = {"residual": d_resid(torch, a, Q, R, mesh), "orthogonality": d_orth(torch, Q, mesh),
         "tril": float(torch.tril(R, -1).abs().max()) if R.shape[0] > 1 else 0.0}
    require(g["residual"] < n * eps and g["orthogonality"] < 4 * n * eps and g["tril"] == 0.0,
            f"{name} fails the gates: {g}")
    return g


def r_err(torch, R, R1) -> float:
    """max |D R - D1 R1| / max |R1|, rows normalized to a positive diagonal."""
    def pos(X):
        d = torch.sign(torch.diagonal(X)).double()
        return X.double() * torch.where(d == 0, 1.0, d)[:, None]
    return float((pos(R) - pos(R1)).abs().max() / R1.double().abs().max())


def d_rows(torch, seed: int, i: int, mloc: int, n: int, dev, shift: float = 0.0,
           dtype=None):
    """Rank i's rows of a seeded Gaussian (block i from seed + i; float32
    unless ``dtype``), plus ``shift`` on the global diagonal: the full matrix
    is the blocks in order."""
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + i)
    a = torch.randn(mloc, n, generator=g, dtype=dtype or torch.float32, device=dev)
    if shift:
        r = torch.arange(mloc, device=dev)
        cols = r + i * mloc
        keep = cols < n
        a[r[keep], cols[keep]] += shift
    return a


def d_full(torch, seed, P, mloc, n, dev, shift=0.0, dtype=None):
    return torch.cat([d_rows(torch, seed, j, mloc, n, dev, shift, dtype) for j in range(P)])


def d_say(mesh, line: str) -> None:
    if mesh.get_local_rank(0) == 0:
        say(f"  [dist] {line}")


def on_rank0(torch, mesh, fn):
    """(fn(), seconds) on rank 0 only (None, 0.0 elsewhere): a single-device
    counterpart, run while the other ranks wait."""
    if mesh.get_local_rank(0):
        return None, 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dist_rank(mesh, smi: str, sizes: dict):
    """Rank body of the distributed phases at ``sizes``.  Each phase times
    only its distributed call (barrier to barrier), then checks the gates
    and the single-device function on the same input (rank 0, also timed).
    Returns {phase: this rank's launch counts of the call, its seconds, the
    operations that went through host memory}."""
    import torch
    import cuda_qr_tpu_torch as ct
    from cuda_qr_tpu_torch.parallel import collectives
    from cuda_qr_tpu_torch.parallel.caqr import caqr_factor, caqr_ormqr
    from cuda_qr_tpu_torch.parallel.collectives import gather_rows, psum
    from cuda_qr_tpu_torch.parallel.dryrun import crash_and_resume
    from cuda_qr_tpu_torch.parallel.mesh import as_row_sharded, mesh_device

    dev = mesh_device(mesh)
    P, i = mesh.size(0), mesh.get_local_rank(0)
    eps = float(torch.finfo(torch.float32).eps)
    cfg = ct.DEFAULT_CONFIG
    out = {}

    def phase(name, call, check):
        """Time call() with this rank's counts set to 0 just before and read
        just after; then check(result) gives the phase's line (rank 0
        prints it)."""
        reset_counts(torch)
        collectives.host_hops.clear()
        res, sec = d_timed(torch, call)
        out[name] = {"counts": read_counts(), "seconds": sec, "hops": dict(collectives.host_hops)}
        line = check(res)
        del res
        torch.cuda.empty_cache()   # the ranks share the card: give back what is free
        d_say(mesh, f"{line}; {sec:.3f} s (P={P} ranks on one card, {smi})")

    # -- tsqr_dist at BASELINE config 3, every strategy, then cholqr2 leaves
    m, n = sizes["tsqr"]
    mloc = m // P
    a = d_rows(torch, 14, i, mloc, n, dev)
    A = as_row_sharded(a, mesh, m)
    R1, t1 = on_rank0(torch, mesh, lambda: ct.tsqr(d_full(torch, 14, P, mloc, n, dev), cfg)[1])
    for strategy, leaf in (("allgather", "householder"), ("butterfly", "householder"),
                           ("cholesky", "householder"), ("allgather", "cholqr2")):
        def check(res, strategy=strategy, leaf=leaf):
            Q, R = res
            g = d_qr_gates(torch, f"tsqr_dist {strategy}/{leaf}", a, Q.to_local(), R, mesh)
            e = r_err(torch, R, R1) if i == 0 else 0.0
            require(e < DIST_TOL, f"tsqr_dist {strategy}/{leaf}: R vs tsqr's {e}")
            return (f"tsqr_dist {m}x{n} f32 {strategy}, {leaf} leaves: residual "
                    f"{g['residual']:.3e}, orthogonality {g['orthogonality']:.3e}, R vs "
                    f"single-device tsqr {e:.2e} (< {DIST_TOL:g}; tsqr {t1:.3f} s first call)")
        phase(f"tsqr_dist-{strategy}-{leaf}",
              lambda strategy=strategy, leaf=leaf: ct.tsqr_dist(
                  A, mesh, cfg.replace(tsqr_leaf=leaf), strategy=strategy), check)
    del a, A, R1

    # -- caqr at scale: bk combine, block layout (BASELINE config 5, cut)
    nc = sizes["caqr"]
    mloc = nc // P
    shift = 3.0 * nc ** 0.5        # Gaussian + 3 sqrt(n) I: cond <= 5
    a = d_rows(torch, 50, i, mloc, nc, dev, shift)

    def check_caqr(res):
        Q, R = res
        g = d_qr_gates(torch, f"caqr {nc}^2", a, Q.to_local(), R, mesh)
        del Q
        torch.cuda.empty_cache()
        R1, t1 = on_rank0(torch, mesh, lambda: ct.qr(d_full(torch, 50, P, mloc, nc, dev, shift),
                                                     cfg, mode="r"))
        e = r_err(torch, R, R1) if i == 0 else 0.0
        require(e < DIST_TOL, f"caqr {nc}^2: R vs qr's {e}")
        return (f"caqr {nc}^2 f32 bk block: residual {g['residual']:.3e} (< {nc * eps:.3e}), "
                f"orthogonality {g['orthogonality']:.3e} (< {4 * nc * eps:.3e}), R vs "
                f"single-device qr {e:.2e} (< {DIST_TOL:g}; qr mode='r' {t1:.3f} s)")
    phase("caqr", lambda: ct.caqr(as_row_sharded(a, mesh, nc), mesh, cfg), check_caqr)
    del a

    # -- the variants at 8192^2: combines, layouts, caqr_r, ormqr, resume
    nv = sizes["variants"]
    mloc = nv // P
    shift = 3.0 * nv ** 0.5
    a = d_rows(torch, 51, i, mloc, nv, dev, shift)
    A = as_row_sharded(a, mesh, nv)
    R1, t1 = on_rank0(torch, mesh, lambda: ct.qr(d_full(torch, 51, P, mloc, nv, dev, shift),
                                                 cfg, mode="r"))

    def vs_qr(name, R):
        e = r_err(torch, R, R1) if i == 0 else 0.0
        require(e < DIST_TOL, f"{name}: R vs qr's {e}")
        return f"R vs single-device qr {e:.2e} (< {DIST_TOL:g}; qr mode='r' {t1:.3f} s)"

    for layout, combine in (("block", "allgather"), ("cyclic", "bk")):
        def check(res, layout=layout, combine=combine):
            Q, R = res
            g = d_qr_gates(torch, f"caqr {combine} {layout}", a, Q.to_local(), R, mesh)
            return (f"caqr {nv}^2 f32 {combine} {layout}: residual {g['residual']:.3e}, "
                    f"orthogonality {g['orthogonality']:.3e}, {vs_qr(combine, R)}")
        phase(f"caqr-{combine}-{layout}",
              lambda layout=layout, combine=combine: ct.caqr(A, mesh, cfg, layout=layout,
                                                             combine=combine), check)
    phase("caqr_r", lambda: ct.caqr_r(A, mesh, cfg),
          lambda R: f"caqr_r {nv}^2 f32 bk: {vs_qr('caqr_r', R)}")
    anorm = d_norm(torch, a, mesh)
    lo, hi = i * mloc, (i + 1) * mloc
    for combine in ("bk", "allgather"):
        fac, R = caqr_factor(A, mesh, cfg, combine=combine)
        top = torch.zeros_like(a)
        top[:] = R[lo:hi]                  # [R; 0]: R fills every row of a square A

        def round_trip(fac=fac, top=top):
            QtA = caqr_ormqr(fac, A, mesh, cfg, transpose=True)
            return QtA, caqr_ormqr(fac, as_row_sharded(top, mesh, nv), mesh, cfg,
                                   transpose=False)

        def check(res, combine=combine, top=top):
            QtA, QR = res
            e_r = d_norm(torch, torch.triu(QtA.to_local(), lo) - top, mesh) / anorm
            e_a = d_norm(torch, QR.to_local() - a, mesh) / anorm
            require(e_r < nv * eps and e_a < nv * eps, f"ormqr {combine}: {e_r}, {e_a}")
            return (f"caqr_ormqr {nv}^2 {combine}, Q^T A then Q [R; 0]: ||Q^T A - R||/||A|| "
                    f"{e_r:.3e}, ||Q [R; 0] - A||/||A|| {e_a:.3e} (< {nv * eps:.3e})")
        phase(f"ormqr-{combine}", round_trip, check)
        del fac, R, top

    def check_resume(res):
        snaps, files, (_, R_r), (_, R_m) = res
        e = float((R_r - R_m).abs().max() / R_m.abs().max())
        require(snaps and snaps[-1] == 8 and len(files) == 8 and e < TOL32,
                f"resume: snapshots {snaps}, files {len(files)}, R diff {e}")
        return (f"caqr_factor_resumable {nv}^2 bk, crash after 8 panels (snapshots every 4), "
                f"resume, then caqr_factor: snapshot before panel {snaps[-1]}, {len(files)} "
                f"panel files on this rank, resumed R vs caqr_factor's {e:.1e}, "
                f"{vs_qr('resume', R_r)}")
    phase("resume", lambda: crash_and_resume(mesh, A, cfg, "block", "bk", crash_after=8,
                                             every=4, path=sizes["checkpoint_dir"]),
          check_resume)
    del a, A, R1

    # -- complex caqr: routed to the allgather combine with no kernel; the
    # bk combine rejected
    mc, ncx = sizes["complex"]
    mloc = mc // P
    a = d_rows(torch, 56, i, mloc, ncx, dev, dtype=torch.complex64)
    A = as_row_sharded(a, mesh, mc)
    try:
        caqr_factor(A, mesh, cfg.replace(dtype=torch.complex64), combine="bk")
    except ct.QRShapeError as exc:
        d_say(mesh, f"caqr_factor complex64 combine='bk' raises QRShapeError: {exc}")
    else:
        raise AssertionError("caqr_factor took a complex matrix with combine='bk'")

    def check_complex(res):
        Q, R = res
        g = d_qr_gates(torch, f"caqr {mc}x{ncx} complex64", a, Q.to_local(), R, mesh)
        R1, t1 = on_rank0(torch, mesh, lambda: ct.qr(
            d_full(torch, 56, P, mloc, ncx, dev, dtype=torch.complex64), cfg, mode="r"))
        e = 0.0
        if i == 0:
            d, d1 = R.diagonal().abs().double(), R1.diagonal().abs().double()
            e = float((d - d1).abs().max() / d1.max())
        require(e < DIST_TOL, f"complex caqr: |diag R| vs qr's {e}")
        return (f"caqr {mc}x{ncx} complex64 (allgather, routed): residual "
                f"{g['residual']:.3e}, orthogonality {g['orthogonality']:.3e}, |diag R| vs "
                f"single-device complex qr {e:.2e} (< {DIST_TOL:g}; qr mode='r' {t1:.3f} s)")
    phase("caqr-complex", lambda: ct.caqr(A, mesh, cfg), check_complex)
    require(all(v == 0 for k, v in out["caqr-complex"]["counts"].items() if k != "host_syncs"),
            f"complex caqr launched a kernel: {out['caqr-complex']['counts']}")
    del a, A

    # -- lstsq_dist at BASELINE config 4
    ml, nl = sizes["lstsq"]
    mloc = ml // P
    a = d_rows(torch, 52, i, mloc, nl, dev)
    b = d_rows(torch, 53, i, mloc, 1, dev)[:, 0]

    def check_lstsq(res):
        want, t1 = on_rank0(torch, mesh, lambda: ct.lstsq(
            d_full(torch, 52, P, mloc, nl, dev), d_full(torch, 53, P, mloc, 1, dev)[:, 0], cfg))
        ex = er = 0.0
        if i == 0:
            ex = float((res.x - want.x).norm() / want.x.norm())
            er = abs(float(res.residual_norm - want.residual_norm)) / float(want.residual_norm)
        require(ex < DIST_TOL and er < DIST_TOL, f"lstsq_dist vs lstsq: {ex}, {er}")
        return (f"lstsq_dist {ml}x{nl} f32: x vs single-device lstsq {ex:.3e}, residual norm "
                f"{er:.3e} (< {DIST_TOL:g}; lstsq {t1:.3f} s first call)")
    phase("lstsq_dist", lambda: ct.lstsq_dist(as_row_sharded(a, mesh, ml),
                                              as_row_sharded(b, mesh, ml), mesh, cfg),
          check_lstsq)
    del a, b

    # -- polar_dist and svd_dist
    mp, np_ = sizes["polar"]
    mloc = mp // P
    a = d_rows(torch, 54, i, mloc, np_, dev)
    A = as_row_sharded(a, mesh, mp)
    Af = d_full(torch, 54, P, mloc, np_, dev) if i == 0 else None

    def check_polar(res):
        U, H = res
        ou = d_orth(torch, U.to_local(), mesh)
        rel = d_norm(torch, a - U.to_local() @ H, mesh) / d_norm(torch, a, mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.polar(Af, config=cfg))
        eu = 0.0
        if i == 0:
            eu = max(float((U.to_local() - one[0][:mloc]).abs().max()),
                     float((H - one[1]).abs().max() / one[1].abs().max()))
        require(ou < 4 * np_ * eps and rel < np_ * eps and eu < DIST_TOL,
                f"polar_dist: {ou}, {rel}, {eu}")
        return (f"polar_dist {mp}x{np_} f32: ||U^T U - I|| {ou:.3e} (< {4 * np_ * eps:.3e}), "
                f"||A - U H||/||A|| {rel:.3e} (< {np_ * eps:.3e}), U, H vs single-device polar "
                f"{eu:.2e} (< {DIST_TOL:g}; polar {t1:.3f} s first call)")
    phase("polar_dist", lambda: ct.polar_dist(A, mesh, config=cfg), check_polar)

    def check_svd(res):
        U, s, Vh = res
        rel = d_norm(torch, a - (U.to_local() * s) @ Vh, mesh) / d_norm(torch, a, mesh)
        ou = d_orth(torch, U.to_local(), mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.svd(Af, config=cfg))
        es = float((s - one[1]).abs().max() / one[1][0]) if i == 0 else 0.0
        require(rel < np_ * eps and ou < 16 * np_ * eps and es < DIST_TOL,
                f"svd_dist: {rel}, {ou}, {es}")
        return (f"svd_dist {mp}x{np_} f32: residual {rel:.3e}, ||U^T U - I|| {ou:.3e}, s vs "
                f"single-device svd {es:.2e} (< {DIST_TOL:g}; svd {t1:.3f} s first call)")
    phase("svd_dist", lambda: ct.svd_dist(A, mesh, config=cfg), check_svd)
    del a, A, Af

    # -- rsvd_dist and eigh_rand_dist on known spectra (phase_rsvd's inputs)
    mr, nr, k, p, it = sizes["rsvd"]
    mloc = mr // P
    sig = DECAY ** torch.arange(nr, dtype=torch.float64, device=dev)
    Afull = ((haar(torch, mr, nr, 30, dev) * sig) @ haar(torch, nr, nr, 31, dev).T).float()
    a = Afull[i * mloc:(i + 1) * mloc].clone()
    if i:
        del Afull
        Afull = None

    def check_rsvd(res):
        U, s, Vt = res
        E = a.double() - (U.to_local().double() * s.double()) @ Vt.double()
        err2 = float(torch.linalg.eigvalsh(psum(E.T @ E, mesh))[-1].clamp_min(0).sqrt())
        es = float(((s.double() - sig[:k]).abs() / (1e-3 * sig[:k] + 50 * eps)).max())
        one, t1 = on_rank0(torch, mesh, lambda: ct.rsvd(Afull, k, p, it, config=cfg))
        e1 = float((s - one[1]).abs().max() / one[1][0]) if i == 0 else 0.0
        require(err2 < 3 * float(sig[k]) and es < 1 and e1 < DIST_TOL,
                f"rsvd_dist: {err2}, {es}, {e1}")
        return (f"rsvd_dist {mr}x{nr} k={k} p={p} n_iter={it}: ||A - U S V^T||_2 {err2:.3e} "
                f"(< 3 sigma_{k + 1} = {3 * float(sig[k]):.3e}), s vs sigma {es:.3f} (< 1), s vs "
                f"single-device rsvd {e1:.2e} (< {DIST_TOL:g}; rsvd {t1:.3f} s "
                f"first call)")
    phase("rsvd_dist", lambda: ct.rsvd_dist(as_row_sharded(a, mesh, mr), k, mesh, p, it,
                                            config=cfg), check_rsvd)
    del a, Afull

    ne, ke, pe, ite = sizes["eigh_rand"]
    mloc = ne // P
    w_true = (DECAY ** torch.arange(ne, dtype=torch.float64, device=dev)
              * (1 - 2 * (torch.arange(ne, device=dev) % 2)))
    Ve = haar(torch, ne, ne, 34, dev)
    S = (Ve * w_true) @ Ve.T
    S = ((S + S.T) * 0.5).float()
    del Ve
    s_loc = S[i * mloc:(i + 1) * mloc].clone()

    def check_eigh_rand(res):
        w, V = res
        V_all = gather_rows(V, mesh).double()
        errf = d_norm(torch, s_loc.double() - (V.to_local().double() * w.double()) @ V_all.T,
                      mesh)
        tailf = float(w_true[ke:].norm())
        we = float(((w.double() - w_true[:ke]).abs()
                    / (1e-3 * w_true[:ke].abs() + 50 * eps)).max())
        ov = d_orth(torch, V.to_local(), mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.eigh_rand(S, ke, pe, ite, config=cfg))
        e1 = float((w - one[0]).abs().max() / one[0].abs().max()) if i == 0 else 0.0
        require(errf < 1.5 * tailf and we < 1 and ov < 16 * (ke + pe) * eps
                and e1 < DIST_TOL, f"eigh_rand_dist: {errf}, {we}, {ov}, {e1}")
        return (f"eigh_rand_dist {ne}^2 k={ke} p={pe} n_iter={ite}: ||S - V W V^T||_F "
                f"{errf:.3e} (< 1.5 x the tail's {tailf:.3e}), w vs w_true {we:.3f} (< 1), "
                f"||V^T V - I|| {ov:.3e}, w vs single-device eigh_rand {e1:.2e} (< {DIST_TOL:g}; eigh_rand "
                f"{t1:.3f} s first call)")
    phase("eigh_rand_dist", lambda: ct.eigh_rand_dist(as_row_sharded(s_loc, mesh, ne), ke, mesh,
                                                      pe, ite, config=cfg), check_eigh_rand)
    del s_loc, S
    dist_complex_solvers(mesh, sizes, phase, out)
    return out


def dist_complex_solvers(mesh, sizes: dict, phase, out: dict) -> None:
    """The complex *_dist solvers (complex64) inside ``dist_rank``: Householder
    leaves and the allgather combine, all-reduced A^H Q, QR steps throughout
    QDWH; no kernel.  Each is held to the single-device complex function on
    the same input (rank 0) at DIST_TOL, and to zero launches."""
    import torch
    import cuda_qr_tpu_torch as ct
    from cuda_qr_tpu_torch.parallel.collectives import gather_rows, psum
    from cuda_qr_tpu_torch.parallel.mesh import as_row_sharded, mesh_device

    dev = mesh_device(mesh)
    P, i = mesh.size(0), mesh.get_local_rank(0)
    eps = float(torch.finfo(torch.float32).eps)
    cfg = ct.DEFAULT_CONFIG
    c64, c128 = torch.complex64, torch.complex128

    def no_kernel(name):
        c = out[name]["counts"]
        require(all(v == 0 for k, v in c.items() if k != "host_syncs"),
                f"{name} launched a kernel on complex input: {c}")

    # -- lstsq_dist
    ml, nl = sizes["cx_lstsq"]
    mloc = ml // P
    a = d_rows(torch, 62, i, mloc, nl, dev, dtype=c64)
    b = d_rows(torch, 63, i, mloc, 1, dev, dtype=c64)[:, 0]

    def check_lstsq(res):
        want, t1 = on_rank0(torch, mesh, lambda: ct.lstsq(
            d_full(torch, 62, P, mloc, nl, dev, dtype=c64),
            d_full(torch, 63, P, mloc, 1, dev, dtype=c64)[:, 0], cfg))
        ex = er = 0.0
        if i == 0:
            ex = float((res.x - want.x).norm() / want.x.norm())
            er = abs(float(res.residual_norm - want.residual_norm)) / float(want.residual_norm)
        require(ex < DIST_TOL and er < DIST_TOL and res.x.dtype == c64,
                f"complex lstsq_dist vs lstsq: {ex}, {er}")
        return (f"lstsq_dist {ml}x{nl} complex64: x vs single-device lstsq {ex:.3e}, residual "
                f"norm {er:.3e} (< {DIST_TOL:g}; lstsq {t1:.3f} s first call)")
    phase("lstsq_dist-complex", lambda: ct.lstsq_dist(as_row_sharded(a, mesh, ml),
                                                      as_row_sharded(b, mesh, ml), mesh, cfg),
          check_lstsq)
    no_kernel("lstsq_dist-complex")
    del a, b

    # -- polar_dist and svd_dist
    mp, np_ = sizes["cx_polar"]
    mloc = mp // P
    a = d_rows(torch, 64, i, mloc, np_, dev, dtype=c64)
    A = as_row_sharded(a, mesh, mp)
    Af = d_full(torch, 64, P, mloc, np_, dev, dtype=c64) if i == 0 else None

    def check_polar(res):
        U, H = res
        ou = d_orth(torch, U.to_local(), mesh)
        rel = d_norm(torch, a - U.to_local() @ H, mesh) / d_norm(torch, a, mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.polar(Af, config=cfg))
        eu = 0.0
        if i == 0:
            eu = max(float((U.to_local() - one[0][:mloc]).abs().max()),
                     float((H - one[1]).abs().max() / one[1].abs().max()))
        require(ou < 4 * np_ * eps and rel < np_ * eps and eu < DIST_TOL,
                f"complex polar_dist: {ou}, {rel}, {eu}")
        return (f"polar_dist {mp}x{np_} complex64: ||U^H U - I|| {ou:.3e} "
                f"(< {4 * np_ * eps:.3e}), ||A - U H||/||A|| {rel:.3e} (< {np_ * eps:.3e}), U, H "
                f"vs single-device polar {eu:.2e} (< {DIST_TOL:g}; polar {t1:.3f} s first call)")
    phase("polar_dist-complex", lambda: ct.polar_dist(A, mesh, config=cfg), check_polar)
    no_kernel("polar_dist-complex")

    def check_svd(res):
        U, s, Vh = res
        rel = d_norm(torch, a - (U.to_local() * s) @ Vh, mesh) / d_norm(torch, a, mesh)
        ou = d_orth(torch, U.to_local(), mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.svd(Af, config=cfg))
        es = float((s - one[1]).abs().max() / one[1][0]) if i == 0 else 0.0
        require(rel < np_ * eps and ou < 16 * np_ * eps and es < DIST_TOL and not s.is_complex(),
                f"complex svd_dist: {rel}, {ou}, {es}")
        return (f"svd_dist {mp}x{np_} complex64: residual {rel:.3e}, ||U^H U - I|| {ou:.3e}, s "
                f"vs single-device svd {es:.2e} (< {DIST_TOL:g}; svd {t1:.3f} s first call)")
    phase("svd_dist-complex", lambda: ct.svd_dist(A, mesh, config=cfg), check_svd)
    no_kernel("svd_dist-complex")
    del a, A, Af

    # -- rsvd_dist and eigh_rand_dist on known spectra
    mr, nr, k, p, it = sizes["cx_rsvd"]
    mloc = mr // P
    sig = DECAY ** torch.arange(nr, dtype=torch.float64, device=dev)
    Afull = ((chaar(torch, mr, nr, 70, dev) * sig) @ chaar(torch, nr, nr, 71, dev).mH).to(c64)
    a = Afull[i * mloc:(i + 1) * mloc].clone()
    if i:
        del Afull
        Afull = None

    def check_rsvd(res):
        U, s, Vh = res
        E = wide(torch, a) - (wide(torch, U.to_local()) * s.double()) @ wide(torch, Vh)
        err2 = float(torch.linalg.eigvalsh(psum(E.mH @ E, mesh))[-1].clamp_min(0).sqrt())
        es = float(((s.double() - sig[:k]).abs() / (1e-3 * sig[:k] + 50 * eps)).max())
        one, t1 = on_rank0(torch, mesh, lambda: ct.rsvd(Afull, k, p, it, config=cfg))
        e1 = float((s - one[1]).abs().max() / one[1][0]) if i == 0 else 0.0
        require(err2 < 3 * float(sig[k]) and es < 1 and e1 < DIST_TOL,
                f"complex rsvd_dist: {err2}, {es}, {e1}")
        return (f"rsvd_dist {mr}x{nr} complex64 k={k} p={p} n_iter={it}: ||A - U S V^H||_2 "
                f"{err2:.3e} (< 3 sigma_{k + 1} = {3 * float(sig[k]):.3e}), s vs sigma {es:.3f} "
                f"(< 1), s vs single-device rsvd {e1:.2e} (< {DIST_TOL:g}; rsvd {t1:.3f} s "
                f"first call)")
    phase("rsvd_dist-complex", lambda: ct.rsvd_dist(as_row_sharded(a, mesh, mr), k, mesh, p, it,
                                                    config=cfg), check_rsvd)
    no_kernel("rsvd_dist-complex")
    del a, Afull

    ne, ke, pe, ite = sizes["cx_eigh_rand"]
    mloc = ne // P
    w_true = (DECAY ** torch.arange(ne, dtype=torch.float64, device=dev)
              * (1 - 2 * (torch.arange(ne, device=dev) % 2)))
    Ve = chaar(torch, ne, ne, 72, dev)
    S = (Ve * w_true) @ Ve.mH
    S = ((S + S.mH) * 0.5).to(c64)
    del Ve
    s_loc = S[i * mloc:(i + 1) * mloc].clone()

    def check_eigh_rand(res):
        w, V = res
        V_all = wide(torch, gather_rows(V, mesh))
        errf = d_norm(torch, wide(torch, s_loc) - (wide(torch, V.to_local()) * w.double())
                      @ V_all.mH, mesh)
        tailf = float(w_true[ke:].norm())
        we = float(((w.double() - w_true[:ke]).abs()
                    / (1e-3 * w_true[:ke].abs() + 50 * eps)).max())
        ov = d_orth(torch, V.to_local(), mesh)
        one, t1 = on_rank0(torch, mesh, lambda: ct.eigh_rand(S, ke, pe, ite, config=cfg))
        e1 = float((w - one[0]).abs().max() / one[0].abs().max()) if i == 0 else 0.0
        require(errf < 1.5 * tailf and we < 1 and ov < 16 * (ke + pe) * eps and e1 < DIST_TOL,
                f"complex eigh_rand_dist: {errf}, {we}, {ov}, {e1}")
        return (f"eigh_rand_dist {ne}^2 complex64 k={ke} p={pe} n_iter={ite}: ||S - V W V^H||_F "
                f"{errf:.3e} (< 1.5 x the tail's {tailf:.3e}), w vs w_true {we:.3f} (< 1), "
                f"||V^H V - I|| {ov:.3e}, w vs single-device eigh_rand {e1:.2e} "
                f"(< {DIST_TOL:g}; eigh_rand {t1:.3f} s first call)")
    phase("eigh_rand_dist-complex", lambda: ct.eigh_rand_dist(as_row_sharded(s_loc, mesh, ne), ke,
                                                              mesh, pe, ite, config=cfg),
          check_eigh_rand)
    no_kernel("eigh_rand_dist-complex")


def dist_nccl_rank(mesh, smi: str, n: int):
    """Rank body of the NCCL run: caqr at n^2 on this rank's own card."""
    import torch
    import torch.distributed as dist
    import cuda_qr_tpu_torch as ct
    from cuda_qr_tpu_torch.parallel.mesh import as_row_sharded, mesh_device

    dev = mesh_device(mesh)
    P, i = mesh.size(0), mesh.get_local_rank(0)
    cfg = ct.DEFAULT_CONFIG
    mloc, shift = n // P, 3.0 * n ** 0.5
    a = d_rows(torch, 51, i, mloc, n, dev, shift)
    reset_counts(torch)
    (Q, R), sec = d_timed(torch, lambda: ct.caqr(as_row_sharded(a, mesh, n), mesh, cfg))
    counts = read_counts()
    g = d_qr_gates(torch, f"caqr {n}^2 over NCCL", a, Q.to_local(), R, mesh)
    e = r_err(torch, R, ct.qr(d_full(torch, 51, P, mloc, n, dev, shift), cfg, mode="r")) \
        if i == 0 else 0.0
    require(e < DIST_TOL, f"caqr over NCCL: R vs qr's {e}")
    d_say(mesh, f"caqr {n}^2 f32 bk block over {dist.get_backend()}, P={P}: residual "
          f"{g['residual']:.3e}, orthogonality {g['orthogonality']:.3e}, R vs single-device qr "
          f"{e:.2e} (< {DIST_TOL:g}); {sec:.3f} s ({smi})")
    return {"backend": dist.get_backend(), "counts": counts, "seconds": sec}


def phase_dist(torch, smi):
    """The distributed path: one spawn of P_DIST ranks runs every phase of
    ``dist_rank``, then one rank over NCCL runs caqr.  Prints each phase's
    launches summed over the ranks and per rank, and which operations went
    through host memory; returns the path's counts summed over ranks."""
    import tempfile
    from cuda_qr_tpu_torch.parallel.launch import COLLECTIVE_TIMEOUT_S, run_ranks
    from cuda_qr_tpu_torch.parallel.mesh import backend_for
    torch.cuda.empty_cache()
    P = P_DIST
    shared = P > torch.cuda.device_count()
    say(f"distributed path: P={P} ranks, backend {backend_for(P, 'cuda')}"
        f"{', ranks share one card' if shared else ''}; collective timeout "
        f"{COLLECTIVE_TIMEOUT_S} s")
    with tempfile.TemporaryDirectory(prefix="cqt_ckpt_") as ck:
        ranks = run_ranks(P, dist_rank, smi, {**DIST_SIZES, "checkpoint_dir": ck},
                          join_timeout=DIST_JOIN_S)
    total = {}
    for name in ranks[0]:
        per = [r[name]["counts"] for r in ranks]
        summed = {}
        for c in per:
            add_counts(summed, c)
        add_counts(total, summed)
        hops = {}
        for r in ranks:
            add_counts(hops, r[name]["hops"])
        say(f"  dist {name}: {counts_str(summed)} (over ranks); per rank geqrt "
            f"{[c['geqrt'] for c in per]}, geqrt_batched {[c['geqrt_batched'] for c in per]}, "
            f"chol_inv {[c['chol_inv'] for c in per]}; through host memory: "
            f"{', '.join(f'{op} x{k}' for op, k in hops.items()) or 'none'}; "
            f"{ranks[0][name]['seconds']:.3f} s")
        if name == "caqr":
            require(all(c["geqrt"] > 0 for c in per), "caqr: a rank launched no geqrt kernel")
        if name.startswith("tsqr_dist"):
            kernel = "chol_inv" if name.endswith("cholqr2") else "geqrt_batched"
            require(all(c[kernel] > 0 for c in per), f"{name}: a rank launched no {kernel}")
    nccl = run_ranks(1, dist_nccl_rank, smi, N_NCCL, join_timeout=DIST_JOIN_S)[0]
    require(nccl["backend"] == "nccl", f"the one-rank run took {nccl['backend']}, not NCCL")
    require(nccl["counts"]["geqrt"] > 0, "caqr over NCCL launched no geqrt kernel")
    add_counts(total, nccl["counts"])
    say(f"  dist caqr over NCCL (P=1): {counts_str(nccl['counts'])}; {nccl['seconds']:.3f} s")
    return total


def phase_cli(torch, np, ct, dev, smi):
    """The command line in process (``cli.main``), stdout captured, every
    record's ``ok`` true; the kernels each call must launch; the factor's
    chol_inv launches per qr_blocked call equal to the main path's (``qr`` of
    a numpy array at DEFAULT_CONFIG) on the command's own input: the count
    depends on the data (a panel's fallback adds one); float64 R against the
    C oracle's; then one ``python -m cuda_qr_tpu_torch``.  Returns the
    path's counts."""
    import contextlib
    import io
    from cuda_qr_tpu_torch import cli
    from cuda_qr_tpu_torch.oracle import binding
    A = np.random.default_rng(12).standard_normal((N_MAIN, N_MAIN))   # the command's input
    _, main_counts, _ = run_counted(torch, lambda: ct.qr(A.astype(np.float32)))
    chol_per_qr = main_counts["chol_inv"]
    del A
    total = {}
    for argv, needs in CLI_FULL + CLI_SMALL:
        argv = (["--trials", str(CLI_TRIALS)] if "--trials" not in argv else []) + argv
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, counts, sec = run_counted(torch, lambda: cli.main(argv))
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        add_counts(total, counts)
        say(f"  cli {' '.join(argv)}: {json.dumps(rec)}; {counts_str(counts)}; {sec:.3f} s "
            f"({smi})")
        require(rc == 0 and rec.get("ok", True), f"cli {argv}: rc {rc}, record {rec}")
        for kernel in needs:
            require(counts[kernel] > 0, f"cli {argv} launched no {kernel} kernel")
        if argv[-3:] == ["factor", "8192", "8192"] and "--mixed" not in argv:
            calls = CLI_TRIALS + 3      # first, warm-up, trials, verification
            require(counts["chol_inv"] == chol_per_qr * calls,
                    f"cli factor: chol_inv {counts['chol_inv']} launches in {calls} calls, "
                    f"main path {chol_per_qr} a call")
            say(f"  cli factor: chol_inv {counts['chol_inv'] // calls} launches a call, as the "
                f"main path's {chol_per_qr}")
    # float64 R of the port against the oracle's on BASELINE config 1's input
    n, pr, pc = N_ORACLE
    A = np.random.default_rng(12).standard_normal((n, n))
    packed, _ = binding.mmqr(A, pr, pc)
    cfg = ct.DEFAULT_CONFIG.replace(dtype=torch.float64)
    R = ct.extract_r(ct.qr_blocked(torch.as_tensor(A, device=dev), cfg), n)
    e = r_err(torch, R, torch.as_tensor(np.triu(packed[:n]), device=dev))
    say(f"  float64 qr_blocked {n}^2 R vs the C oracle's (pr {pr}, pc {pc}), rows sign-"
        f"normalized: {e:.3e} of max |R| (< {ORACLE_R_TOL:g})")
    require(e < ORACLE_R_TOL, f"float64 R vs the oracle's: {e}")
    # the real entry point, in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cuda_qr_tpu_torch", *CLI_SUBPROCESS],
                          cwd=HERE, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if lines else {}
    say(f"  python -m cuda_qr_tpu_torch {' '.join(CLI_SUBPROCESS)}: rc {proc.returncode}, "
        f"{json.dumps(rec)}; {time.perf_counter() - t0:.3f} s")
    require(proc.returncode == 0 and rec.get("ok") is True,
            f"python -m cuda_qr_tpu_torch: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    return total


def crandn(torch, shape, seed: int, dtype, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, dtype=dtype, device=dev)


def phase_complex(torch, ct, dev, smi):
    """Complex QR on the Householder family, inputs made on the card: each
    call gated, timed beside the library call on the same input, and held
    to zero kernel launches; each kernel wrapper raises on a complex CUDA
    tensor.  Returns the path's counts (all kernels 0)."""
    from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
    from cuda_qr_tpu_torch.ops.geqrt import geqrt_base, geqrt_batched
    from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
    from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    cfg = ct.DEFAULT_CONFIG
    c64, c128 = torch.complex64, torch.complex128
    total = {}

    def run(name, fn, lib_fn):
        out, counts, first = run_counted(torch, fn)
        add_counts(total, counts)
        require(all(v == 0 for k, v in counts.items() if k != "host_syncs"),
                f"{name}: a kernel launched on complex input ({counts})")
        t = cuda_time_ms(fn, reps=1, warmup=0)
        t_lib = cuda_time_ms(lib_fn, reps=3, warmup=1)
        return out, (f"{t:.2f} ms ({first:.3f} s first call) beside {t_lib:.2f} ms library; "
                     f"{counts_str(counts)} ({smi})")

    n = N_CX_QR
    A = crandn(torch, (n, n), 60, c64, dev)
    (Q, R), t = run(f"qr {n}^2 c64", lambda: ct.qr(A, cfg), lambda: torch.linalg.qr(A))
    gate(f"complex qr {n}^2 c64", ct.check_qr_device(A, Q, R))
    im = float(R.diagonal().imag.abs().max() / R.abs().max())
    say(f"  complex qr {n}^2 c64: max |Im diag R| / max |R| {im:.1e} (<= 1e-05); {t}")
    require(im <= 1e-5, f"complex qr: R's diagonal is not real ({im})")
    del A, Q, R

    m, n, k = N_CX_COMPLETE
    A = crandn(torch, (m, n), 61, c64, dev)
    (Qc, Rc), t = run(f"qr complete {m}x{n} c64", lambda: ct.qr(A, cfg, mode="complete"),
                      lambda: torch.linalg.qr(A, mode="complete"))
    require(Qc.shape == (m, m) and Rc.shape == (m, n), f"complete: {Qc.shape}, {Rc.shape}")
    gate(f"complex qr complete {m}x{n} c64 (first n columns)",
         ct.check_qr_device(A, Qc[:, :n], Rc[:n]))
    orth = orth_defect(torch, Qc)
    say(f"  complex qr complete: ||Q^H Q - I||_F of the whole {m}^2 Q {orth:.3e} "
        f"(< {4 * m * 1.2e-7:.3e}); {t}")
    require(orth < 4 * m * 1.2e-7, f"complete Q not unitary: {orth}")
    del Qc, Rc
    res = ct.qr_factor(A, cfg)
    B = crandn(torch, (m, k), 62, c64, dev)
    back, t = run("apply_q(apply_qt(B))", lambda: res.apply_q(res.apply_qt(B)),
                  lambda: torch.linalg.qr(A))
    e = float((back - B).norm() / B.norm())
    say(f"  complex apply_q(apply_qt(B)) {m}x{k}: ||. - B|| / ||B|| {e:.3e} "
        f"(< {n * 1.2e-7:.3e}); {t}")
    require(e < n * 1.2e-7, f"complex ormqr round trip: {e}")
    del A, B, back, res

    n = N_CX128
    A = crandn(torch, (n, n), 63, c128, dev)
    (Q, R), t = run(f"qr {n}^2 c128", lambda: ct.qr(A, cfg), lambda: torch.linalg.qr(A))
    gate(f"complex qr {n}^2 c128", ct.check_qr_device(A, Q, R))
    say(f"  complex qr {n}^2 c128: {t}")
    del A, Q, R

    m, n, k = N_CX_LSTSQ
    A = crandn(torch, (m, n), 64, c64, dev)
    b = crandn(torch, (m, k), 65, c64, dev)
    res, t = run(f"lstsq {m}x{n} c64", lambda: ct.lstsq(A, b, cfg),
                 lambda: torch.linalg.lstsq(A, b))
    want = torch.linalg.lstsq(A.to(c128), b.to(c128)).solution
    e = float((res.x.to(c128) - want).norm() / want.norm())
    say(f"  complex lstsq {m}x{n}, {k} right-hand sides: x vs torch.linalg.lstsq (complex128) "
        f"{e:.3e} (< {DIST_TOL:g}); {t}")
    require(e < DIST_TOL, f"complex lstsq: {e}")
    del A, b, res, want

    m, n = N_CX_LQ
    A = crandn(torch, (m, n), 66, c64, dev)
    (L, Q), t = run(f"lq {m}x{n} c64", lambda: ct.lq(A, cfg), lambda: torch.linalg.qr(A.mH))
    gate(f"complex lq {m}x{n} c64 (as the QR of A^H)", ct.check_qr_device(A.mH, Q.mH, L.mH))
    say(f"  complex lq {m}x{n}: {t}")
    del A, L, Q

    m, n = N_CX_TSQR
    A = crandn(torch, (m, n), 67, c64, dev)
    (Q, R), t = run(f"tsqr {m}x{n} c64", lambda: ct.tsqr(A, cfg), lambda: torch.linalg.qr(A))
    gate(f"complex tsqr {m}x{n} c64", ct.check_qr_device(A, Q, R))
    say(f"  complex tsqr {m}x{n}: {t}")
    Rr, t = run(f"tsqr_r {m}x{n} c64", lambda: ct.tsqr_r(A, cfg),
                lambda: torch.linalg.qr(A, mode="r"))
    e = float((Rr.abs() - R.abs()).abs().max() / R.abs().max())
    say(f"  complex tsqr_r: |R| vs tsqr's {e:.1e} (< 1e-05); {t}")
    require(e < 1e-5, f"complex tsqr_r vs tsqr: {e}")
    (Q3, R3), t = run(f"tsqr cholqr2 config {m}x{n} c64",
                      lambda: ct.tsqr(A, cfg.replace(tsqr_leaf="cholqr2")),
                      lambda: torch.linalg.qr(A))
    gate(f"complex tsqr tsqr_leaf='cholqr2' (Householder leaves) {m}x{n} c64",
         ct.check_qr_device(A, Q3, R3))
    say(f"  complex tsqr, tsqr_leaf='cholqr2' routed to Householder leaves: {t}")
    del A, Q, R, Rr, Q3, R3

    # Does MIXED_CONFIG's TF32 reach complex64 GEMMs (cuBLAS math mode)?
    from cuda_qr_tpu_torch.ops.gemm import _product
    X, Y = crandn(torch, (2048, 2048), 71, c64, dev), crandn(torch, (2048, 2048), 72, c64, dev)
    exact = X.to(c128) @ Y.to(c128)
    errs = {}
    for prec, mode in (("highest", "ieee"), ("tf32", "tf32")):
        errs[prec] = float((_product(X, Y, mode) - exact).abs().max() / exact.abs().max())
    say(f"  complex64 GEMM 2048^2 vs complex128: 'highest' {errs['highest']:.2e}, 'tf32' "
        f"{errs['tf32']:.2e}: TF32 {'reaches' if errs['tf32'] > 10 * errs['highest'] else 'does not reach'}"
        f" complex64 GEMMs")
    del X, Y, exact
    # complex_config runs every GEMM of a complex input at "highest", so
    # MIXED_CONFIG's TF32 trailing update does not reach this call (C3)
    n = N_CX_MIXED
    A = crandn(torch, (n, n), 73, c64, dev)
    (Q, R), counts, first = run_counted(torch, lambda: ct.qr(A, ct.MIXED_CONFIG))
    add_counts(total, counts)
    require(all(v == 0 for k, v in counts.items() if k != "host_syncs"),
            f"complex qr at MIXED_CONFIG launched a kernel ({counts})")
    gate(f"complex qr {n}^2 c64 at MIXED_CONFIG (every GEMM 'highest')",
         ct.check_qr_device(A, Q, R))
    say(f"  complex qr {n}^2 c64 at MIXED_CONFIG: {first:.3f} s first call; {counts_str(counts)}")
    del A, Q, R

    for name, call in (
            ("chol_inv", lambda: chol_with_inv_kernel(torch.eye(64, dtype=c64, device=dev))),
            ("geqrt", lambda: geqrt_base(crandn(torch, (256, 64), 68, c64, dev), 0)),
            ("geqrt_batched", lambda: geqrt_batched(crandn(torch, (4, 256, 64), 69, c64, dev), 0)),
            ("select_pivots", lambda: select_pivots_kernel(
                crandn(torch, (160, 512), 70, c64, dev), torch.ones(512, dtype=c64, device=dev),
                128)),
            ("newton_inv", lambda: newton_certified_kernel(torch.eye(64, dtype=c64, device=dev)))):
        try:
            call()
        except (TypeError, ValueError) as exc:
            say(f"  {name} on a complex CUDA tensor raises {type(exc).__name__}: {exc}")
        else:
            raise AssertionError(f"{name} took a complex CUDA tensor")
    return total


def chaar(torch, rows: int, cols: int, seed: int, dev):
    """An orthonormal (rows x cols) complex128 factor: Q of a seeded complex
    Gaussian."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.linalg.qr(torch.randn(rows, cols, generator=g, dtype=torch.complex128,
                                       device=dev)).Q


def timed_counted(torch, fn):
    """``run_counted`` timed by CUDA events around the call (no kernel is
    built on a complex path, so the first call is a steady one):
    (result, counts, device ms)."""
    reset_counts(torch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, read_counts(), start.elapsed_time(end)


def phase_complex_rest(torch, ct, dev, smi):
    """The rest of complex input, inputs made on the card: qr_pivoted, the
    rank solvers, the Givens updates, the randomized tools, QDWH polar and
    svd, eigh and eigh_batched.  Each call is gated in float64/complex128
    on the card, held to zero kernel launches, and timed by CUDA events
    beside the PyTorch call for the same function where there is one.
    Returns the path's counts (all kernels 0)."""
    from cuda_qr_tpu_torch.models import eigh as eigh_mod
    from cuda_qr_tpu_torch.ops.smalllinalg import library_eigh
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    cfg = ct.DEFAULT_CONFIG
    c64, c128 = torch.complex64, torch.complex128
    eps = float(torch.finfo(torch.float32).eps)
    total = {}

    def run(name, fn, lib_fn=None, lib_name="", lib_reps=2):
        out, counts, ms = timed_counted(torch, fn)
        add_counts(total, counts)
        require(all(v == 0 for k, v in counts.items() if k != "host_syncs"),
                f"{name}: a kernel launched on complex input ({counts})")
        lib = ""
        if lib_fn is not None:
            lib = (f" beside {lib_name} {cuda_time_ms(lib_fn, reps=lib_reps, warmup=1):.2f} ms")
        return out, f"{ms:.2f} ms{lib}; {counts_str(counts)} ({smi})"

    def defect(X, Y):
        """||X - Y||_F / ||Y||_F in float64/complex128."""
        return float((wide(torch, X) - wide(torch, Y)).norm() / wide(torch, Y).norm())

    # -- pivoted QR at the main path's width
    n = N_CX_PIVOTED
    A = crandn(torch, (n, n), 80, c64, dev)
    (Q, R, piv), t = run(f"qr_pivoted {n}^2 c64", lambda: ct.qr_pivoted(A, cfg),
                         lambda: torch.linalg.qr(A), "torch.linalg.qr (unpivoted)", 1)
    require(torch.equal(torch.sort(piv).values, torch.arange(n, device=dev)),
            "complex qr_pivoted: piv is not a permutation")
    gate(f"complex qr_pivoted {n}^2 c64", ct.check_qr_device(A[:, piv], Q, R))
    d = R.diagonal().abs()
    mono = float((d[1:] / d[:-1]).max())
    say(f"  complex qr_pivoted {n}^2: max |R_i+1,i+1| / |R_ii| {mono:.3f} (rank-revealing "
        f"order, < 1.5); {t}")
    require(mono < 1.5, f"complex qr_pivoted: |diag R| does not decrease ({mono})")
    del A, Q, R, piv

    # -- the rank solvers on an exactly rank-r A = B C
    m, n, r = N_CX_RANK
    B = crandn(torch, (m, r), 81, c128, dev)
    C = crandn(torch, (r, n), 82, c128, dev)
    b = crandn(torch, (m,), 83, c128, dev)
    A = (B @ C).to(c64)
    rk, t = run(f"matrix_rank {m}x{n} c64", lambda: ct.matrix_rank(A, 1e-4, cfg),
                lambda: torch.linalg.matrix_rank(A), "torch.linalg.matrix_rank")
    say(f"  complex matrix_rank {m}x{n} (rank {r} by construction, rcond 1e-4): {rk}; {t}")
    require(rk == r, f"complex matrix_rank gave {rk}, expected {r}")
    # the minimum-norm solution and the pseudoinverse from the known factors:
    # A^+ = C^H (C C^H)^{-1} (B^H B)^{-1} B^H
    Apinv = C.mH @ torch.linalg.solve(C @ C.mH, torch.linalg.solve(B.mH @ B, B.mH))
    (x, resid, rk2, _), t = run(f"lstsq_rr {m}x{n} c64",
                                lambda: ct.lstsq_rr(A, b.to(c64), 1e-4, cfg))
    ex = defect(x, Apinv @ b)
    say(f"  complex lstsq_rr: rank {rk2}, x vs the minimum-norm complex128 solution {ex:.3e} "
        f"(< 1e-3); {t}")
    require(rk2 == r and ex < 1e-3, f"complex lstsq_rr: rank {rk2}, error {ex}")
    P, t = run(f"pinv {m}x{n} c64", lambda: ct.pinv(A, 1e-4, cfg),
               lambda: torch.linalg.pinv(A, rtol=1e-4), "torch.linalg.pinv")
    ep = defect(P, Apinv)
    say(f"  complex pinv: vs the complex128 pseudoinverse from the factors {ep:.3e} (< 1e-3); {t}")
    require(ep < 1e-3, f"complex pinv: {ep}")
    del P, Apinv
    N, t = run(f"null_space {m}x{n} c64", lambda: ct.null_space(A, 1e-4, cfg))
    on = orth_defect(torch, N)
    an = float((wide(torch, A) @ wide(torch, N)).norm() / wide(torch, A).norm())
    say(f"  complex null_space: {tuple(N.shape)}, ||N^H N - I|| {on:.3e} (< {4 * n * eps:.3e}), "
        f"||A N||/||A|| {an:.3e} (< {n * eps:.3e}); {t}")
    require(N.shape == (n, n - r) and on < 4 * n * eps and an < n * eps,
            "complex null_space fails its gates")
    del N, B, C, b

    # -- orth on the same rank-r input (rank-revealing QRCP, plain selection)
    Qo, t = run(f"orth(rcond=1e-4) {m}x{n} c64", lambda: ct.orth(A, rcond=1e-4, config=cfg),
                lambda: torch.linalg.qr(A), "torch.linalg.qr")
    oq = orth_defect(torch, Qo)
    proj = defect(Qo.to(c128) @ (Qo.to(c128).mH @ A.to(c128)), A)
    say(f"  complex orth(rcond=1e-4) rank {r}: {tuple(Qo.shape)}, ||Q^H Q - I|| {oq:.3e} "
        f"(< {4 * n * eps:.3e}), ||Q Q^H A - A||/||A|| {proj:.3e} (< {n * eps:.3e}); {t}")
    require(tuple(Qo.shape) == (m, r) and oq < 4 * n * eps and proj < n * eps,
            "complex orth(rcond) fails its gates")
    del A, Qo

    # -- the six Givens updates of a thin QR, no host sync in a chain
    m, n, k = N_CX_UPDATE
    A = crandn(torch, (m, n), 84, c64, dev)
    Q, R = ct.qr(A, cfg)
    u1, v1 = crandn(torch, (m,), 85, c64, dev), crandn(torch, (n,), 86, c64, dev)
    U4, V4 = crandn(torch, (m, 4), 87, c64, dev), crandn(torch, (n, 4), 88, c64, dev)
    row, col = crandn(torch, (n,), 89, c64, dev), crandn(torch, (m,), 90, c64, dev)
    cases = (
        ("qr_rank1_update", lambda: ct.qr_rank1_update(Q, R, u1, v1),
         A + torch.outer(u1, v1.conj())),
        ("qr_update rank 4", lambda: ct.qr_update(Q, R, U4, V4), A + U4 @ V4.mH),
        ("qr_row_insert", lambda: ct.qr_row_insert(Q, R, row, k),
         torch.cat([A[:k], row[None], A[k:]])),
        ("qr_row_delete", lambda: ct.qr_row_delete(Q, R, k), torch.cat([A[:k], A[k + 1:]])),
        ("qr_col_insert", lambda: ct.qr_col_insert(Q, R, col, k),
         torch.cat([A[:, :k], col[:, None], A[:, k:]], 1)),
        ("qr_col_delete", lambda: ct.qr_col_delete(Q, R, k),
         torch.cat([A[:, :k], A[:, k + 1:]], 1)),
    )
    for name, fn, A1 in cases:
        torch.cuda.set_sync_debug_mode("error")   # any synchronizing op raises
        try:
            (Q1, R1), t = run(f"{name} {m}x{n} c64", fn, lambda A1=A1: torch.linalg.qr(A1),
                              f"torch.linalg.qr refactor {tuple(A1.shape)}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        gate(f"complex {name} {m}x{n} c64", ct.check_qr_device(A1, Q1, R1))
        say(f"  complex {name}: {t}")
    del A, Q, R, Q1, R1

    # -- rsvd on a known spectrum, then norm2_est of the same matrix
    m, n, k, p, it = N_CX_RSVD
    sig = DECAY ** torch.arange(n, dtype=torch.float64, device=dev)
    A = ((chaar(torch, m, n, 91, dev) * sig) @ chaar(torch, n, n, 92, dev).mH).to(c64)
    (U, s, Vh), t = run(f"rsvd {m}x{n} c64", lambda: ct.rsvd(A, k, p, it, config=cfg),
                        lambda: torch.svd_lowrank(A, q=k + p, niter=it),
                        f"torch.svd_lowrank (q={k + p}, niter={it})")
    E = wide(torch, A) - (wide(torch, U) * s.double()) @ wide(torch, Vh)
    err2 = float(torch.linalg.eigvalsh(E.mH @ E)[-1].clamp_min(0).sqrt())
    del E
    s_err = float(((s.double() - sig[:k]).abs() / (1e-3 * sig[:k] + 50 * eps)).max())
    ou, ov = orth_defect(torch, U), orth_defect(torch, Vh.mH)
    say(f"  complex rsvd {m}x{n} k={k} p={p} n_iter={it}: ||A - U S V^H||_2 {err2:.3e} "
        f"(< 3 sigma_{k + 1} = {3 * float(sig[k]):.3e}), max |s - sigma| / (1e-3 sigma + "
        f"50 eps) {s_err:.3f} (< 1), ||U^H U - I|| {ou:.3e}, ||V V^H - I|| {ov:.3e} "
        f"(< {16 * (k + p) * eps:.3e}); {t}")
    require(err2 < 3 * float(sig[k]) and s_err < 1 and max(ou, ov) < 16 * (k + p) * eps
            and not s.is_complex(), "complex rsvd fails its gates")
    del U, Vh
    Qa, t = run(f"orth {m}x{n} c64", lambda: ct.orth(A, config=cfg),
                lambda: torch.linalg.qr(A), "torch.linalg.qr")
    oq = orth_defect(torch, Qa)
    proj = defect(Qa.to(c128) @ (Qa.to(c128).mH @ A.to(c128)), A)
    say(f"  complex orth {m}x{n}: ||Q^H Q - I|| {oq:.3e} (< {4 * n * eps:.3e}), "
        f"||Q Q^H A - A||/||A|| {proj:.3e} (< {n * eps:.3e}); {t}")
    require(oq < 4 * n * eps and proj < n * eps, "complex orth fails its gates")
    del Qa, A

    # -- norm2_est and cond_est on a known spectrum
    n, cond = N_CX_COND
    sc = torch.logspace(0, -float(torch.log10(torch.tensor(cond))), n, dtype=torch.float64,
                        device=dev)
    A = ((chaar(torch, n, n, 93, dev) * sc) @ chaar(torch, n, n, 94, dev).mH).to(c64)
    est, t = run(f"norm2_est {n}^2 c64", lambda: float(ct.norm2_est(A, config=cfg)),
                 lambda: torch.linalg.matrix_norm(A, ord=2), "torch.linalg.matrix_norm(ord=2)")
    say(f"  complex norm2_est {n}^2 (sigma_max 1): {est:.6f} (in [0.95, 1.0001]); {t}")
    require(0.95 <= est <= 1.0001, "complex norm2_est is no lower bound near sigma_max")
    ce, t = run(f"cond_est {n}^2 c64", lambda: float(ct.cond_est(A, config=cfg)),
                lambda: torch.linalg.cond(A), "torch.linalg.cond", 1)
    say(f"  complex cond_est {n}^2 (cond {cond:g}): {ce:.2f} (in [{0.8 * cond:g}, "
        f"{1.05 * cond:g}]); {t}")
    require(0.8 * cond <= ce <= 1.05 * cond, "complex cond_est misses the known spectrum")
    del A

    # -- eigh_rand on a known indefinite spectrum
    n, k, p, it = N_CX_EIGH_RAND
    w_true = (DECAY ** torch.arange(n, dtype=torch.float64, device=dev)
              * (1 - 2 * (torch.arange(n, device=dev) % 2)))
    Ve = chaar(torch, n, n, 95, dev)
    S = (Ve * w_true) @ Ve.mH
    S = ((S + S.mH) * 0.5).to(c64)
    del Ve
    (w, V), t = run(f"eigh_rand {n}^2 c64", lambda: ct.eigh_rand(S, k, p, it, config=cfg))
    E = wide(torch, S) - (wide(torch, V) * w.double()) @ wide(torch, V).mH
    errf, tailf = float(E.norm()), float(w_true[k:].norm())
    del E
    w_err = float(((w.double() - w_true[:k]).abs() / (1e-3 * w_true[:k].abs() + 50 * eps)).max())
    ov = orth_defect(torch, V)
    say(f"  complex eigh_rand {n}^2 k={k} p={p} n_iter={it}: ||S - V W V^H||_F {errf:.3e} "
        f"(< 1.5 x the tail's {tailf:.3e}), max |w - w_true| / (1e-3 |w| + 50 eps) {w_err:.3f} "
        f"(< 1), ||V^H V - I|| {ov:.3e} (< {16 * (k + p) * eps:.3e}); {t}")
    require(errf < 1.5 * tailf and w_err < 1 and ov < 16 * (k + p) * eps and not w.is_complex(),
            "complex eigh_rand fails its gates")
    del S, V

    # -- QDWH polar: QR steps throughout, in complex64 and complex128
    for m, n, dname in N_CX_POLAR:
        dt = getattr(torch, dname)
        e = float(torch.finfo(torch.float64 if dt == c128 else torch.float32).eps)
        A = crandn(torch, (m, n), 96, dt, dev)
        (U, H), t = run(f"polar {m}x{n} {dname}", lambda: ct.polar(A, config=cfg))
        ou = orth_defect(torch, U)
        res = float((wide(torch, A) - wide(torch, U) @ wide(torch, H)).norm()
                    / wide(torch, A).norm())
        asym = float((H - H.mH).abs().max())
        ev = torch.linalg.eigvalsh(wide(torch, H))
        hn = float(ev.abs().max())
        say(f"  complex polar {m}x{n} {dname}: ||U^H U - I|| {ou:.3e} (< {4 * n * e:.3e}), "
            f"||A - U H||/||A|| {res:.3e} (< {n * e:.3e}), |H - H^H| {asym:g}, min eig(H) "
            f"{float(ev[0]):.3e} (>= {-n * e * hn:.3e}); {t}")
        require(ou < 4 * n * e and res < n * e and asym == 0.0 and float(ev[0]) >= -n * e * hn,
                f"complex polar {m}x{n} fails its gates")
        del A, U, H

    # -- svd (QDWH + library_eigh of H)
    n = N_CX_SVD
    A = crandn(torch, (n, n), 97, c64, dev)
    (U, s, Vh), t = run(f"svd {n}^2 c64", lambda: ct.svd(A, config=cfg),
                        lambda: torch.linalg.svd(A), "torch.linalg.svd", 1)
    res = defect((wide(torch, U) * s.double()) @ wide(torch, Vh), A)
    ou, ov = orth_defect(torch, U), orth_defect(torch, Vh.mH)
    s_ref = torch.linalg.svdvals(A.to(c128))
    serr = float((s.double() - s_ref).abs().max() / s_ref[0])
    desc = bool((s[1:] <= s[:-1]).all())
    say(f"  complex svd {n}^2: residual {res:.3e} (< {n * eps:.3e}), ||U^H U - I|| {ou:.3e}, "
        f"||V V^H - I|| {ov:.3e} (< {16 * n * eps:.3e}), max |s - svdvals128| / s_max "
        f"{serr:.3e} (< {n * eps:.3e}), descending {desc}; {t}")
    require(res < n * eps and max(ou, ov) < 16 * n * eps and serr < n * eps and desc,
            "complex svd fails its gates")
    del A, U, Vh

    # -- eigh (QDWH-eig with the phase-factor Jacobi) and eigh_batched
    n, base_n = N_CX_EIGH
    G = crandn(torch, (n, n), 98, c64, dev)
    S = (G + G.mH) * 0.5
    (w, V), t = run(f"eigh {n}^2 c64", lambda: ct.eigh(S, cfg, base_n=base_n),
                    lambda: torch.linalg.eigh(S), "torch.linalg.eigh")
    st = dict(eigh_mod.last_stats)
    res = float((wide(torch, S) @ wide(torch, V) - wide(torch, V) * w.double()).norm()
                / wide(torch, S).norm())
    ov = orth_defect(torch, V)
    w_ref = torch.linalg.eigvalsh(S.to(c128))
    werr = float((w.double() - w_ref).abs().max() / w_ref.abs().max().clamp_min(1.0))
    say(f"  complex eigh {n}^2 base_n={base_n}: ||A V - V W||/||A|| {res:.3e} "
        f"(< {n * eps:.3e}), ||V^H V - I|| {ov:.3e} = {ov / eps:.1f} eps (< "
        f"{4 * n * eps:.3e}), max |w - eigvalsh128| {werr:.3e} (< {n * eps:.3e}); split nodes "
        f"{st['split_nodes']}, leaves {st['leaves']}, Jacobi sweeps {st['jacobi_sweeps']}; {t}")
    require(res < n * eps and ov < 4 * n * eps and werr < n * eps and st["split_nodes"] > 0
            and not w.is_complex(), "complex eigh fails its gates")
    del G, S, V
    b, nb = N_CX_EIGH_BATCHED
    As = crandn(torch, (b, nb, nb), 99, c64, dev)
    As = (As + As.mH) * 0.5
    (ws, Vs), t = run(f"eigh_batched {b} x {nb}x{nb} c64", lambda: ct.eigh_batched(As),
                      lambda: torch.linalg.eigh(As), "batched torch.linalg.eigh")
    A128, V128 = As.to(c128), Vs.to(c128)
    res = float(((A128 @ V128 - V128 * ws.double()[:, None, :]).norm(dim=(1, 2))
                 / A128.norm(dim=(1, 2))).max())
    ov = float((V128.mH @ V128 - torch.eye(nb, dtype=c128, device=dev)).norm(dim=(1, 2)).max())
    werr = float((ws.double() - torch.linalg.eigvalsh(A128)).abs().max())
    tol = 5e-6 * nb
    say(f"  complex eigh_batched {b} x {nb}x{nb}: max residual {res:.3e} (< {tol:.3e}), max "
        f"orthogonality {ov:.3e} = {ov / eps:.1f} eps (< {4 * nb * eps:.3e}), max |w - "
        f"eigvalsh128| {werr:.3e} (< {tol * float(ws.abs().max()):.3e}); Jacobi sweeps "
        f"{eigh_mod.last_stats['jacobi_sweeps']}; {t}")
    require(res < tol and ov < 4 * nb * eps and werr < tol * float(ws.abs().max()),
            "complex eigh_batched fails its gates")
    del As, Vs, A128, V128

    # -- library_eigh on complex64 H (the small core of svd and eigh_rand)
    for n in (384, 512):
        H = crandn(torch, (2 * n, n), 100 + n, c64, dev)
        H = H.mH @ H / (2 * n)
        w, V = library_eigh(H)
        w_ref = torch.linalg.eigvalsh(H.to(c128))
        werr = float((w.double() - w_ref).abs().max() / w_ref.abs().max())
        say(f"  library_eigh complex64 {n}^2 Gram: max |w - eigvalsh128| / ||H||_2 {werr:.3e} "
            f"(< n eps {n * eps:.3e})")
        require(werr < n * eps, f"library_eigh complex64 at {n}: {werr}")
    return total


def phase_bench(torch, smi):
    """The headline record, ``python -m cuda_qr_tpu_torch.bench`` in a
    process of its own (8192^2 MIXED and HIGHEST factors, Q+R, the geqrt
    kernel, bfloat16 end to end): rc 0 and every gate of its last JSON line
    true."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cuda_qr_tpu_torch.bench"], cwd=HERE,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    rec = json.loads(lines[-1]) if lines else {}
    say(f"bench (python -m cuda_qr_tpu_torch.bench): rc {proc.returncode}, "
        f"{time.perf_counter() - t0:.3f} s ({smi}):")
    say(json.dumps(rec))
    require(proc.returncode == 0, f"bench: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    for key in ("verified_ok", "highest_ok", "geqrt_kernel_ok", "bf16_ok"):
        require(rec.get(key) is True, f"bench: {key} is {rec.get(key)!r}")


def gate(name, chk) -> None:
    say(f"{name}: residual {chk.residual:.3e} (< {chk.n * chk.eps:.3e}), "
        f"orthogonality {chk.orthogonality:.3e} (< {4 * chk.n * chk.eps:.3e}), "
        f"tril(R) {chk.r_triangular:g}")
    if not chk.ok:
        raise AssertionError(f"{name} fails the residual/orthogonality gates")


def set_caller_state(torch, name: str) -> None:
    """One of CALLER_STATES, as a caller's script sets it."""
    if name == "allow_tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
    elif name == "matmul_precision_high":
        torch.set_float32_matmul_precision("high")
    elif name == "matmul_fp32_precision":
        torch.backends.cuda.matmul.fp32_precision = "tf32"
    elif name == "fp32_precision":
        torch.backends.fp32_precision = "tf32"


def fp32_reads(torch) -> list:
    return [torch.backends.cuda.matmul.fp32_precision, torch.backends.fp32_precision]


def caller_state_child(name: str) -> int:
    """``--caller-state NAME``: in this fresh process, set the state, then
    ``ct.qr`` of a default_rng(12) N_C11^2 float32 input and ``gemm`` at
    "highest" and "tf32" at C11_GEMM against float64; print one JSON line:
    the two fp32_precision reads before and after, the gates, the launch and
    sync counts and the two normwise GEMM errors."""
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    import cuda_qr_tpu_torch as ct
    from cuda_qr_tpu_torch.ops.gemm import gemm

    dev = torch.device("cuda", 0)
    set_caller_state(torch, name)
    before = fp32_reads(torch)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_C11, N_C11), dtype=np.float32)).to(dev)
    (Q, R), counts, sec = run_counted(torch, lambda: ct.qr(A))
    chk = ct.check_qr_device(A, Q, R)
    after_qr = fp32_reads(torch)
    m, k, n = C11_GEMM
    g = torch.Generator(device=dev).manual_seed(12)
    X = torch.randn(m, k, generator=g, device=dev)
    Y = torch.randn(k, n, generator=g, device=dev)
    C64 = X.double() @ Y.double()
    scale = float(X.double().norm() * Y.double().norm())
    err = {p: float((gemm(X, Y, p).double() - C64).norm()) / scale for p in ("highest", "tf32")}
    S = X[:, :128].contiguous()
    host_us = {name: host_call_us(torch, fn) for name, fn in (
        ("gemm_highest", lambda: gemm(S, S.T, "highest")), ("matmul", lambda: S @ S.T))}
    print(json.dumps({"state": name, "before": before, "after_qr": after_qr,
                      "after": fp32_reads(torch), "ok": bool(chk.ok),
                      "residual": chk.residual, "orthogonality": chk.orthogonality,
                      "first_call_s": sec, "counts": counts, "gemm_err": err,
                      "host_us": host_us}))
    return 0


def host_call_us(torch, fn, calls: int = 2000) -> float:
    """Host microseconds a call of fn (a small product) takes to enqueue,
    over ``calls`` calls, one synchronize at the end."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def precision_caller_states(torch):
    """(a) C11: CALLER_STATES, one child process each, all at once.  Every
    child's qr passes its gates with B1 on every panel and leaves both
    fp32_precision attributes as it found them; "highest" keeps float32's
    GEMM error (<= C11_HIGHEST_RATIO x the untouched state's) and "tf32"
    reads TF32's (>= C11_TF32_RATIO x) in every state, so the
    fp32_precision API drives cuBLAS.  Returns the children's summed counts."""
    from cuda_qr_tpu_torch.ops import _build
    _build.load()                   # built once, before the children load it
    cmd = [sys.executable, str(HERE / "chip_smoke.py"), "--caller-state"]
    procs = {name: subprocess.Popen(cmd + [name], cwd=HERE, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name in CALLER_STATES}
    rows = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=C11_TIMEOUT_S)
            require(proc.returncode == 0,
                    f"caller state {name}: rc {proc.returncode}: {err[-3000:]}")
            rows[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    base = rows["untouched"]["gemm_err"]["highest"]
    total = {}
    for name, r in rows.items():
        e = r["gemm_err"]
        say(f"  C11 caller state {name}: fp32_precision (cuda.matmul, generic) "
            f"{r['before']} -> {r['after_qr']} after qr, {r['after']} after gemm; qr "
            f"{N_C11}^2 f32 residual {r['residual']:.3e}, orthogonality "
            f"{r['orthogonality']:.3e}, ok {r['ok']}, {r['first_call_s']:.3f} s first call, "
            f"{counts_str(r['counts'])}; gemm {'x'.join(map(str, C11_GEMM))} normwise error "
            f"'highest' {e['highest']:.3e} ({e['highest'] / base:.3f}x untouched's, <= "
            f"{C11_HIGHEST_RATIO}), 'tf32' {e['tf32']:.3e} ({e['tf32'] / base:.1f}x, >= "
            f"{C11_TF32_RATIO}); host us a call, 128^2: gemm 'highest' "
            f"{r['host_us']['gemm_highest']:.2f}, bare matmul {r['host_us']['matmul']:.2f}")
        require(r["ok"] and r["counts"]["chol_inv"] >= N_C11 // 128,
                f"caller state {name}: qr gates or B1 launches: {r}")
        require(r["before"] == r["after_qr"] == r["after"],
                f"caller state {name}: fp32_precision changed: {r}")
        require(e["highest"] <= C11_HIGHEST_RATIO * base and e["tf32"] >= C11_TF32_RATIO * base,
                f"caller state {name}: GEMM errors {e} against untouched 'highest' {base}")
        add_counts(total, {k: v for k, v in r["counts"].items() if k != "host_syncs"})
    return total


def precision_factor(torch, ct, A, name, cfg, total, gated: bool):
    """qr_blocked + orgqr of A at cfg: gates (held when ``gated``), launches,
    host syncs, first-call s and a second call's ms (CUDA events)."""
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms
    n = A.shape[0]

    def factor_and_q():
        f = ct.qr_blocked(A, cfg)
        return ct.orgqr(f, n, n, cfg), ct.extract_r(f, n)

    (Q, R), c, sec = run_counted(torch, factor_and_q)
    chk = ct.check_qr_device(A, Q, R)
    del Q, R
    ms = cuda_time_ms(factor_and_q, reps=1, warmup=0)
    say(f"  A7 {name}: qr_blocked + orgqr {n}^2 f32: residual {chk.residual:.3e} (n eps "
        f"{n * chk.eps:.3e}), orthogonality {chk.orthogonality:.3e} (4n eps "
        f"{4 * n * chk.eps:.3e}), ok {chk.ok}; {ms:.2f} ms (first call {sec:.3f} s); "
        f"{counts_str(c)}")
    if gated:
        gate(f"A7 {name} {n}^2 f32", chk)
    add_counts(total, {k: v for k, v in c.items() if k != "host_syncs"})
    return chk, c


def phase_precision(torch, np, ct, dev, smi):
    """Fault C11 and A7: (a) ``precision_caller_states``; (b) the 8192^2
    factor + Q with every GEMM at "high" on cholqr2_bk (B1) and geqrt (B2)
    panels, gated, beside "highest" on both and "tf32" panels (trailing and
    orgqr "highest", ungated) on the same input; ``qr_pivoted`` at "high" (B3); ``tsqr``
    1M x 128 at "high" with both leaves, held to phase_tsqr's bounds; and
    DEFAULT's factor at DEFAULT_B1 launches and DEFAULT_SYNCS host syncs.
    Returns the launch counts of the path."""
    say(f"GEMM precision as an argument (C11, A7) on {smi}:")
    t0 = time.perf_counter()
    total = precision_caller_states(torch)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (N_MAIN, N_MAIN), dtype=np.float32)).to(dev)
    panels = N_MAIN // ct.DEFAULT_CONFIG.panel_width
    (_, c, _) = run_counted(torch, lambda: ct.qr_blocked(A, ct.DEFAULT_CONFIG))
    say(f"  DEFAULT factor {N_MAIN}^2 f32: chol_inv launches {c['chol_inv']} (== {DEFAULT_B1}), "
        f"host syncs {c['host_syncs']} (== {DEFAULT_SYNCS})")
    require(c["chol_inv"] == DEFAULT_B1 and c["host_syncs"] == DEFAULT_SYNCS,
            f"DEFAULT factor: {counts_str(c)}, expected {DEFAULT_B1} B1 launches and "
            f"{DEFAULT_SYNCS} host syncs")
    add_counts(total, {k: v for k, v in c.items() if k != "host_syncs"})
    panels_only = dict(trailing_precision="highest", orgqr_precision="highest")
    runs = (("'high' cholqr2_bk", ct.QRConfig(precision="high"), True),
            ("'high' geqrt", ct.QRConfig(precision="high", panel_method="geqrt"), True),
            ("'highest' cholqr2_bk", ct.DEFAULT_CONFIG, True),
            ("'highest' geqrt", ct.QRConfig(panel_method="geqrt"), True),
            ("'tf32' panels cholqr2_bk", ct.QRConfig(precision="tf32", **panels_only), False))
    for name, cfg, gated in runs:
        _, c = precision_factor(torch, ct, A, name, cfg, total, gated)
        kernel = "geqrt" if cfg.panel_method == "geqrt" else "chol_inv"
        require(c[kernel] >= (1 if kernel == "geqrt" else panels),
                f"A7 {name}: {counts_str(c)}")
    cfg = ct.QRConfig(precision="high")
    (Qp, Rp, piv), c, sec = run_counted(torch, lambda: ct.qr_pivoted(A, cfg))
    say(f"  A7 'high' qr_pivoted {N_MAIN}^2 f32: {sec:.3f} s first call; {counts_str(c)}")
    gate(f"A7 'high' qr_pivoted {N_MAIN}^2 f32", ct.check_qr_device(A[:, piv], Qp, Rp))
    require(c["select_pivots"] >= panels, f"A7 'high' qr_pivoted: {counts_str(c)}")
    add_counts(total, {k: v for k, v in c.items() if k != "host_syncs"})
    del A, Qp, Rp
    m, n = N_TSQR
    A = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (m, n), dtype=np.float32)).to(dev)
    eps = float(torch.finfo(torch.float32).eps)
    for leaf, orth_gate in (("householder", 4 * n * eps), ("cholqr2", 4 * m ** 0.5 * eps)):
        (Q, R), c, sec = run_counted(torch, lambda: ct.tsqr(A, cfg.replace(tsqr_leaf=leaf)))
        chk = ct.check_qr_device(A, Q, R)
        del Q, R
        say(f"  A7 'high' tsqr {m}x{n} f32 {leaf}: residual {chk.residual:.3e} (< "
            f"{n * eps:.3e}), orthogonality {chk.orthogonality:.3e} (< {orth_gate:.3e}), "
            f"tril(R) {chk.r_triangular:g}; {sec:.3f} s first call; {counts_str(c)}")
        require(chk.residual < n * eps and chk.orthogonality < orth_gate
                and chk.r_triangular == 0.0, f"A7 'high' tsqr {leaf} fails its gates")
        require((c["geqrt_batched"], c["geqrt_pair"]) == (11, 10) if leaf == "householder"
                else c["chol_inv"] > 0, f"A7 'high' tsqr {leaf}: {counts_str(c)}")
        add_counts(total, {k: v for k, v in c.items() if k != "host_syncs"})
    say(f"  precision phase: {time.perf_counter() - t0:.1f} s")
    return total


# phases that ``--only`` can run alone
STANDALONE = ("rotation_bias", "eigh", "orgqr_groups", "update", "factor", "mixed",
              "bench", "stages", "precision", "slogdet", "newton", "geqrt_pair")


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA GPU.")
    ap.add_argument("--only", default="",
                    help=f"run only these phases, comma-separated, of {', '.join(STANDALONE)}")
    ap.add_argument("--caller-state", choices=CALLER_STATES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.caller_state:
        return caller_state_child(args.caller_state)
    only = [p for p in args.only.split(",") if p]
    if any(p not in STANDALONE for p in only):
        ap.error(f"--only takes phases of {STANDALONE}, got {only}")
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
    from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
    from cuda_qr_tpu_torch.ops.qrcp import qrcp_blocked
    from cuda_qr_tpu_torch.ops.select_kernel import select_pivots_kernel
    from cuda_qr_tpu_torch.utils.timing import cuda_time_ms, qr_flops

    smi = phase_device(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # The script's own float32 products run in IEEE float32: it starts with
    # no TF32 mode set, and the port restores the caller's mode after each
    # of its products (the caller states of phase_precision run in children).
    require(fp32_reads(torch) == ["none", "none"],
            f"the process starts with a float32 GEMM mode set: {fp32_reads(torch)}")
    if only:
        if "rotation_bias" in only:
            phase_rotation_bias(torch, dev)
        if "eigh" in only:
            phase_eigh(torch, np, ct, ct.DEFAULT_CONFIG, dev, smi)
        if "orgqr_groups" in only:
            phase_orgqr_groups(torch, np, ct, dev)
        if "update" in only:
            phase_update(torch, np, ct, dev, smi)
        if "factor" in only:
            phase_factor(torch, np, ct, dev, smi)
        if "mixed" in only:
            phase_mixed_precision(torch, np, ct, dev, smi)
        if "bench" in only:
            phase_bench(torch, smi)
        if "stages" in only:
            phase_stages(torch, np, ct, dev, smi)
        if "precision" in only:
            phase_precision(torch, np, ct, dev, smi)
        if "slogdet" in only:
            phase_slogdet(torch, np, ct, ct.DEFAULT_CONFIG, dev)
        if "newton" in only:
            phase_newton(torch, np, ct, dev)
        if "geqrt_pair" in only:
            phase_build()
            phase_geqrt_batched(torch, np, dev)
            phase_geqrt_pair(torch, np, dev)
        say(json.dumps({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phase_build()
    chol = phase_chol(torch, np, dev)
    geqrt = phase_geqrt(torch, np, dev)
    geqrt_b = phase_geqrt_batched(torch, np, dev)
    geqrt_pair = phase_geqrt_pair(torch, np, dev)
    chol.update(phase_chol_stack(torch, np, ct, dev))
    select = phase_select(torch, np, dev)
    newton = phase_newton(torch, np, ct, dev)

    # ---- main path: 8192^2 float32 qr of a numpy array at DEFAULT_CONFIG (the
    # card is the default device), then geqrt 4096^2
    cfg = ct.DEFAULT_CONFIG
    if cfg.device != "cuda":
        raise AssertionError(f"DEFAULT_CONFIG.device is {cfg.device!r}, not the card")
    A_np = np.random.default_rng(12).standard_normal((N_MAIN, N_MAIN), dtype=np.float32)
    A = torch.from_numpy(A_np).to(dev)
    A4 = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (N_GEQRT, N_GEQRT), dtype=np.float32)).to(dev)
    gcfg = cfg.replace(panel_method="geqrt")
    torch.cuda.synchronize()
    chol_with_inv_kernel.launches = 0
    geqrt_base.launches = 0
    newton_certified_kernel.launches = 0
    smalllinalg.host_syncs = 0
    t0 = time.perf_counter()
    Q, R = ct.qr(A_np)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    del A_np
    if not (Q.device.type == "cuda" and R.device.type == "cuda"):
        raise AssertionError(f"ct.qr of numpy input at DEFAULT_CONFIG left Q on {Q.device}, "
                             f"R on {R.device}")
    chol_main, syncs_main = chol_with_inv_kernel.launches, smalllinalg.host_syncs
    t0 = time.perf_counter()
    fac4 = ct.qr_blocked(A4, gcfg)
    Q4, R4 = ct.orgqr(fac4, N_GEQRT, N_GEQRT, gcfg), ct.extract_r(fac4, N_GEQRT)
    torch.cuda.synchronize()
    t_geqrt = time.perf_counter() - t0
    launches = {"chol_inv": chol_with_inv_kernel.launches,
                "geqrt": geqrt_base.launches,
                "newton_inv": newton_certified_kernel.launches}
    say(f"main path: qr of numpy {N_MAIN}^2 f32 at DEFAULT_CONFIG -> Q, R on {Q.device}; "
        f"{cfg.panel_method} nb={cfg.panel_width} "
        f"lookahead={cfg.factor_lookahead}: {t_main:.3f} s first call (with the copy), "
        f"chol_inv launches {chol_main}, host syncs {syncs_main}")
    chk_main = ct.check_qr_device(A, Q, R)
    gate(f"qr {N_MAIN}^2 f32", chk_main)
    if chol_main < N_MAIN // cfg.panel_width:
        raise AssertionError(f"chol_inv launched {chol_main} times, expected >= "
                             f"{N_MAIN // cfg.panel_width} (one per panel)")
    require(launches["newton_inv"] == N_MAIN // cfg.panel_width,
            f"newton_inv launched {launches['newton_inv']} times, expected one a panel")
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
    slogdet_counts = phase_rank(torch, np, ct, cfg, dev)

    # ---- this slice's paths: TSQR (BASELINE config 3), qr_batched, decomp, update
    launches.update(phase_tsqr(torch, np, ct, dev, smi))
    phase_qr_batched(torch, np, ct, dev)
    phase_decomp(torch, np, ct, dev)
    phase_update(torch, np, ct, dev, smi)
    say("panel groups of orgqr (C5), k = 4 and 8:")
    orgqr_groups = phase_orgqr_groups(torch, np, ct, dev)
    say("the reference's panel-grouping ladder (scan_stages, stage_schedule, unrolled):")
    stages_counts = phase_stages(torch, np, ct, dev, smi)
    mixed_counts = phase_mixed_precision(torch, np, ct, dev, smi)
    precision_counts = phase_precision(torch, np, ct, dev, smi)

    # ---- the spectral family: randomized tools, QDWH polar and svd, QDWH-eig
    phase_rotation_bias(torch, dev)
    by_path = {"qr, geqrt, qr_pivoted, tsqr": dict(launches),
               "slogdet": slogdet_counts,
               "orgqr_groups": orgqr_groups,
               "mixed": mixed_counts,
               "stages": stages_counts,
               "precision": precision_counts,
               "rsvd": phase_rsvd(torch, np, ct, cfg, dev, smi),
               "polar_svd": phase_polar(torch, np, ct, cfg, dev, smi),
               "eigh": phase_eigh(torch, np, ct, cfg, dev, smi)}

    # ---- the command line (in process, then one subprocess) and complex QR
    say("command line (python -m cuda_qr_tpu_torch), in process:")
    by_path["cli"] = phase_cli(torch, np, ct, dev, smi)
    say("the headline record:")
    phase_bench(torch, smi)
    say("complex QR (Householder family; no kernel):")
    by_path["complex"] = phase_complex(torch, ct, dev, smi)
    say("the rest of complex input (pivoted QR, rank solvers, updates, spectral; no kernel):")
    by_path["complex_rest"] = phase_complex_rest(torch, ct, dev, smi)

    # ---- the distributed path (launches summed over its ranks)
    by_path["dist"] = phase_dist(torch, smi)
    for name, path_counts in by_path.items():
        say(f"path {name}: {counts_str({'host_syncs': '-', **path_counts})}")
    for kernel in launches:
        launches[kernel] = sum(c[kernel] for c in by_path.values())
    for name, needs in (("slogdet", ("chol_inv",)),
                        ("orgqr_groups", ("chol_inv", "geqrt")), ("mixed", ("chol_inv",)),
                        ("stages", ("chol_inv",)),
                        ("precision", ("chol_inv", "geqrt", "geqrt_batched", "select_pivots")),
                        ("rsvd", ("geqrt_batched", "select_pivots")),
                        ("polar_svd", ("chol_inv", "geqrt_batched")), ("eigh", ("chol_inv",)),
                        ("dist", ("chol_inv", "geqrt", "geqrt_batched")),
                        ("cli", ("chol_inv", "geqrt_batched", "select_pivots"))):
        for kernel in needs:
            if by_path[name][kernel] == 0:
                raise AssertionError(f"path {name} launched no {kernel} kernel")
    for name in ("complex", "complex_rest"):
        require(all(by_path[name][k] == 0 for k in launches),
                f"path {name} launched a kernel: {by_path[name]}")

    # ---- timings (informational)
    flops = qr_flops(N_MAIN, N_MAIN)
    t_fac, syncs_fac, t_qr = factor_timings(torch, ct, A)
    mixed = ct.MIXED_CONFIG
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
    say(f"  factor MIXED (3xTF32 trailing): {t_mixed:.2f} ms; residual {chk_m.residual:.3e} "
        f"(< n eps / {MIXED_RESID_DIV} = {N_MAIN * chk_m.eps / MIXED_RESID_DIV:.3e}), "
        f"orthogonality {chk_m.orthogonality:.3e} ({chk_m.orthogonality / chk_main.orthogonality:.3f}"
        f"x the main path's, <= {MIXED_ORTH_RATIO})")
    require(chk_m.ok and chk_m.residual < N_MAIN * chk_m.eps / MIXED_RESID_DIV,
            f"MIXED {N_MAIN}^2: residual {chk_m.residual} not under n eps / {MIXED_RESID_DIV}")
    require(chk_m.orthogonality <= MIXED_ORTH_RATIO * chk_main.orthogonality,
            f"MIXED {N_MAIN}^2: orthogonality {chk_m.orthogonality} over {MIXED_ORTH_RATIO}x "
            f"the main path's {chk_main.orthogonality}")
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
        {"name": "geqrt_batched", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/geqrt.cu",
         "replaces": "cuda_qr_tpu/ops/geqrt.py:38",
         "launches": launches["geqrt_batched"], **geqrt_b},
        {"name": "geqrt_pair", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/geqrt.cu",
         "replaces": "cuda_qr_tpu/ops/geqrt.py:38",
         "launches": launches["geqrt_pair"], **geqrt_pair},
        {"name": "geqrt_leaf", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/geqrt.cu",
         "replaces": "cuda_qr_tpu/ops/geqrt.py:38",
         "launches": launches["geqrt_leaf"],
         **{k: geqrt_b[k] for k in ("ms", "dense_ms", "library_ms", "bound_ms", "bound_by")}},
        {"name": "select_pivots", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/select_pivots.cu",
         "replaces": "cuda_qr_tpu/ops/pallas_select.py:40",
         "launches": launches["select_pivots"], **select,
         **select_bound(*SELECT_TILES[0][:3]), "library_ms": None},
        {"name": "newton_inv", "route": "cuda",
         "source": "cuda_qr_tpu_torch/csrc/newton_inv.cu",
         "replaces": "none: beside cuda_qr_tpu/ops/smalllinalg.py:newton_inverse (jnp)",
         "launches": launches["newton_inv"], **newton},
    ]
    for entry in kernels:
        entry["launches_by_path"] = {name: c[entry["name"]] for name, c in by_path.items()}
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
