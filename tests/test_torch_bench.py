"""The port's headline record, ``python -m cuda_qr_tpu_torch.bench``,
against the repo's ``bench.py``: the same keys (less the TPU link's ``*_net_ms``
and ``rtt_ms``, the geqrt phase's two renamed), every gate true on the CPU
at 256^2, no JAX, and accuracy within tests/test_torch_accuracy.py's bounds
of the reference run at ``bench.py``'s two configurations on the same
``default_rng(12)`` input (residual 1.2x, orthogonality 1.1x).  The
reference's CholeskyQR2 panels run its plain Cholesky
(``use_chol_kernel=False``), as in that file: the same arithmetic as its
Pallas kernel, not interpreted.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_qr_tpu.ops.blocked import extract_r, orgqr, qr_blocked
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch import bench

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = Path(__file__).resolve().parents[1]
N = 256
RESIDUAL_RATIO = 1.2
ORTH_RATIO = 1.1

# bench.py's record keys on the TPU, less the round-trip correction's
BENCH_PY_KEYS = {
    "metric", "value", "unit", "vs_baseline", "precision_mode", "steady_ms", "reps",
    "compile_s", "backend", "residual", "orthogonality", "verified_ok", "highest_ms",
    "highest_gflops", "highest_compile_s", "q_plus_r_ms", "q_plus_r_form",
    "q_plus_r_compile_s", "highest_residual", "highest_orthogonality", "highest_ok",
    "geqrt_mosaic_residual", "geqrt_mosaic_ok", "bf16_e2e_ms", "bf16_e2e_gflops",
    "bf16_e2e_size", "bf16_raw_residual", "bf16_raw_orthogonality", "bf16_refined_residual",
    "bf16_refined_orthogonality", "bf16_ok",
}
RENAMED = {"geqrt_mosaic_residual": "geqrt_kernel_residual",
           "geqrt_mosaic_ok": "geqrt_kernel_ok"}
GATES = ("verified_ok", "highest_ok", "geqrt_kernel_ok", "bf16_ok")


@pytest.fixture(scope="module")
def record():
    """The port's record at 256^2 on the CPU, in process: (rc, last JSON line)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--device", "cpu", "--size", str(N)])
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    """bench.py's MIXED and HIGHEST configurations through the reference on
    the same input: {name: (residual, orthogonality)}, bench.py's formulas."""
    A = jnp.asarray(np.random.default_rng(12).standard_normal((N, N)).astype(np.float32))
    H = jax.lax.Precision.HIGHEST
    cfg = RefConfig(dtype=jnp.float32, scan_stages=32, factor_lookahead=4,
                    use_chol_kernel=False)
    mcfg = cfg.replace(scan_stages=16, trailing_precision=jax.lax.Precision.HIGH)

    @jax.jit
    def metrics(A):
        out = []
        for fcfg in (mcfg, cfg):
            fac = qr_blocked(A, fcfg)
            Q, R = orgqr(fac, N, N, cfg), extract_r(fac, N)
            resid = jnp.linalg.norm(jnp.einsum("ij,jk->ik", Q, R, precision=H) - A) \
                / jnp.linalg.norm(A)
            orth = jnp.linalg.norm(jnp.einsum("ij,ik->jk", Q, Q, precision=H)
                                   - jnp.eye(N, dtype=A.dtype))
            out.append((resid, orth))
        return out

    (mr, mo), (hr, ho) = metrics(A)
    return {"mixed": (float(mr), float(mo)), "highest": (float(hr), float(ho))}


def test_record_has_bench_py_keys_and_passes_its_gates(record):
    rc, rec = record
    want = {RENAMED.get(k, k) for k in BENCH_PY_KEYS} | {"device"}
    assert set(rec) == want, (sorted(set(rec) - want), sorted(want - set(rec)))
    assert rc == 0
    assert all(rec[g] is True for g in GATES), {g: rec[g] for g in GATES}
    assert rec["metric"] == f"qr_gflops_{N}x{N}_fp32" and rec["backend"] == "cpu"
    assert rec["device"] == "cpu" and rec["reps"] == bench.HEADLINE_REPS
    assert rec["bf16_e2e_size"] == N
    eps = float(np.finfo(np.float32).eps)
    assert rec["residual"] < N * eps and rec["orthogonality"] < 4 * N * eps
    assert rec["geqrt_kernel_residual"] < bench.GEQRT_SHAPE[1] * eps
    assert rec["q_plus_r_ms"] >= rec["highest_ms"] > 0


@pytest.mark.parametrize("phase,keys", [("mixed", ("residual", "orthogonality")),
                                        ("highest", ("highest_residual",
                                                     "highest_orthogonality"))])
def test_as_accurate_as_reference_bench_configs(record, reference, phase, keys):
    _, rec = record
    resid, orth = (rec[k] for k in keys)
    ref_resid, ref_orth = reference[phase]
    assert resid <= RESIDUAL_RATIO * ref_resid, (resid, ref_resid)
    assert orth <= ORTH_RATIO * ref_orth, (orth, ref_orth)


def test_bench_runs_without_jax():
    """jax and the JAX package unimportable: the bench imports and runs (one
    intra-op thread, as the in-process tests)."""
    code = ("import sys; sys.modules.update({'jax': None, 'cuda_qr_tpu': None}); "
            "from cuda_qr_tpu_torch import bench; "
            "sys.exit(bench.main(['--device', 'cpu', '--size', '128']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(rec[g] is True for g in GATES)


def test_cuda_without_a_card_raises(capsys):
    """The default device is the card; without one, torch's own error and
    no record: nothing falls back to the host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises((AssertionError, RuntimeError)):
        bench.main(["--size", "64"])
    assert capsys.readouterr().out == ""
