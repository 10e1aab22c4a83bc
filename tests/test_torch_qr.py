"""The PyTorch port's ``qr`` entry point against the JAX reference: every
mode, the wide case, the gradient, and the package's independence of JAX.

fp64, panel width 32, the default cholqr2_bk panels in both packages; Q/R
agree to 1e-10 * max|A| (same algorithm, other summation order).
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.utils.config import matmul_precision

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

RCFG = ref.QRConfig(dtype=jnp.float64, panel_width=32, scan_stages=1)
CFG = ct.QRConfig(dtype=torch.float64, panel_width=32, device="cpu")
TOL = 1e-10
ROOT = Path(__file__).resolve().parent.parent


def close(a, b, scale=1.0):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= TOL * scale


@pytest.mark.parametrize("mode", ["reduced", "complete", "r"])
@pytest.mark.parametrize("shape", [(128, 80), (64, 128)], ids=["tall", "wide"])
def test_modes_match_reference(rng, mode, shape):
    A = rng.standard_normal(shape)
    out = ct.qr(A, CFG, mode=mode)
    rout = ref.qr(jnp.asarray(A), RCFG, mode=mode)
    if mode == "r":
        out, rout = (out,), (rout,)
    for a, b in zip(out, rout):
        close(a, b, np.abs(A).max())
    if mode != "r":
        Q, R = out
        np.testing.assert_allclose((Q @ R).numpy(), A, atol=1e-12)


def test_raw_mode_matches_reference(rng):
    A = rng.standard_normal((96, 64))
    h, tau = ct.qr(A, CFG, mode="raw")
    rh, rtau = ref.qr(jnp.asarray(A), RCFG, mode="raw")
    assert h.shape == (64, 96) and tau.shape == (64,)
    close(h, rh, np.abs(A).max())
    close(tau, rtau)
    with pytest.raises(ct.QRShapeError):
        ct.qr(A.T, CFG, mode="raw")


def test_qr_factor_handle(rng):
    A = rng.standard_normal((96, 64))
    B = rng.standard_normal((96, 4))
    res = ct.qr_factor(A, CFG)
    rres = ref.qr_factor(jnp.asarray(A), RCFG)
    close(res.Q, rres.Q)
    close(res.R, rres.R, np.abs(A).max())
    close(res.apply_qt(B), rres.apply_qt(jnp.asarray(B)), np.abs(B).max())
    np.testing.assert_allclose(res.apply_q(res.apply_qt(B)).numpy(), B, atol=1e-12)


def test_gradient_matches_jax(rng):
    A = rng.standard_normal((64, 48))
    W1 = rng.standard_normal((64, 48))
    W2 = rng.standard_normal((48, 48))

    def loss_ref(a):
        Q, R = ref.qr(a, RCFG)
        return jnp.sum(Q * W1) + jnp.sum(R * W2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(A)))
    At = torch.from_numpy(A).requires_grad_(True)
    Q, R = ct.qr(At, CFG)
    (Q * torch.from_numpy(W1)).sum().add((R * torch.from_numpy(W2)).sum()).backward()
    np.testing.assert_allclose(At.grad.numpy(), g_ref, atol=1e-9)


def test_batched_input(rng):
    A = rng.standard_normal((2, 3, 64, 32))
    Q, R = ct.qr(A, CFG)
    assert Q.shape == (2, 3, 64, 32) and R.shape == (2, 3, 32, 32)
    np.testing.assert_allclose((Q @ R).numpy(), A, atol=1e-12)
    assert ct.qr(A, CFG, mode="r").shape == (2, 3, 32, 32)


def test_complex_qr_pivoted_matches_reference(rng):
    """Complex ``qr_pivoted`` (tests/test_torch_complex_rank.py holds the
    rest of the family): with the reference's complex sketch, the same
    pivots and, in complex128, Q and R to 1e-10."""
    A = (rng.standard_normal((40, 24)) + 1j * rng.standard_normal((40, 24)))
    l = min(64, 32 + 32)           # the sketch of a 40-row input (64 padded) at nb = 32
    om = jax.random.normal(jax.random.key(12), (l, 64), dtype=jnp.complex128) / np.sqrt(l)
    Q, R, piv = ct.qr_pivoted(A, CFG, omega=np.array(om))
    rQ, rR, rpiv = ref.qr_pivoted(A, RCFG)
    np.testing.assert_array_equal(piv.numpy(), np.asarray(rpiv))
    assert Q.dtype == torch.complex128
    np.testing.assert_allclose(Q.numpy(), np.asarray(rQ), rtol=0, atol=1e-10)
    np.testing.assert_allclose(R.numpy(), np.asarray(rR), rtol=0, atol=1e-10 * np.abs(A).max())


def test_numpy_input_goes_to_config_device_and_dtype(rng):
    """Numpy input goes to the card by default; device="cpu" keeps it on
    the host."""
    assert ct.QRConfig().device == "cuda" and ct.DEFAULT_CONFIG.device == "cuda"
    A = rng.standard_normal((64, 32)).astype(np.float32)
    Q, R = ct.qr(A, ct.QRConfig(device="cpu"))
    assert Q.device.type == "cpu" and R.device.type == "cpu" and Q.dtype == torch.float32


def test_matmul_precision_sets_and_restores():
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    with pytest.raises(RuntimeError):
        with matmul_precision("tf32"):
            assert flags.allow_tf32 is True
            raise RuntimeError
    assert flags.allow_tf32 == saved
    ct.qr(np.eye(64, dtype=np.float32), ct.MIXED_CONFIG.replace(panel_width=32, device="cpu"))
    assert flags.allow_tf32 == saved


def test_import_leaves_jax_out():
    code = ("import sys, cuda_qr_tpu_torch, cuda_qr_tpu_torch.utils.interop; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cuda_qr_tpu.'))"
            " or m == 'cuda_qr_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "cuda_qr_tpu_torch").rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "cuda_qr_tpu"), (path, name)
