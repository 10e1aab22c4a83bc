"""CholeskyQR2 panel factorizations of the PyTorch port against the JAX
reference.  Packed factors are compared only under the same panel_method
(the basis-kernel panel stores a dense, non-LAPACK V block).

fp64 agreement 1e-10: the same algorithm with other summation orders, and
CholeskyQR2 squares the panel's condition number.  fp32 1e-4 for the same
reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops import fast_panel as ref
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.ops import fast_panel as port
from cuda_qr_tpu_torch.ops import smalllinalg
from cuda_qr_tpu_torch.ops.householder import geqr2
from cuda_qr_tpu_torch.utils.config import QRConfig

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

CASES = {"f64": (np.float64, 1e-10), "f32": (np.float32, 1e-4)}


def configs(dt):
    if dt == np.float64:
        return RefConfig(dtype=jnp.float64), QRConfig(dtype=torch.float64)
    return RefConfig(dtype=jnp.float32), QRConfig(dtype=torch.float32)


def close(a, b, tol):
    b = np.asarray(b)
    assert np.abs(a.numpy() - b).max() <= tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("m,nb,off,case", [(96, 32, 0, "f64"), (256, 32, 128, "f64"),
                                           (128, 32, 32, "f32")])
def test_cholqr2bk_matches_reference(rng, m, nb, off, case):
    dt, tol = CASES[case]
    rcfg, cfg = configs(dt)
    A = rng.standard_normal((m, nb)).astype(dt)
    r = jax.jit(lambda a, o: ref.panel_factor_cholqr2bk(a, o, rcfg))(jnp.asarray(A), off)
    p = port.panel_factor_cholqr2bk(torch.from_numpy(A), off, cfg)
    for a, b in zip(p, r):     # packed, tau, T, VJ
        close(a, b, tol)
    assert torch.equal(p[0][:off], torch.from_numpy(A[:off]))


@pytest.mark.parametrize("m,nb,off", [(96, 32, 0), (96, 32, 16)])
def test_cholqr2hr_matches_reference(rng, m, nb, off):
    rcfg, cfg = configs(np.float64)
    A = rng.standard_normal((m, nb))
    r = jax.jit(lambda a, o: ref.panel_factor_cholqr2hr(a, o, rcfg))(jnp.asarray(A), off)
    p = port.panel_factor_cholqr2hr(torch.from_numpy(A), off, cfg)
    for a, b in zip(p, r):     # packed, tau, T
        close(a, b, 1e-10)
    # the reconstruction is a valid Householder representation of A
    packed, tau, T = (x.numpy() for x in p)
    V = np.tril(packed[off:], -1) + np.eye(m - off, nb)
    E = np.eye(m - off, nb)
    Qh = E - V @ (T @ (V.T @ E))
    assert np.abs(Qh.T @ Qh - np.eye(nb)).max() < 1e-13
    assert np.abs(Qh @ np.triu(packed[off:off + nb]) - A[off:]).max() < 1e-12


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr"])
def test_rank_deficient_panel_falls_back(rng, method):
    A = np.zeros((64, 16))
    A[:, 0] = rng.standard_normal(64)
    fn = getattr(port, "panel_factor_" + method.replace("_", ""))
    packed = fn(torch.from_numpy(A), 0, QRConfig(dtype=torch.float64))[0]
    assert torch.isfinite(packed).all()
    assert abs(float(packed[0, 0])) == pytest.approx(np.linalg.norm(A[:, 0]), rel=1e-12)


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr"])
def test_illconditioned_panel_takes_householder(rng, method):
    """cond(X) ~ 1e4 in fp32 loses orthogonality without NaNs; only the
    emax gate catches it and routes the panel to geqr2."""
    m, nb = 256, 32
    U, _ = np.linalg.qr(rng.standard_normal((m, nb)))
    V, _ = np.linalg.qr(rng.standard_normal((nb, nb)))
    A = ((U * np.logspace(0, -4, nb)) @ V.T).astype(np.float32)
    fn = getattr(port, "panel_factor_" + method.replace("_", ""))
    before = smalllinalg.host_syncs
    packed = fn(torch.from_numpy(A), 0, QRConfig())[0]
    assert smalllinalg.host_syncs > before
    expect, _ = geqr2(torch.from_numpy(A))
    assert torch.equal(packed, expect)


def test_bf16_panel_upcasts(rng):
    """bfloat16 storage through the panel contract (``blocked._panel_factor``):
    the basis-kernel panel is factored in float32 from the panel rounded to
    bfloat16, and the packed panel comes back in float32 holding bfloat16
    values; T and VJ stay float32."""
    from cuda_qr_tpu_torch.ops.blocked import _panel_factor
    A = torch.from_numpy(rng.standard_normal((128, 32)).astype(np.float32))
    cfg = QRConfig(dtype=torch.bfloat16)
    packed, tau, T, VJ = _panel_factor(A, 0, cfg)
    assert packed.dtype == T.dtype == VJ.dtype == torch.float32
    assert torch.equal(packed, packed.bfloat16().float())
    assert torch.isfinite(packed).all()
    want = port.panel_factor_cholqr2bk(A.bfloat16().float(), 0, cfg)
    assert torch.equal(packed, want[0].bfloat16().float())
    for a, b in zip((tau, T, VJ), want[1:]):
        assert torch.equal(a, b)


def _parent_cholqr2bk(panel, off, config):
    """The basis-kernel panel as it was before kernel B4: newton_inverse,
    then the certificate expression inline (float32 and float64 panels)."""
    from cuda_qr_tpu_torch.ops.gemm import gemm
    nb = panel.shape[1]
    prec = config.precision
    Q, Rpos, emax = port._cholqr2(panel[off:], config)
    eye = torch.eye(nb, dtype=panel.dtype)
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(panel.dtype)
    M = eye - s[:, None] * QJ
    N, _ = smalllinalg.newton_inverse(M, prec)
    errN = (eye - gemm(M, N, prec)).abs().max()
    cert = N.abs().max() ** 2 * errN
    if smalllinalg.host_decision(~(cert <= 100 * torch.finfo(panel.dtype).eps)):
        live, tau, T, VJ = port._hr_construct(Q, Rpos, config)
    else:
        T = N.T
        tau = torch.diagonal(T).clone()
        VJ = QJ - torch.diag(s)
        live = torch.cat([torch.triu(s[:, None] * Rpos), Q[nb:]], 0)
    if port._bad(live, T, emax):
        live, tau, T, VJ = port._householder_fallback(panel[off:], prec)
    return torch.cat([panel[:off], live], 0), tau, T, VJ


# (m, nb, off, seed, dtype, how the panel ends): a tall panel, near-square
# live rows, square last panels whose certificate fails (HR rebuild), a
# float64 panel, and a rank-deficient one (a NaN certificate sends it to HR,
# then the geqr2 fallback).
PARENT_CASES = [(1024, 32, 0, 0, np.float32, "bk"), (72, 32, 32, 1, np.float32, "bk"),
                (64, 32, 32, 4, np.float32, "hr"), (256, 128, 128, 6, np.float32, "hr"),
                (96, 32, 0, 0, np.float64, "bk"), (64, 16, 0, 0, np.float64, "hr+geqr2")]


@pytest.mark.parametrize("m,nb,off,seed,dt,ends", PARENT_CASES)
def test_cholqr2bk_on_the_cpu_is_the_parents_path(monkeypatch, m, nb, off, seed, dt, ends):
    """On the CPU the panel takes the plain twin of kernel B4: the same
    (packed, tau, T, VJ) bits and host syncs as before the kernel."""
    from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
    A = np.random.default_rng(seed).standard_normal((m, nb)).astype(dt)
    if ends == "hr+geqr2":
        A[:, 1:] = 0.0
    cfg = QRConfig(dtype=torch.float64) if dt == np.float64 else QRConfig()
    seen = {"hr": 0, "geqr2": 0}

    def spy(name, fn):
        def counted(*args):
            seen[name] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(port, "_hr_construct", spy("hr", port._hr_construct))
    monkeypatch.setattr(port, "_householder_fallback",
                        spy("geqr2", port._householder_fallback))
    launches = newton_certified_kernel.launches
    before = smalllinalg.host_syncs
    got = port.panel_factor_cholqr2bk(torch.from_numpy(A), off, cfg)
    syncs = smalllinalg.host_syncs - before
    taken = dict(seen)
    want = _parent_cholqr2bk(torch.from_numpy(A), off, cfg)
    assert smalllinalg.host_syncs - before == 2 * syncs
    assert newton_certified_kernel.launches == launches
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert {k: 2 * v for k, v in taken.items()} == seen
    assert taken == {"hr": int("hr" in ends), "geqr2": int("geqr2" in ends)}


@pytest.mark.parametrize("change,on_kernel", [
    ({}, True), ({"nb": 16}, True), ({"nb": 112}, True),
    ({"precision": "tf32"}, False), ({"precision": "high"}, False),
    ({"dtype": torch.float64}, False), ({"nb": 144}, False), ({"nb": 24}, False),
    ({"use_kernels": False}, False), ({"is_cuda": False}, False)])
def test_newton_routing(change, on_kernel):
    """Kernel B4 takes a float32 M on the card at "highest" of a side in
    [16, 128] that is a multiple of 16; anything else keeps the plain chain.
    M is a stand-in with the attributes the routing reads."""
    from types import SimpleNamespace

    from cuda_qr_tpu_torch.ops import newton_kernel
    nb = change.get("nb", 128)
    M = SimpleNamespace(shape=(nb, nb), dtype=change.get("dtype", torch.float32),
                        is_cuda=change.get("is_cuda", True))
    cfg = QRConfig(precision=change.get("precision", "highest"),
                   use_kernels=change.get("use_kernels", True))
    assert newton_kernel.on_kernel(M, cfg) is on_kernel
