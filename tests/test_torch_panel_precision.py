"""Every GEMM's precision passed explicitly through ``ops.gemm.gemm``.

(a) Fault C11: the entry points under each of the five ways a caller can
    leave PyTorch's float32 GEMM mode set (``torch_caller_states.py``).
    Before the repair the port read and wrote the legacy ``allow_tf32`` flag
    around its GEMMs and raised RuntimeError in the two states set through
    the ``fp32_precision`` API.  Each call must return and leave both
    ``fp32_precision`` attributes as it found them.
(b) Routing: a ``TorchFunctionMode`` records every float32 GEMM made outside
    ``ops/gemm.py``; across the entry points there is none.
(c) ``QRConfig(precision="high")`` (the reference's Precision.HIGH on the
    panels) against the reference on the same input: the four panel methods,
    ``qr_pivoted`` on the reference's sketch and both TSQR leaves, within
    the tolerances of ``test_torch_blocked.py``, ``test_torch_qrcp.py`` and
    ``test_torch_tsqr.py`` (float32: 1e-4, relative to max|A| for R).
(d) Under ``test_torch_precision.py``'s TF32 emulator (operands rounded to
    TF32, float64 products), "high" panels keep "highest"'s accuracy and
    "tf32" panels lose it, so the panels reach the TF32 product.  Geometric
    means over seeds 0-3 at 256^2, nb 32, panel_base 8 (one intra-op
    thread), over "highest"'s, residual / orthogonality, by panel method
    (cholqr2_bk, cholqr2_hr, geqrt, geqr2): "high" everywhere 0.484-0.591x
    / 0.545-0.768x (the emulator's products are float64: only the operands'
    ~2^-22 rounding is left); "high" panels 0.887-0.995x / 0.843-1.027x;
    "tf32" panels 607-1824x / 1024-2154x.  Before the repair the CPU's
    "tf32" panels ran in IEEE float32 and read "highest"'s.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import cuda_qr_tpu as ref
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu.models import tsqr as ref_tsqr
from cuda_qr_tpu_torch.ops import gemm as gemm_mod
from cuda_qr_tpu_torch.ops import qrcp as pq
from cuda_qr_tpu_torch.utils.geometry import round_up
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from test_torch_precision import emulator
from torch_caller_states import CALLER_STATES, caller_state, fp32_reads
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

HIGH = jax.lax.Precision.HIGH
CPU = ct.QRConfig(panel_width=32, device="cpu")
METHODS = ["cholqr2_bk", "cholqr2_hr", "geqrt", "geqr2"]
TOL = 1e-4          # float32 agreement with the reference, as the existing files hold it
RATIO = 2.0         # "high" over "highest", geometric mean (test_torch_precision.TSQR_RATIO)
TF32_WORSE = 10.0   # "tf32" panels' orthogonality over "highest"'s, at least


def data(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- (a) C11: every entry point under every caller state

def _qr():
    return ct.qr(data((256, 256)), CPU)


def _qr_pivoted():
    return ct.qr_pivoted(data((256, 256)), CPU)


def _tsqr():
    return ct.tsqr(data((2048, 32)), CPU.replace(block_rows=256))


def _polar():
    return ct.polar(data((256, 64)), config=CPU)


def _backward():
    A = torch.from_numpy(data((256, 64))).requires_grad_()
    Q, R = ct.qr(A, CPU)
    (Q.sum() + R.sum()).backward()
    return A.grad


ENTRIES = {"qr": _qr, "qr_pivoted": _qr_pivoted, "tsqr": _tsqr, "polar": _polar,
           "backward": _backward}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("state", list(CALLER_STATES))
def test_entry_points_work_under_every_caller_state(state, entry):
    with caller_state(state):
        before = fp32_reads()
        out = ENTRIES[entry]()
        assert fp32_reads() == before
    outs = out if isinstance(out, tuple) else (out,)
    assert all(torch.isfinite(t).all() for t in outs if t.is_floating_point())


# -- (b) routing: no float32 GEMM outside ops.gemm

GEMMS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
         torch.mm, torch.Tensor.mm, torch.bmm, torch.Tensor.bmm, torch.einsum,
         torch.addmm, torch.Tensor.addmm, torch.Tensor.addmm_, torch.baddbmm,
         torch.Tensor.baddbmm, torch.mv, torch.Tensor.mv, torch.addmv, torch.tensordot,
         torch.linalg.matmul, torch.linalg.multi_dot, torch.chain_matmul}
TORCH_DIR = torch.__path__[0]


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from _tensors(a)


class GemmSpy(TorchFunctionMode):
    """Records each float32 GEMM called with no frame of ops/gemm.py on the
    stack, as (function name, file:line of the caller)."""

    def __init__(self):
        super().__init__()
        self.outside = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in GEMMS and any(t.dtype == torch.float32 for t in _tensors(args)):
            frame, caller = sys._getframe(1), None
            while frame is not None and frame.f_code.co_filename != gemm_mod.__file__:
                if caller is None and not frame.f_code.co_filename.startswith(TORCH_DIR):
                    caller = f"{frame.f_code.co_filename}:{frame.f_lineno}"
                frame = frame.f_back
            if frame is None:
                self.outside.append((getattr(func, "__name__", str(func)), caller))
        return func(*args, **(kwargs or {}))


def _lstsq():
    return ct.lstsq(data((256, 64)), data((256,), 1), CPU)


def _qr_update():
    Q, R = ct.qr(data((256, 64)), CPU)
    return ct.qr_update(Q, R, torch.from_numpy(data((256,), 1)),
                        torch.from_numpy(data((64,), 2)))


def _eigh():
    A = data((256, 256))
    return ct.eigh(A + A.T, CPU, base_n=64)


def _svd():
    return ct.svd(data((256, 64)), config=CPU)


def _rsvd():
    return ct.rsvd(data((256, 128)), 16, config=CPU)


ROUTED = {**ENTRIES, "lstsq": _lstsq, "qr_update": _qr_update, "eigh": _eigh, "svd": _svd,
          "rsvd": _rsvd}


def test_gemm_spy_sees_a_bare_product():
    a = torch.ones(4, 4)
    with GemmSpy() as spy:
        gemm_mod.gemm(a, a, "high")
        a @ a
        torch.einsum("ij,jk->ik", a, a)
    assert [name for name, _ in spy.outside] == ["matmul", "einsum"]


@pytest.mark.parametrize("entry", list(ROUTED))
def test_every_float32_gemm_goes_through_gemm(entry):
    with GemmSpy() as spy:
        ROUTED[entry]()
    assert spy.outside == []


# -- (c) precision=HIGH against the reference

def _check(A, Q, R):
    for pkg in (ref, ct):
        assert pkg.check_qr(A, np.asarray(Q), np.asarray(R)).ok


@pytest.mark.parametrize("method", METHODS)
def test_high_panels_match_reference(method):
    A = data((256, 96))
    m, n = A.shape
    rcfg = ref.QRConfig(dtype=jnp.float32, panel_width=32, panel_method=method, precision=HIGH,
                        use_pallas=method != "geqr2", scan_stages=1)
    cfg = config_from_reference(rcfg, device="cpu")
    assert cfg.precision == "high"
    rfac = ref.qr_blocked(jnp.asarray(A), rcfg)
    rQ, rR = np.asarray(ref.orgqr(rfac, m, n, rcfg)), np.asarray(ref.extract_r(rfac, n))
    fac = ct.qr_blocked(A, cfg)
    Q, R = ct.orgqr(fac, m, n, cfg).numpy(), ct.extract_r(fac, n).numpy()
    scale = np.abs(A).max()
    assert np.abs(Q - rQ).max() <= TOL
    assert np.abs(R - rR).max() <= TOL * scale
    assert np.abs(fac.packed.numpy() - np.asarray(rfac.packed)).max() <= TOL * scale
    _check(A, rQ, rR)
    _check(A, Q, R)


def test_high_pivoted_matches_reference():
    A = data((160, 128))
    nb = 32
    rcfg = ref.QRConfig(dtype=jnp.float32, panel_width=nb, precision=HIGH, scan_stages=2)
    cfg = config_from_reference(rcfg, device="cpu")
    rQ, rR, rpiv = (np.asarray(x) for x in ref.qr_pivoted(jnp.asarray(A), rcfg))
    m_pad = round_up(A.shape[0], nb)
    l = pq.sketch_rows(m_pad, nb)
    omega = jax.random.normal(jax.random.key(12), (l, m_pad), dtype=jnp.float32)
    omega = np.array(omega / jnp.sqrt(jnp.asarray(l, jnp.float32)))
    Q, R, piv = (x.numpy() for x in ct.qr_pivoted(A, cfg, omega=omega))
    np.testing.assert_array_equal(piv, rpiv)
    assert np.abs(Q - rQ).max() <= TOL
    assert np.abs(R - rR).max() <= TOL * np.abs(A).max()
    _check(A[:, rpiv], rQ, rR)
    _check(A[:, piv], Q, R)


@pytest.mark.parametrize("leaf", ["householder", "cholqr2"])
def test_high_tsqr_matches_reference(leaf):
    A = data((2048, 32))
    rcfg = ref.QRConfig(dtype=jnp.float32, precision=HIGH, use_pallas=False,
                        block_rows=256, tsqr_leaf=leaf)
    cfg = config_from_reference(rcfg, device="cpu").replace(use_kernels=True)
    rQ, rR = (np.asarray(x) for x in ref_tsqr.tsqr(jnp.asarray(A), rcfg))
    Q, R = (x.numpy() for x in ct.tsqr(A, cfg))
    assert np.abs(Q - rQ).max() <= TOL
    assert np.abs(R - rR).max() <= TOL * np.abs(A).max()
    _check(A, rQ, rR)
    _check(A, Q, R)


# -- (d) the panels reach the TF32 product

def gmean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def factor_check(A, cfg):
    n = A.shape[1]
    f = ct.qr_blocked(A, cfg)
    return ct.check_qr(A, ct.orgqr(f, A.shape[0], n, cfg), ct.extract_r(f, n))


@pytest.mark.parametrize("method", METHODS)
def test_high_panels_keep_highest_accuracy_under_tf32(monkeypatch, method):
    monkeypatch.setattr(gemm_mod, "_tf32_product", emulator("nearest"))
    base = CPU.replace(panel_method=method, panel_base=8)
    full = dict(trailing_precision="highest", orgqr_precision="highest")
    configs = {"highest": base, "high": base.replace(precision="high"),
               "high panels": base.replace(precision="high", **full),
               "tf32 panels": base.replace(precision="tf32", **full)}
    res = {k: [] for k in configs}
    orth = {k: [] for k in configs}
    for seed in range(4):
        A = data((256, 256), seed)
        for name, cfg in configs.items():
            chk = factor_check(A, cfg)
            res[name].append(chk.residual)
            orth[name].append(chk.orthogonality)
    for name in ("high", "high panels"):
        assert gmean(res[name]) <= RATIO * gmean(res["highest"]), (name, res)
        assert gmean(orth[name]) <= RATIO * gmean(orth["highest"]), (name, orth)
    assert gmean(orth["tf32 panels"]) >= TF32_WORSE * gmean(orth["highest"]), orth
