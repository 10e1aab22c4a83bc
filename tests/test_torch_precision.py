"""The port's "high" precision (3xTF32), the counterpart of the reference's
``Precision.HIGH``, and MIXED_CONFIG's residual certificate.

There is no TF32 on the CPU, so the card's TF32 product is emulated: both
operands rounded to 10 explicit mantissa bits (to nearest, or truncated:
the hardware's conversion mode must not matter), multiplied in float64 and
rounded to float32.  The emulator replaces ``ops.gemm._tf32_product``, the
one function every TF32 pass goes through, so "tf32" and each of the three
passes of "high" see it; "highest" does not go through it.

Under the emulator one TF32 pass leaves MIXED's residual near 7e-4 at every
n (over the n*eps gate below n ~ 6,000), while 3xTF32 keeps it at
DEFAULT's.  Normwise GEMM error: ||C - C64||_F / (||A||_F ||B||_F).
"""

import jax
import numpy as np
import pytest
import torch

import cuda_qr_tpu as ref
import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops import gemm as gemm_mod
from cuda_qr_tpu_torch.ops.gemm import gemm, split_tf32
from cuda_qr_tpu_torch.utils.interop import config_from_reference

from torch_caller_states import CALLER_STATES, caller_state, fp32_reads
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

EPS = float(np.finfo(np.float32).eps)
RATIO = 1.1        # MIXED's residual and orthogonality over DEFAULT's, geometric mean
# The cholqr2 TSQR's Q pass (Q = A R^-1, K = n = 64) is set by how its
# operands are rounded, not by accumulation: 3xTF32 keeps lo to 11 bits, an
# input rounding of up to 2^-22 |x| against float32's 2^-24, so at cond 1 the
# emulated MIXED reads 1.60x DEFAULT's residual and 1.17-1.23x its
# orthogonality (1.01x and 0.94-0.99x at cond 100; one TF32 pass reads
# 4,600x and 4.7x).  It is held to the bound chip_smoke holds the same call
# to on the card.
TSQR_RATIO = 2.0


def round_tf32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """x (float32) at 10 explicit mantissa bits, by frexp in float64: to
    nearest (ties away from zero) or truncated toward zero."""
    m, e = torch.frexp(x.double())                  # x = m 2^e, 0.5 <= |m| < 1
    scaled = m * 2.0 ** 11
    if mode == "nearest":
        scaled = torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    m = torch.trunc(scaled) / 2.0 ** 11
    return torch.ldexp(m, e.double()).float()


def emulator(mode: str):
    def product(a, b):
        return (round_tf32(a, mode).double() @ round_tf32(b, mode).double()).float()
    return product


@pytest.fixture(params=["nearest", "truncate"])
def tf32(request, monkeypatch):
    monkeypatch.setattr(gemm_mod, "_tf32_product", emulator(request.param))
    return request.param


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


# -- (a) the split

def test_split_tf32_random():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(100_000),
        rng.standard_normal(10_000) * 10.0 ** rng.uniform(-30, 30, 10_000),
    ]).astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    assert np.array_equal(bits(hi + lo), bits(x))                  # exact, bit for bit
    assert (bits(hi) & 0x1FFF == 0).all()                          # a TF32 value
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()
    assert torch.equal(hi, round_tf32(x, "nearest"))               # rounded to nearest


def test_split_tf32_ties_round_away_from_zero():
    x = torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23],
                     dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0]
    assert torch.equal(hi + lo, x)


def test_split_tf32_special_values():
    tiny = float(np.finfo(np.float32).tiny)
    big = float(np.finfo(np.float32).max)
    x = torch.tensor([0.0, -0.0, tiny / 3, -tiny / 7, float("inf"), float("-inf"),
                      float("nan")], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert np.array_equal(bits(hi), bits(x))                       # passed through
    assert np.array_equal(bits(lo), np.zeros(len(x), np.int32))    # +0
    x = torch.tensor([big, -big, tiny, -tiny], dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert torch.isfinite(hi).all()                                # truncated, not inf
    assert np.array_equal(bits(hi + lo), bits(x))
    assert (bits(hi) & 0x1FFF == 0).all()
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()
    assert hi[0] < x[0] and hi[1] > x[1]


def test_split_tf32_strided():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 48), np.float32))
    hi, lo = split_tf32(x.mT)
    hc, lc = split_tf32(x.mT.contiguous())
    assert torch.equal(hi, hc) and torch.equal(lo, lc)


# -- (b) the product

def normwise(C, A, B):
    C64 = A.double() @ B.double()
    return float((C.double() - C64).norm() / (A.double().norm() * B.double().norm()))


@pytest.mark.parametrize("m,k,n", [(256, 32, 224), (1024, 128, 896)])
def test_gemm_high_error(tf32, m, k, n):
    rng = np.random.default_rng(m)
    A = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    B = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    err = {p: normwise(gemm(A, B, p), A, B) for p in ("highest", "tf32", "high")}
    assert err["high"] <= 2.0 ** -19
    assert err["high"] <= err["tf32"] / 64
    assert err["tf32"] > 2.0 ** -17                   # the emulator did reach "tf32"


@pytest.mark.parametrize("k", [512, 640, 2176])
def test_gemm_high_sums_long_k_in_chunks(monkeypatch, k):
    """hi_a hi_b runs as one batched TF32 product of K_CHUNK-deep chunks
    (plus the remainder's), summed in float32; batched operands broadcast."""
    calls = []
    product = emulator("nearest")

    def spy(a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return product(a, b)

    monkeypatch.setattr(gemm_mod, "_tf32_product", spy)
    rng = np.random.default_rng(k)
    c, q = gemm_mod.K_CHUNK, k // gemm_mod.K_CHUNK
    for a_shape, b_shape in (((48, k), (k, 40)), ((3, 48, k), (k, 40)), ((48, k), (2, k, 40))):
        A = torch.from_numpy(rng.standard_normal(a_shape, np.float32))
        B = torch.from_numpy(rng.standard_normal(b_shape, np.float32))
        calls.clear()
        C = gemm(A, B, "high")
        assert C.shape == (A @ B).shape
        assert normwise(C, A, B) <= 2.0 ** -19
        assert calls[2] == (a_shape[:-2] + (q, 48, c), b_shape[:-2] + (q, c, 40))
        assert len(calls) == 3 + (k % c != 0)


def test_gemm_batched_and_other_dtypes(tf32):
    rng = np.random.default_rng(3)
    A = torch.from_numpy(rng.standard_normal((3, 40, 16), np.float32))
    B = torch.from_numpy(rng.standard_normal((16, 24), np.float32))
    C = gemm(A, B, "high")
    assert C.shape == (3, 40, 24)
    assert normwise(C, A, B) <= 2.0 ** -19
    for dtype in (torch.float64, torch.complex64, torch.complex128):
        A2, B2 = A.to(dtype), B.to(dtype)
        assert torch.equal(gemm(A2, B2, "high"), A2 @ B2)      # precision ignored
    with pytest.raises(ValueError, match="precision"):
        gemm(A, B, "bf16x3")


# -- (c), (d) MIXED keeps DEFAULT's residual

def gmean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def factor_check(A, cfg):
    n = A.shape[1]
    f = ct.qr_blocked(A, cfg)
    return ct.check_qr(A, ct.orgqr(f, A.shape[0], n, cfg), ct.extract_r(f, n))


@pytest.mark.parametrize("n,nb,seeds", [(512, 64, (0, 1, 2, 3)), (1024, 128, (0, 1))])
def test_mixed_factor_keeps_the_residual_certificate(tf32, n, nb, seeds):
    base = dict(panel_width=nb, device="cpu")
    checks = {name: [] for name in ("default", "mixed", "tf32")}
    for seed in seeds:
        A = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
        checks["default"].append(factor_check(A, ct.DEFAULT_CONFIG.replace(**base)))
        checks["mixed"].append(factor_check(A, ct.MIXED_CONFIG.replace(**base)))
    A = np.random.default_rng(seeds[0]).standard_normal((n, n)).astype(np.float32)
    one_pass = factor_check(A, ct.QRConfig(trailing_precision="tf32", **base))
    assert one_pass.residual > n * EPS / 10           # the fault, under the same emulator
    res = {k: [c.residual for c in v] for k, v in checks.items() if v}
    orth = {k: [c.orthogonality for c in v] for k, v in checks.items() if v}
    assert max(res["mixed"]) < n * EPS / 10
    assert gmean(res["mixed"]) <= RATIO * gmean(res["default"])
    assert gmean(orth["mixed"]) <= RATIO * gmean(orth["default"])


@pytest.mark.parametrize("cond", [1.0, 100.0])
def test_mixed_cholqr2_tsqr_keeps_the_residual_certificate(tf32, cond):
    m, n = 16384, 64
    res, orth = {"default": [], "mixed": [], "tf32": []}, {"default": [], "mixed": [], "tf32": []}
    for seed in (0, 1, 2, 3):
        rng = np.random.default_rng(seed)
        A = rng.standard_normal((m, n))
        if cond != 1.0:
            U, _ = np.linalg.qr(A)
            V, _ = np.linalg.qr(rng.standard_normal((n, n)))
            A = (U * np.geomspace(1.0, 1.0 / cond, n)) @ V.T
        A = A.astype(np.float32)
        for name, cfg in (("default", ct.DEFAULT_CONFIG), ("mixed", ct.MIXED_CONFIG),
                          ("tf32", ct.QRConfig(trailing_precision="tf32"))):
            chk = ct.check_qr(A, *ct.tsqr(A, cfg.replace(tsqr_leaf="cholqr2", device="cpu")))
            res[name].append(chk.residual)
            orth[name].append(chk.orthogonality)
    assert max(res["mixed"]) < n * EPS / 10 < min(res["tf32"])
    assert gmean(res["mixed"]) <= TSQR_RATIO * gmean(res["default"])
    assert gmean(orth["mixed"]) <= TSQR_RATIO * gmean(orth["default"])


# -- (e) the mappings

def test_precision_mappings():
    assert ct.MIXED_CONFIG.trailing_precision == "high"
    assert ct.MIXED_CONFIG.precision == ct.MIXED_CONFIG.resolved_orgqr_precision() == "highest"
    assert config_from_reference(ref.MIXED_CONFIG, device="cpu").trailing_precision == "high"
    cfg = config_from_reference(ref.QRConfig(precision=jax.lax.Precision.DEFAULT), device="cpu")
    assert cfg.precision == "tf32"
    cfg = config_from_reference(ref.QRConfig(orgqr_precision=jax.lax.Precision.HIGH),
                                device="cpu")
    assert cfg.orgqr_precision == "high"
    ct.QRConfig(orgqr_precision="high")
    assert ct.QRConfig(precision="high").precision == "high"
    cfg = config_from_reference(ref.QRConfig(precision=jax.lax.Precision.HIGH), device="cpu")
    assert cfg.precision == cfg.resolved_trailing_precision() == "high"


# -- (f) the TF32 mode

def ieee(mode: str) -> str:
    """The mode cuBLAS runs in: "none" (nothing set anywhere) is IEEE."""
    return "ieee" if mode == "none" else mode


@pytest.mark.parametrize("start", list(CALLER_STATES))
def test_gemm_sets_tf32_around_its_passes_and_restores_it(monkeypatch, start):
    """Each pass sees the mode it asked for in
    ``torch.backends.cuda.matmul.fp32_precision``, and the caller's state
    comes back, also when a pass raises, whichever of the five caller states
    was set.  "high" is one pass up to K_CHUNK (the operands concatenated
    along K), three past it."""
    flags = torch.backends.cuda.matmul
    with caller_state(start):
        before = fp32_reads()
        seen, fail = [], []
        matmul = torch.matmul

        def spy(a, b):
            seen.append(ieee(flags.fp32_precision))
            if fail:
                raise RuntimeError("pass failed")
            return matmul(a, b)

        monkeypatch.setattr(torch, "matmul", spy)
        S, L = torch.ones((8, 4)), torch.ones((8, 2 * gemm_mod.K_CHUNK))
        for A, precision, expect in ((S, "highest", ["ieee"]), (S, "tf32", ["tf32"]),
                                     (S, "high", ["tf32"]), (L, "high", ["tf32"] * 3)):
            seen.clear()
            gemm(A, A.T, precision)
            assert seen == expect and fp32_reads() == before
        fail.append(True)
        for A, precision in ((S, "highest"), (S, "high"), (L, "high")):
            with pytest.raises(RuntimeError, match="pass failed"):
                gemm(A, A.T, precision)
            assert fp32_reads() == before
        monkeypatch.undo()
        ct.qr(np.eye(64, dtype=np.float32), ct.MIXED_CONFIG.replace(panel_width=32, device="cpu"))
        assert fp32_reads() == before
