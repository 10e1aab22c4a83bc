"""Kernel B2 (geqrt) on the CPU: its plain PyTorch version against the
reference's Pallas kernel in interpret mode, the recursive panel, the batch
grid's plain version against per-panel geqr2 + larft, and the wrappers'
routing and validation.

float32 tolerances are the reference's own for the same comparison
(tests/test_geqrt.py: 2e-5 base, 5e-5 recursive).
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_qr_tpu.ops.geqrt import _geqrt_pallas, _geqrt_recursive
from cuda_qr_tpu.utils.config import QRConfig as RefConfig
from cuda_qr_tpu_torch.ops import geqrt as port
from cuda_qr_tpu_torch.ops.householder import geqr2, larft, unpack_v
from cuda_qr_tpu_torch.utils.config import QRConfig

from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REF = RefConfig(use_pallas=True, interpret=True)


def close(a, b, tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("m,w,off", [(64, 16, 0), (96, 16, 32), (128, 32, 96)])
def test_base_matches_pallas_interpret(rng, m, w, off):
    A = rng.standard_normal((m, w)).astype(np.float32)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(A), off)
    before = port.geqrt_base.launches
    packed, tau, T = port.geqrt_base(torch.from_numpy(A), off)
    assert port.geqrt_base.launches == before   # CPU: plain version
    close(packed, rp, 2e-5)
    assert torch.equal(packed[:off], torch.from_numpy(A[:off]))
    close(tau, rtau, 1e-5)
    close(T, rT, 2e-5)


@pytest.mark.parametrize("m,w", [(256, 32), (512, 128)])
def test_base_T_as_accurate_as_reference_kernel(m, w):
    """float32 T of the plain version against a float64 larft of its own V
    and tau, no further off than the reference's kernel's T (interpret
    mode) from its own: 1.1x, geometric mean over seeds 0-3.  T's rounding
    is its Gram's, which the kernels sum from partial sums."""
    def err(packed, tau, Tm):
        V = np.tril(np.asarray(packed, np.float64), -1) + np.eye(m, w)
        G, tau = V.T @ V, np.asarray(tau, np.float64)
        T64 = np.zeros((w, w))
        for j in range(w):
            T64[:j, j] = -tau[j] * T64[:j, :j] @ G[:j, j]
            T64[j, j] = tau[j]
        return np.linalg.norm(np.asarray(Tm, np.float64) - T64) / np.linalg.norm(T64)

    kernel = jax.jit(lambda a: _geqrt_pallas(a, 0, REF))
    ratios = []
    for seed in range(4):
        A = np.random.default_rng(seed).standard_normal((m, w)).astype(np.float32)
        packed, tau, T = port.geqrt_base(torch.from_numpy(A), 0)
        ratios.append(err(packed.numpy(), tau.numpy(), T.numpy())
                      / err(*kernel(jnp.asarray(A))))
    assert np.exp(np.log(ratios).mean()) <= 1.1, ratios


def test_zero_columns(rng):
    A = np.zeros((64, 16), np.float32)
    A[:, 3] = rng.standard_normal(64)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(A), 0)
    packed, tau, T = port.geqrt_base(torch.from_numpy(A), 0)
    assert torch.isfinite(packed).all() and torch.isfinite(T).all()
    close(packed, rp, 2e-5)
    close(tau, rtau, 1e-5)
    assert float(tau[0]) == 0.0


@pytest.mark.parametrize("base", [8, 16])
def test_recursive_matches_reference(rng, base):
    m, nb, off = 96, 32, 16
    A = rng.standard_normal((m, nb)).astype(np.float32)
    rcfg = REF.replace(panel_base=base)
    rp, rtau, rT = jax.jit(lambda a, o: _geqrt_recursive(a, o, rcfg))(jnp.asarray(A), off)
    packed, tau, T = port.geqrt_panel(torch.from_numpy(A), off, QRConfig(panel_base=base))
    close(packed, rp, 5e-5)
    close(tau, rtau, 5e-5)
    close(T, rT, 5e-5)


def test_geqrt_panel_bf16(rng):
    """bfloat16 storage through the panel contract (``blocked._panel_factor``):
    the geqrt panel is factored in float32 from the panel rounded to
    bfloat16, and the packed panel comes back in float32 holding bfloat16
    values."""
    from cuda_qr_tpu_torch.ops.blocked import _panel_factor
    A = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    cfg = QRConfig(dtype=torch.bfloat16, panel_method="geqrt")
    packed, tau, T, VJ = _panel_factor(A, 0, cfg)
    assert packed.dtype == tau.dtype == T.dtype == torch.float32
    assert torch.equal(packed, packed.bfloat16().float())
    assert torch.isfinite(packed).all()
    want = port.geqrt_panel(A.bfloat16().float(), 0, cfg)
    assert torch.equal(packed, want[0].bfloat16().float())
    assert torch.equal(tau, want[1]) and torch.equal(T, want[2])


@pytest.mark.parametrize("m,w,off", [(64, 16, 60), (300, 129, 0), (64, 16, -1)])
def test_base_rejects_what_the_kernel_does_not_take(m, w, off):
    with pytest.raises(ValueError):
        port.geqrt_base(torch.zeros((m, w)), off)


def test_non_cpu_tensor_never_takes_the_plain_version():
    with pytest.raises(ValueError, match="unsupported device"):
        port.geqrt_base(torch.empty((64, 16), device="meta"), 0)


@pytest.mark.parametrize("L,m,w,off,dtype", [(5, 64, 16, 0, np.float32),
                                             (3, 100, 30, 7, np.float64),
                                             (4, 40, 40, 0, np.float64)])
def test_batched_plain_matches_per_panel_geqr2_larft(rng, L, m, w, off, dtype):
    """The batch grid's plain version is geqr2 + larft of each panel; one
    panel is all zeros and another has a zero column."""
    P = rng.standard_normal((L, m, w)).astype(dtype)
    P[1] = 0.0
    P[2, :, 3] = 0.0
    before = port.geqrt_batched.launches
    packed, tau, T = port.geqrt_batched(torch.from_numpy(P), off)
    assert port.geqrt_batched.launches == before   # CPU: plain version
    tol = 2e-5 if dtype == np.float32 else 1e-12
    for b in range(L):
        lo, tb = geqr2(torch.from_numpy(P[b, off:]))
        Tb = larft(unpack_v(lo), tb)
        close(packed[b, off:], lo.numpy(), tol)
        assert torch.equal(packed[b, :off], torch.from_numpy(P[b, :off]))
        close(tau[b], tb.numpy(), tol)
        close(T[b], Tb.numpy(), tol)
    assert float(tau[1].abs().max()) == 0.0 and float(tau[2, 3]) == 0.0


def test_batched_plain_matches_pallas_interpret(rng):
    P = rng.standard_normal((3, 64, 16)).astype(np.float32)
    packed, tau, T = port.geqrt_batched_plain(torch.from_numpy(P), 8)
    for b in range(3):
        rp, rtau, rT = jax.jit(lambda a, o: _geqrt_pallas(a, o, REF))(jnp.asarray(P[b]), 8)
        close(packed[b], rp, 2e-5)
        close(tau[b], rtau, 1e-5)
        close(T[b], rT, 2e-5)


@pytest.mark.parametrize("shape,off", [((2, 64, 16), 60), ((2, 300, 129), 0),
                                       ((2, 64, 16), -1), ((2, 64, 0), 0)])
def test_batched_rejects_what_the_kernel_does_not_take(shape, off):
    with pytest.raises(ValueError):
        port.geqrt_batched(torch.zeros(shape), off)


def test_batched_gate_and_non_cpu_tensor():
    assert port.supported((1024, 1024, 128), torch.float32)
    assert port.supported((8, 2048, 77), torch.float64)
    assert not port.supported((2, 64, 129), torch.float32)
    assert not port.supported((2, 16, 32), torch.float32)
    assert not port.supported((2, 64, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        port.geqrt_batched(torch.empty((2, 64, 16), device="meta"), 0)


@pytest.mark.parametrize("m,w,off,dtype,kb,resident,body", [
    (1024, 128, 0, torch.float32, 32, False, "blocked"),   # TSQR leaf: the blocked body
    (256, 128, 0, torch.float32, 32, True, "resident"),    # TSQR node: held whole
    (256, 128, 0, torch.float64, 32, False, "subpanel"),   # float64 does not fit whole
    (397, 128, 0, torch.float32, 32, True, "resident"),    # the last m held whole ...
    (398, 128, 0, torch.float32, 32, False, "blocked"),    # ... and the first not
    (1553, 128, 0, torch.float32, 32, False, "subpanel"),  # the last m at kb = 32 ...
    (1554, 128, 0, torch.float32, 16, False, "subpanel"),  # ... and the first at kb = 16
    (8192, 32, 0, torch.float32, 4, False, "subpanel"),    # the tallest width that fits
    (8192, 32, 40, torch.float64, 0, False, "stream"),     # too tall: streaming body
    (2048, 77, 3, torch.float64, 8, False, "subpanel"),    # w not a multiple of kb
    (64, 20, 0, torch.float32, 20, True, "resident"),      # w < 32: one sub-panel of w
])
def test_plan_at_the_edges(m, w, off, dtype, kb, resident, body):
    p = port.plan(m, w, off, dtype)
    assert (p.kb, p.resident) == (kb, resident) and port.body(m, w, off, dtype) == body
    assert (p.slices >= 1) == (kb > 0) and p.blocked == (body == "blocked")


def test_blocked_body_takes_exactly_its_envelope():
    """Over a grid of shapes: the blocked body takes a float32 panel at
    off = 0 of at most 1,024 rows that the dense plan would give 32-column
    sub-panels not held whole, and no other; its layout fits the budget."""
    for dtype in (torch.float32, torch.float64):
        for m in (32, 64, 100, 256, 397, 398, 600, 800, 1000, 1021, 1024, 1025, 1553, 2048, 8192):
            for w in (1, 16, 31, 32, 33, 40, 64, 72, 77, 96, 100, 127, 128):
                for off in (0, 1, 5):
                    if off + w > m:
                        continue
                    p = port.plan(m, w, off, dtype)
                    dense = p._replace(blocked=False)
                    want = (dtype == torch.float32 and off == 0 and m <= port.BLOCKED_ROWS
                            and dense.kb == port.KB and not dense.resident)
                    assert p.blocked == want, (m, w, off, dtype)
                    assert (port.body(m, w, off, dtype) == "blocked") == want
                    if want:
                        assert 4 * port.blocked_words(m, w) <= port.SMEM_BUDGET


@pytest.mark.parametrize("m,w,off,dtype,want", [
    (1025, 128, 0, torch.float32, (32, False, 5)),     # a row past the envelope
    (1024, 128, 5, torch.float32, (32, False, 5)),     # a row offset
    (1024, 128, 0, torch.float64, (16, False, 4)),     # float64
    (397, 128, 0, torch.float32, (32, True, 1)),       # held whole
    (256, 128, 0, torch.float32, (32, True, 5)),       # a TSQR node
    (1024, 32, 0, torch.float32, (32, True, 16)),      # narrow: held whole
    (1024, 31, 0, torch.float32, (31, True, 16)),      # one sub-panel of w
    (8192, 128, 0, torch.float32, (4, False, 16)),     # the 8,192-row CAQR leaf
    (8192, 32, 0, torch.float32, (4, False, 16)),      # geqrt_panel's tall panel
    (8192, 32, 40, torch.float64, (0, False, 0)),      # the streaming body
])
def test_shapes_outside_the_envelope_keep_their_plan(m, w, off, dtype, want):
    """Every shape outside the blocked body's envelope keeps the plan it had
    before the blocked body existed (kb, residency, slices), not blocked."""
    assert port.plan(m, w, off, dtype) == port.Plan(*want, blocked=False)
    assert port.body(m, w, off, dtype) != "blocked"


def layout_words(rows, w, kb, ldp, slices):
    """The kernel's shared-memory layout (csrc/geqrt.cu), in elements."""
    return rows * ldp + 2 * port.KB * (port.KB + 1) + slices * kb * w + port.KB + port.RED_WORDS


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4), (torch.float64, 8)])
def test_plan_is_the_widest_that_fits(dtype, size):
    """Over a grid of shapes: the chosen layout fits the budget with its
    slices (one more slice would not, unless at the cap), residency is taken
    whenever it fits, and every wider sub-panel does not fit."""
    for m in (16, 100, 256, 397, 398, 1000, 1553, 1554, 3000, 5000, 8192, 12000, 20000):
        for w in (1, 3, 4, 16, 31, 32, 33, 64, 77, 100, 128):
            for off in (0, 5):
                if off + w > m:
                    continue
                rows, top = m - off, min(w, port.KB)
                p = port.plan(m, w, off, dtype)
                fits = [size * layout_words(rows, w, k, ldp, 1) <= port.SMEM_BUDGET
                        for k, ldp in [(top, w + 1)]
                        + [(k, k + 1) for k in (top, 16, 8, 4) if k <= top]]
                if p.resident:
                    assert fits[0] and p.kb == top
                else:
                    assert not fits[0]
                if p.kb:
                    ldp = w + 1 if p.resident else p.kb + 1
                    assert size * layout_words(rows, w, p.kb, ldp, p.slices) <= port.SMEM_BUDGET
                    assert (p.slices == port.MAX_SLICES or size * layout_words(
                        rows, w, p.kb, ldp, p.slices + 1) > port.SMEM_BUDGET)
                    assert p.kb in (top, 16, 8, 4) and p.kb <= top
                    assert not p.resident or p.kb == top
                else:
                    assert not any(fits)


def triangle_pairs(rng, L, w, dtype=np.float64):
    """L stacked pairs [R_i; R_j] of upper triangles (L x 2w x w)."""
    R = np.triu(rng.standard_normal((L, 2, w, w)))
    R[..., np.arange(w), np.arange(w)] += 2.0 * np.sqrt(w)
    return torch.from_numpy(R.reshape(L, 2 * w, w).astype(dtype))


@pytest.mark.parametrize("shape,off", [((2, 64, 16), 0), ((2, 32, 16), 1),
                                       ((2, 33, 16), 0), ((2, 32, 17), 0)])
def test_batched_pair_takes_only_a_pair(shape, off):
    """pair=True needs m = 2w and off = 0, on any device."""
    with pytest.raises(ValueError, match="pair=True"):
        port.geqrt_batched(torch.zeros(shape), off, pair=True)
    with pytest.raises(ValueError, match="pair=True"):
        port.geqrt_batched(torch.zeros(shape, device="meta"), off, pair=True)


def test_batched_pair_on_the_cpu_is_the_plain_version(rng):
    P = triangle_pairs(rng, 3, 16)
    P[1, 16:] = 0.0                                  # the odd level's phantom sibling
    before = (port.geqrt_batched.launches, port.geqrt_batched.pair_launches)
    got = port.geqrt_batched(P, 0, pair=True)
    assert (port.geqrt_batched.launches, port.geqrt_batched.pair_launches) == before
    for a, b in zip(got, port.geqrt_batched_plain(P, 0)):
        assert torch.equal(a, b)


def test_batched_counts_pair_launches(monkeypatch):
    """A launch of the pair body counts in ``launches`` and in
    ``pair_launches``; a dense launch only in ``launches`` (the launch itself
    stubbed: no card here)."""
    calls = []
    monkeypatch.setattr(port, "_check_device", lambda name, t: None)
    monkeypatch.setattr(port, "_launch", lambda name, A, lda, off, pair=False:
                        calls.append((tuple(A.shape), lda, off, pair)))
    P = torch.empty((4, 32, 16), device="meta")
    before = (port.geqrt_batched.launches, port.geqrt_batched.pair_launches)
    port.geqrt_batched(P, 0, pair=True)
    port.geqrt_batched(P, 0)
    assert calls == [((4, 32, 16), 16, 0, True), ((4, 32, 16), 16, 0, False)]
    assert (port.geqrt_batched.launches - before[0],
            port.geqrt_batched.pair_launches - before[1]) == (2, 1)


def _stub_library(monkeypatch):
    """The kernel library, the device and the stream stubbed (no card
    here): the calls made, as (entry, lda, arguments after the pointers)."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args[1], args[5:-1])) or 0

    monkeypatch.setattr(port._build, "load", Lib)
    monkeypatch.setattr(port.torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(port.torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("shape,lda,dtype,entry,args", [
    ((3, 1024, 128), 128, torch.float32, "cqt_geqrt_blocked_f32", (3, 1024, 128)),
    ((2, 1024, 77), 256, torch.float32, "cqt_geqrt_blocked_f32", (2, 1024, 77)),
    ((3, 1024, 128), 128, torch.float64, "cqt_geqrt_batched_f64", (3, 1024, 128, 0, 16, 0, 4)),
    ((3, 1025, 128), 128, torch.float32, "cqt_geqrt_batched_f32", (3, 1025, 128, 0, 32, 0, 5)),
])
def test_launch_takes_the_blocked_bodys_own_entry(monkeypatch, shape, lda, dtype, entry, args):
    """A blocked plan calls the blocked body's C entry with (batch, m, w)
    and the row stride; any other shape the dense entry with its plan."""
    calls = _stub_library(monkeypatch)
    port._launch("geqrt_batched", torch.empty(shape, dtype=dtype, device="meta"), lda, 0)
    assert calls == [(entry, lda, args)]


@pytest.mark.parametrize("shape,pair,leaf", [((4, 1024, 128), False, 1), ((4, 32, 16), False, 0),
                                             ((4, 256, 128), True, 0)])
def test_batched_counts_leaf_launches(monkeypatch, shape, pair, leaf):
    """A launch of the blocked body counts in ``launches`` and in
    ``leaf_launches``; a dense or pair launch only in ``launches`` (the
    launch itself stubbed: no card here)."""
    monkeypatch.setattr(port, "_check_device", lambda name, t: None)
    monkeypatch.setattr(port, "_launch", lambda name, A, lda, off, pair=False: None)
    before = (port.geqrt_batched.launches, port.geqrt_batched.leaf_launches)
    port.geqrt_batched(torch.empty(shape, device="meta"), 0, pair=pair)
    assert (port.geqrt_batched.launches - before[0],
            port.geqrt_batched.leaf_launches - before[1]) == (1, leaf)


@pytest.mark.parametrize("off,leaf", [(0, 1), (5, 0)])
def test_base_counts_leaf_launches(monkeypatch, off, leaf):
    """geqrt_base counts its blocked-body launches too: a 1,024 x 128
    float32 panel at off = 0 takes it, at off = 5 the dense body."""
    monkeypatch.setattr(port, "_check_device", lambda name, t: None)
    monkeypatch.setattr(port, "_launch", lambda name, A, lda, off, pair=False: (A[0], A[0], A[0]))
    before = (port.geqrt_base.launches, port.geqrt_base.leaf_launches)
    port.geqrt_base(torch.empty((1024, 128), device="meta"), off)
    assert (port.geqrt_base.launches - before[0],
            port.geqrt_base.leaf_launches - before[1]) == (1, leaf)


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (torch.float64, "f64")])
def test_launch_takes_the_pair_bodys_own_entry(monkeypatch, dtype, suffix, pair):
    """pair=True calls the pair body's C entry with (batch, w) and no plan;
    the dense body's entry gets the shape and ``plan``'s choice (the library
    and the stream stubbed: no card here)."""
    calls = _stub_library(monkeypatch)
    port._launch("geqrt_batched", torch.empty((3, 32, 16), dtype=dtype, device="meta"), 16, 0,
                 pair)
    p = port.plan(32, 16, 0, dtype)
    assert calls == ([(f"cqt_geqrt_pair_{suffix}", 16, (3, 16))] if pair else
                     [(f"cqt_geqrt_batched_{suffix}", 16,
                       (3, 32, 16, 0, p.kb, int(p.resident), p.slices))])


def test_batched_returns_contiguous_stack(rng):
    P = torch.from_numpy(rng.standard_normal((3, 48, 16)))
    packed, tau, T = port.geqrt_batched(P, 0)
    assert packed.is_contiguous() and tau.is_contiguous() and T.is_contiguous()
    assert packed.shape == (3, 48, 16) and T.shape == (3, 16, 16)
