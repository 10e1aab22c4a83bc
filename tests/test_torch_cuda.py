"""The CUDA kernels and the port's main path on an NVIDIA GPU.

Needs a card: every test here is marked ``cuda`` and skips without one.  On
a machine with a card and without JAX (tests/conftest.py imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same device.
float32 1e-4 relative: other summation orders, and L^{-1} amplifies by
cond(G); float64 1e-10.  The pivot selection's order must be identical on
tiles whose greedy steps are separated (relative gap >= 1e-5 between the
largest norm and the next distinct one, checked in float64), since float32
rounding moves a norm by ~1e-7.
"""

import numpy as np
import pytest
import torch

import cuda_qr_tpu_torch as ct
from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_kernel
from cuda_qr_tpu_torch.ops.geqrt import (geqrt_base, geqrt_base_plain, geqrt_batched,
                                        geqrt_batched_plain)
from cuda_qr_tpu_torch.ops.qrcp import qrcp_blocked
from cuda_qr_tpu_torch.ops.select_kernel import (select_pivots_kernel, select_pivots_plain,
                                                 selection_margin)
from cuda_qr_tpu_torch.ops.smalllinalg import chol_with_inv_auto, cholesky_with_inv

pytestmark = pytest.mark.cuda
TOLS = {torch.float32: 1e-4, torch.float64: 1e-10}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("nb,dtype", [(16, torch.float32), (32, torch.float32),
                                      (48, torch.float32), (100, torch.float32),
                                      (128, torch.float32), (160, torch.float32),
                                      (192, torch.float32), (512, torch.float32),
                                      (128, torch.float64), (300, torch.float64)])
def test_chol_inv_kernel_matches_plain(dev, nb, dtype):
    """Block edges (32, 48, 100), the largest float32 side held in shared
    memory (160), the first past it (192) and the largest side (512)."""
    rng = np.random.default_rng(nb)
    B = rng.standard_normal((nb, nb))
    G = torch.from_numpy(B @ B.T + nb * np.eye(nb)).to(dev, dtype)
    before = chol_with_inv_kernel.launches
    L, Li = chol_with_inv_kernel(G)
    Lp, Lip = cholesky_with_inv(G)
    assert chol_with_inv_kernel.launches == before + 1
    assert rel(L, Lp) < TOLS[dtype] and rel(Li, Lip) < TOLS[dtype]
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.triu(Li, 1), torch.zeros_like(Li))
    eye = torch.eye(nb, dtype=torch.float64, device=dev)
    assert float((L.double() @ Li.double() - eye).abs().max()) < TOLS[dtype]


@pytest.mark.parametrize("b,nb", [(4096, 64), (300, 128), (5, 40)])
def test_chol_inv_kernel_stack_matches_plain(dev, b, nb):
    B = torch.from_numpy(np.random.default_rng(b).standard_normal((b, nb, 2 * nb))).to(dev)
    G = (B @ B.mT / (2 * nb)).float()
    L, Li = chol_with_inv_kernel(G)
    Lp, Lip = cholesky_with_inv(G)
    assert rel(L, Lp) < 1e-4 and rel(Li, Lip) < 1e-4


def test_chol_inv_kernel_non_pd_and_rejects(dev):
    L, Li = chol_with_inv_kernel(-torch.eye(32, device=dev))
    assert not torch.isfinite(L).all()
    with pytest.raises(TypeError):
        chol_with_inv_kernel(torch.eye(32, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        chol_with_inv_kernel(torch.eye(513, device=dev))


@pytest.mark.parametrize("m,w,off,dtype", [(256, 32, 0, torch.float32),
                                           (4096, 32, 40, torch.float32),
                                           (8192, 32, 0, torch.float32),
                                           (8192, 32, 40, torch.float64),
                                           (1000, 77, 3, torch.float32),
                                           (2048, 32, 0, torch.float64)])
def test_geqrt_kernel_matches_plain(dev, m, w, off, dtype):
    """Both bodies (8192 x 32 float64 at off 40 streams), a zero column,
    and the rows above off bit-equal to the input."""
    P = torch.from_numpy(np.random.default_rng(m).standard_normal((m, w))).to(dev, dtype)
    P[:, 2] = 0
    before = geqrt_base.launches
    got = geqrt_base(P, off)
    want = geqrt_base_plain(P, off)
    assert geqrt_base.launches == before + 1
    for a, b in zip(got, want):
        assert torch.isfinite(a).all() and rel(a, b) < TOLS[dtype]
    assert torch.equal(got[0][:off], P[:off]) and float(got[1][2]) == 0.0


def test_geqrt_kernel_reads_a_column_slice_in_place(dev):
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((600, 96))).to(dev)
    got = geqrt_base(A[:, 32:64], 5)
    want = geqrt_base_plain(A[:, 32:64].contiguous(), 5)
    for a, b in zip(got, want):
        assert rel(a, b) < TOLS[torch.float64]


@pytest.mark.parametrize("method", ["cholqr2_bk", "cholqr2_hr", "geqrt"])
def test_qr_on_the_card(dev, method):
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1024, 768), dtype=np.float32)).to(dev)
    cfg = ct.QRConfig(panel_method=method, device="cuda")
    launches = chol_with_inv_kernel.launches + geqrt_base.launches
    Q, R = ct.qr(A, cfg)
    assert Q.device == A.device
    assert chol_with_inv_kernel.launches + geqrt_base.launches > launches
    assert ct.check_qr_device(A, Q, R).ok
    assert ct.check_qr(A, Q, R).ok


def gaussian_tile(dev, l, cand, seed):
    S = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (l, cand), dtype=np.float32)).to(dev)
    return S, (S.double() ** 2).sum(0).float()


@pytest.mark.parametrize("l,cand,nb,seed", [(160, 512, 128, 5), (64, 128, 32, 1),
                                            (288, 1024, 256, 0), (224, 768, 192, 4),
                                            (32, 64, 16, 2)])
def test_select_kernel_matches_plain(dev, l, cand, nb, seed):
    """chip_smoke's tiles and two more, so that every row count a lane
    holds (R = 4, 12, 20, 28, 36) and the narrowest slice (64 columns, 8 a
    CTA) run."""
    S, norms = gaussian_tile(dev, l, cand, seed)
    S0 = S.clone()
    assert selection_margin(S, norms, nb) >= 1e-5
    before = select_pivots_kernel.launches
    got = select_pivots_kernel(S, norms, nb)
    assert select_pivots_kernel.launches == before + 1
    assert torch.equal(got, select_pivots_plain(S, norms, nb))
    assert torch.equal(S, S0)
    assert torch.equal(torch.sort(got[got >= 0]).values,
                       torch.arange(nb, dtype=torch.int32, device=dev))


def test_select_kernel_tie_across_ctas(dev):
    """Three copies of the largest column at 63, 64 (the first columns of
    ranks 0 and 1 of the cluster's 64-column slices) and 500 (rank 7): the
    lowest global index wins."""
    S, norms = gaussian_tile(dev, 160, 512, 5)
    S[:, [63, 64, 500]] = 2 * S[:, [int(torch.argmax(norms))]]
    norms = (S.double() ** 2).sum(0).float()
    assert selection_margin(S, norms, 128) >= 1e-5
    got = select_pivots_kernel(S, norms, 128)
    assert torch.equal(got, select_pivots_plain(S, norms, 128))
    assert int(got[63]) == 0 and int(got[64]) == -1 and int(got[500]) == -1


def test_select_kernel_stops_at_a_nan_norm(dev):
    """A NaN in column 200 of S turns its norm NaN after step 0's
    downdate: step 0 agrees with the plain version, and from step k = 1 on
    nothing is picked, as the reference's Pallas kernel does (the plain
    version, the reference's jnp loop, picks the NaN column)."""
    S, norms = gaussian_tile(dev, 160, 512, 5)
    S[17, 200] = float("nan")
    k = 1
    assert selection_margin(S, norms, k) >= 1e-5
    got = select_pivots_kernel(S, norms, 128)
    want = select_pivots_plain(S, norms, 128)
    assert torch.equal(got, torch.where((want >= 0) & (want < k), want, -1))
    assert int((got >= 0).sum()) == k


@pytest.mark.parametrize("l,cand", [(1024, 1024), (512, 1024), (296, 512), (160, 96)])
def test_select_kernel_rejects_tiles_out_of_range(dev, l, cand):
    """Tiles the reference's gate admits but QRCP never makes raise rather
    than take the plain version."""
    S, norms = gaussian_tile(dev, l, cand, 0)
    before = select_pivots_kernel.launches
    with pytest.raises(ValueError, match="multiple of 64"):
        select_pivots_kernel(S, norms, 8)
    assert select_pivots_kernel.launches == before


def test_select_kernel_ties_and_rejects(dev):
    S = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (160, 512), dtype=np.float32)).to(dev)
    S[:, [40, 300]] = S[:, [7, 7]]
    S[:, [3, 200, 511]] = 0
    norms = (S.double() ** 2).sum(0).float()
    norms[::3] = -1
    assert selection_margin(S, norms, 128) >= 1e-5
    got = select_pivots_kernel(S, norms, 128)
    assert torch.equal(got, select_pivots_plain(S, norms, 128))
    assert (got[::3] == -1).all()
    with pytest.raises(TypeError):
        select_pivots_kernel(S.double(), norms.double(), 8)
    with pytest.raises(ValueError):
        select_pivots_kernel(S.t().contiguous().t(), norms, 8)
    with pytest.raises(ValueError):
        big = torch.zeros((2048, 1024), device=dev)
        select_pivots_kernel(big, big[0].contiguous(), 8)


def test_qrcp_mixed_config_equals_default(dev):
    """QRCP runs every GEMM at ``precision``, as the reference does, so
    MIXED_CONFIG (trailing TF32 in qr_blocked) gives the same pivots and the
    same packed factors as DEFAULT_CONFIG: nothing in the panel reads the
    trailing precision."""
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1024, 768), dtype=np.float32)).to(dev)
    fd, jd, _ = qrcp_blocked(A, ct.DEFAULT_CONFIG)
    fm, jm, _ = qrcp_blocked(A, ct.MIXED_CONFIG)
    assert torch.equal(jd, jm)
    for a, b in zip(fd, fm):
        assert torch.equal(a, b)


def test_qr_pivoted_on_the_card(dev):
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1024, 768), dtype=np.float32)).to(dev)
    cfg = ct.QRConfig(device="cuda")
    before = select_pivots_kernel.launches
    Q, R, piv = ct.qr_pivoted(A, cfg)
    assert select_pivots_kernel.launches == before + 768 // cfg.panel_width
    assert torch.equal(torch.sort(piv).values, torch.arange(768, device=dev))
    assert ct.check_qr_device(A[:, piv], Q, R).ok


@pytest.mark.parametrize("L,m,w,off,dtype", [(64, 256, 128, 0, torch.float32),
                                             (1024, 1024, 128, 0, torch.float32),
                                             (8, 2048, 77, 3, torch.float64),
                                             (33, 1024, 32, 0, torch.float32),
                                             (4, 397, 128, 0, torch.float32),
                                             (4, 398, 128, 0, torch.float32),
                                             (4, 1553, 128, 0, torch.float32),
                                             (4, 1554, 128, 0, torch.float32),
                                             (6, 256, 128, 9, torch.float64),
                                             (64, 1024, 72, 0, torch.float32),
                                             (32, 144, 72, 0, torch.float32)])
def test_geqrt_batched_kernel_matches_plain(dev, L, m, w, off, dtype):
    """The TSQR leaf and node stacks, w = 77 (not a multiple of kb = 8), the
    edge of the resident panel (m = 397 / 398) and of the sub-panel width
    (kb 32 -> 16 between m = 1553 and 1554), a zero panel (tau = 0) and a
    zero column; the leaves and a tree level of rsvd's thin QRs at k + p = 72."""
    P = torch.from_numpy(np.random.default_rng(L).standard_normal((L, m, w))).to(dev, dtype)
    P[1] = 0
    P[2, :, 5] = 0
    before = geqrt_batched.launches
    got = geqrt_batched(P, off)
    want = geqrt_batched_plain(P, off)
    assert geqrt_batched.launches == before + 1
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.isfinite(a).all() and rel(a, b) < TOLS[dtype]
    assert torch.equal(got[0][:, :off], P[:, :off])
    assert float(got[1][1].abs().max()) == 0.0 and float(got[1][2, 5]) == 0.0


def test_chol_stack_through_auto_launches_once(dev):
    B = torch.from_numpy(np.random.default_rng(3).standard_normal((256, 64, 128))).to(dev)
    G = (B @ B.mT / 128).float()
    before = chol_with_inv_kernel.launches
    L, Li = chol_with_inv_auto(G, ct.QRConfig(device="cuda"))
    assert chol_with_inv_kernel.launches == before + 1
    Lp, Lip = cholesky_with_inv(G)
    assert rel(L, Lp) < 1e-4 and rel(Li, Lip) < 1e-4


@pytest.mark.parametrize("leaf", ["householder", "cholqr2"])
def test_tsqr_on_the_card(dev, leaf):
    A = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (65536, 128), dtype=np.float32)).to(dev)
    cfg = ct.QRConfig(device="cuda", tsqr_leaf=leaf)
    before = (geqrt_batched.launches, chol_with_inv_kernel.launches)
    Q, R = ct.tsqr(A, cfg)
    launched = (geqrt_batched.launches - before[0], chol_with_inv_kernel.launches - before[1])
    chk = ct.check_qr_device(A, Q, R)
    assert chk.residual_ok
    if leaf == "householder":
        assert launched[0] == 7 and chk.orthogonality_ok      # 64 leaves, 6 levels
    else:
        # the direct path's own gate, 4 sqrt(m) eps: the Gram's rounding floor
        assert launched[1] >= 1 and chk.orthogonality < 4 * 65536 ** 0.5 * chk.eps
    Rr = ct.tsqr_r(A, cfg)
    assert rel(Rr, R) < 1e-4


def test_qr_batched_on_the_card(dev):
    A = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (512, 256, 64), dtype=np.float32)).to(dev)
    before = chol_with_inv_kernel.launches
    Q, R = ct.qr_batched(A, ct.QRConfig(device="cuda"))
    assert chol_with_inv_kernel.launches - before == 3          # one per round
    assert (torch.diagonal(R, 0, -2, -1) > 0).all()
    for b in (0, 511):
        assert ct.check_qr_device(A[b], Q[b], R[b]).ok


def test_update_chains_take_no_host_sync(dev):
    """The Givens chains keep every coefficient on the card: with sync debug
    mode set to error, any synchronizing operation in a chain raises."""
    rng = np.random.default_rng(17)
    A = torch.from_numpy(rng.standard_normal((512, 64), dtype=np.float32)).to(dev)
    Q, R = ct.qr(A, ct.QRConfig(device="cuda"))
    u, v = torch.randn(512, device=dev), torch.randn(64, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [ct.qr_rank1_update(Q, R, u, v), ct.qr_row_insert(Q, R, v, 7),
                ct.qr_row_delete(Q, R, 7), ct.qr_col_insert(Q, R, u, 7),
                ct.qr_col_delete(Q, R, 7)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ct.check_qr_device(A + torch.outer(u, v), *outs[0]).ok


def test_polar_launches_chol_inv_and_equals_plain_path(dev):
    """QDWH's Cholesky steps at n = 256 run on the chol_inv kernel, one
    launch a step, and give the polar factors of the kernel-free path."""
    from cuda_qr_tpu_torch.models.polar import _qdwh_schedule
    A = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (4096, 256), dtype=np.float32)).to(dev)
    eps = float(torch.finfo(torch.float32).eps)
    n_chol = sum(not s[3] for s in _qdwh_schedule(eps / 10 / (4096 * 256) ** 0.25, eps))
    before = chol_with_inv_kernel.launches
    U, H = ct.polar(A, config=ct.QRConfig(device="cuda"))
    assert chol_with_inv_kernel.launches - before >= n_chol >= 1
    Up, Hp = ct.polar(A, config=ct.QRConfig(device="cuda", use_kernels=False))
    assert float((U - Up).abs().max()) < 1e-4 and rel(H, Hp) < 1e-4
    G = U.double().T @ U.double()
    G.diagonal().sub_(1.0)
    assert float(G.norm()) < 4 * 256 * eps
    assert float((A - U @ H).norm() / A.norm()) < 256 * eps


def test_spectral_family_on_the_card(dev):
    """eigh (divide and conquer + the batched leaf Jacobi), eigh_batched,
    svd with both eigensolvers and rsvd on CUDA tensors."""
    rng = np.random.default_rng(22)
    S = rng.standard_normal((512, 512), dtype=np.float32)
    S = torch.from_numpy((S + S.T) / 2).to(dev)
    cfg = ct.QRConfig(device="cuda")
    w, V = ct.eigh(S, cfg)
    eps = float(torch.finfo(torch.float32).eps)
    S64, V64 = S.double(), V.double()
    assert float((S64 @ V64 - V64 * w.double()).norm() / S64.norm()) < 512 * eps
    # the leaf Jacobi's ~900 rotation rounds floor V's orthogonality at a few 1e-4
    assert float((V64.T @ V64 - torch.eye(512, device=dev, dtype=torch.float64)).norm()) \
        < 32 * 512 * eps
    assert float((w.double() - torch.linalg.eigvalsh(S64)).abs().max()) \
        < 512 * eps * float(w.abs().max())
    ws, Vs = ct.eigh_batched(S[:60, :60].reshape(1, 60, 60).repeat(8, 1, 1), config=cfg)
    assert float((ws[3].double() - torch.linalg.eigvalsh(S64[:60, :60])).abs().max()) < 1e-4
    A = torch.from_numpy(rng.standard_normal((1024, 384), dtype=np.float32)).to(dev)
    s_ref = torch.linalg.svdvals(A.double())
    for impl in ("torch", "qdwh"):
        U, s, Vh = ct.svd(A, config=cfg, eigh_impl=impl)
        assert float((s.double() - s_ref).abs().max()) < 384 * eps * float(s_ref[0])
        assert float((A - (U * s) @ Vh).norm() / A.norm()) < 384 * eps
    U, s, Vt = ct.rsvd(A, k=16, config=cfg)
    assert float((s.double() - s_ref[:16]).abs().max()) < 0.2 * float(s_ref[0])
    assert U.device.type == "cuda" and tuple(Vt.shape) == (16, 384)


@pytest.mark.parametrize("n", [509, 45])
def test_qdwh_cholesky_step_pads_to_the_kernel(dev, n):
    """A QDWH Cholesky step whose side is no multiple of 16 (an exact-size
    block of eigh) launches the chol_inv kernel once, on diag(Z, I), and
    gives the plain recursion's factors; float64 is not padded."""
    from cuda_qr_tpu_torch.models.polar import _chol_inv_padded
    B = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 2 * n))).to(dev)
    Z = (torch.eye(n, device=dev, dtype=torch.float64) + B @ B.T / (2 * n)).float()
    cfg = ct.QRConfig(device="cuda")
    before = chol_with_inv_kernel.launches
    L, Li = _chol_inv_padded(Z, cfg)
    assert chol_with_inv_kernel.launches == before + 1
    Lp, Lip = cholesky_with_inv(Z)
    assert tuple(L.shape) == (n, n) and rel(L, Lp) < 1e-4 and rel(Li, Lip) < 1e-4
    _chol_inv_padded(Z.double(), cfg)
    assert chol_with_inv_kernel.launches == before + 1


@pytest.mark.parametrize("n", [384, 512, 528])
def test_library_eigh_at_its_float64_threshold(dev, n):
    """Both sides of LIBRARY_EIGH_F64_MAX_N: the polar factor H of a
    Gaussian 2n x n matrix, float32 in and out, eigenvalues within n eps
    ||H|| of float64's.  Up to 512 rows that needs the float64 detour (the
    card's float32 Jacobi solver is 1e-4 off); at 528 torch's own choice
    must do."""
    from cuda_qr_tpu_torch.ops.smalllinalg import LIBRARY_EIGH_F64_MAX_N, library_eigh
    assert LIBRARY_EIGH_F64_MAX_N == 512
    A = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2 * n, n), dtype=np.float32)).to(dev)
    H = ct.polar(A, config=ct.QRConfig(device="cuda"))[1]
    w, V = library_eigh(H)
    assert w.dtype == V.dtype == torch.float32 and w.is_cuda
    eps = float(torch.finfo(torch.float32).eps)
    w_ref = torch.linalg.eigvalsh(H.double())
    assert float((w.double() - w_ref).abs().max()) < n * eps * float(w_ref[-1])
    H64, V64 = H.double(), V.double()
    assert float((H64 @ V64 - V64 * w.double()).norm() / H64.norm()) < n * eps


def _launch_counts():
    return (chol_with_inv_kernel.launches, geqrt_base.launches, geqrt_batched.launches,
            select_pivots_kernel.launches)


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_qr_on_the_card_launches_no_kernel(dev, dtype):
    """Complex QR takes the plain geqr2 panels (the reference's routing):
    the gates hold, R's diagonal is real, and no kernel launches."""
    g = torch.Generator(device=dev).manual_seed(8)
    A = torch.randn(1000, 300, generator=g, dtype=dtype, device=dev)
    before = _launch_counts()
    Q, R = ct.qr(A)
    x = ct.lstsq(A, A[:, :3]).x
    Qt, Rt = ct.tsqr(A, ct.DEFAULT_CONFIG.replace(tsqr_leaf="cholqr2", block_rows=256))
    torch.cuda.synchronize()
    assert _launch_counts() == before
    assert ct.check_qr_device(A, Q, R).ok and ct.check_qr_device(A, Qt, Rt).ok
    assert float(R.diagonal().imag.abs().max()) == 0.0
    eye = torch.eye(300, 3, dtype=dtype, device=dev)
    assert float((x - eye).abs().max()) < (1e-4 if dtype == torch.complex64 else 1e-10)


@pytest.mark.parametrize("name", ["chol_inv", "geqrt", "geqrt_batched", "select_pivots"])
def test_kernel_wrappers_raise_on_complex(dev, name):
    c64 = torch.complex64
    call = {"chol_inv": lambda: chol_with_inv_kernel(torch.eye(64, dtype=c64, device=dev)),
            "geqrt": lambda: geqrt_base(torch.ones(256, 64, dtype=c64, device=dev), 0),
            "geqrt_batched": lambda: geqrt_batched(torch.ones(4, 256, 64, dtype=c64, device=dev), 0),
            "select_pivots": lambda: select_pivots_kernel(
                torch.ones(160, 512, dtype=c64, device=dev), torch.ones(512, dtype=c64, device=dev),
                128)}[name]
    before = _launch_counts()
    with pytest.raises(TypeError):
        call()
    assert _launch_counts() == before


def test_cli_factor_on_the_card(dev, capsys):
    """``python -m cuda_qr_tpu_torch factor 1024 1024`` in process, on the
    card by default: rc 0, the record's gates ok, chol_inv launched."""
    import json

    from cuda_qr_tpu_torch import cli
    before = chol_with_inv_kernel.launches
    assert cli.main(["--trials", "1", "factor", "1024", "1024"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["cmd"] == "factor" and rec["ok"] is True
    assert chol_with_inv_kernel.launches > before
