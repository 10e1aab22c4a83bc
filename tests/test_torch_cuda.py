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
from cuda_qr_tpu_torch.ops.chol_kernel import chol_with_inv_auto, chol_with_inv_kernel
from cuda_qr_tpu_torch.ops.geqrt import (BLOCKED_ROWS, body, geqrt_base, geqrt_base_plain,
                                        geqrt_batched, geqrt_batched_plain, pair_occupancy)
from cuda_qr_tpu_torch.ops.householder import unpack_v
from cuda_qr_tpu_torch.ops.newton_kernel import newton_certified_kernel
from cuda_qr_tpu_torch.ops.qrcp import qrcp_blocked
from cuda_qr_tpu_torch.ops.select_kernel import (select_pivots_kernel, select_pivots_plain,
                                                 selection_margin)
from cuda_qr_tpu_torch.ops.smalllinalg import cholesky_with_inv

from torch_caller_states import CALLER_STATES, caller_state, fp32_reads

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
    MIXED_CONFIG (trailing 3xTF32 in qr_blocked) gives the same pivots and the
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


def leaf_launch(fn, *args, leaf=1):
    """fn(*args) on geqrt_batched or geqrt_base, checked to launch once,
    ``leaf`` times on the blocked body."""
    before = (fn.launches, fn.leaf_launches)
    out = fn(*args)
    assert (fn.launches - before[0], fn.leaf_launches - before[1]) == (1, leaf)
    return out


@pytest.mark.parametrize("L,m,w", [(64, 1024, 128), (4, 1021, 128), (4, 1024, 77),
                                   (4, 1024, 100), (4, 398, 128), (4, 1024, 64),
                                   (3, 600, 96)])
def test_geqrt_blocked_kernel_matches_plain(dev, L, m, w):
    """B2's blocked leaf body against the plain version: the TSQR leaf
    (1,024 x 128), rows not a multiple of its 32-row tiles, w not a multiple
    of 8 (a ragged last inner block) or of 32 (a narrow last sub-panel), the
    fewest rows at w = 128, two sub-panels; a zero panel (tau = 0) and a zero
    column; exact zeros below T's diagonal; one launch, counted as a leaf
    launch."""
    P = torch.from_numpy(np.random.default_rng(m + w).standard_normal((L, m, w))).to(
        dev, torch.float32)
    P[1] = 0
    P[2, :, 5] = 0
    assert body(m, w, 0, torch.float32) == "blocked"
    got = leaf_launch(geqrt_batched, P, 0)
    want = geqrt_batched_plain(P, 0)
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.isfinite(a).all() and rel(a, b) < TOLS[torch.float32]
    lower = torch.ones(w, w, dtype=torch.bool, device=dev).tril(-1)
    assert (got[2][:, lower] == 0).all()
    assert float(got[1][1].abs().max()) == 0.0 and float(got[1][2, 5]) == 0.0


@pytest.mark.parametrize("case", ["overflow", "underflow", "small panel"])
def test_geqrt_blocked_kernel_scales_a_norm_out_of_range(dev, case):
    """Column steps whose largest |x| lies outside [2^-50, 2^50] take the
    scaled sum of squares: an entry of 1e20 (its square overflows float32),
    a column of 1e-25 entries (their squares underflow) and a panel of 1e-17
    (in range, but scaled).  The dot products stay unscaled, as in the dense
    body, so the entries keep their products in range.  Each panel agrees
    with the plain version at its own scale."""
    P = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 1024, 128))).to(
        dev, torch.float32)
    if case == "overflow":
        P[1, 700, 5] = 1e20
    elif case == "underflow":
        P[1, :, 37] *= 1e-25
    else:
        P[1] *= 1e-17
    got = leaf_launch(geqrt_batched, P, 0)
    want = geqrt_batched_plain(P, 0)
    for b in range(4):
        for a, w_ in zip(got, want):
            assert torch.isfinite(a[b]).all() and rel(a[b], w_[b]) < TOLS[torch.float32]


@pytest.mark.parametrize("m,w", [(BLOCKED_ROWS + 1, 128), (BLOCKED_ROWS, 32)])
def test_geqrt_just_outside_the_blocked_body_takes_the_dense_one(dev, m, w):
    """A row past the blocked body's envelope, and a leaf held whole in
    shared memory, run the dense body as before."""
    P = torch.from_numpy(np.random.default_rng(m).standard_normal((4, m, w))).to(
        dev, torch.float32)
    assert body(m, w, 0, torch.float32) != "blocked"
    got = leaf_launch(geqrt_batched, P, 0, leaf=0)
    for a, b in zip(got, geqrt_batched_plain(P, 0)):
        assert torch.isfinite(a).all() and rel(a, b) < TOLS[torch.float32]


@pytest.mark.parametrize("col", [0, 37, 127])
def test_geqrt_blocked_kernel_nan_column(dev, col):
    """A NaN column leaves its panel's later columns, tau and T non-finite,
    the columns before it and the other panels as the plain version has
    them."""
    P = torch.from_numpy(np.random.default_rng(col).standard_normal((4, 1024, 128))).to(
        dev, torch.float32)
    P[1, :, col] = float("nan")
    pk, tau, T = got = leaf_launch(geqrt_batched, P, 0)
    assert not torch.isfinite(tau[1]).all() and not torch.isfinite(pk[1]).all()
    keep = [0, 2, 3]
    for a, b in zip(got, geqrt_batched_plain(P[keep], 0)):
        assert torch.isfinite(a[keep]).all() and rel(a[keep], b) < TOLS[torch.float32]
    if col:
        pp, taup, Tp = geqrt_batched_plain(P[1:2], 0)
        assert rel(pk[1, :, :col], pp[0, :, :col]) < TOLS[torch.float32]
        assert rel(tau[1, :col], taup[0, :col]) < TOLS[torch.float32]
        assert rel(T[1, :col, :col], Tp[0, :col, :col]) < TOLS[torch.float32]


@pytest.mark.parametrize("c0,w", [(64, 128), (3, 77)])
def test_geqrt_blocked_kernel_reads_a_column_slice_in_place(dev, c0, w):
    """geqrt_base on a column slice of a 1,024 x 256 matrix (row stride 256)
    takes the blocked body; at column 3 the slice is not 16-byte aligned, so
    the body copies single words."""
    A = torch.from_numpy(np.random.default_rng(c0).standard_normal((1024, 256))).to(
        dev, torch.float32)
    got = leaf_launch(geqrt_base, A[:, c0:c0 + w], 0)
    want = geqrt_base_plain(A[:, c0:c0 + w].contiguous(), 0)
    for a, b in zip(got, want):
        assert rel(a, b) < TOLS[torch.float32]


def triangle_pairs(L, w, seed, dtype, dev):
    """L stacked pairs [R_i; R_j] (L x 2w x w) of upper triangles shaped as a
    TSQR level's: N(0, 1) above the diagonal, +-sqrt(4w - i) on it."""
    rng = np.random.default_rng(seed)
    R = np.triu(rng.standard_normal((L, 2, w, w)))
    i = np.arange(w)
    R[..., i, i] = np.sqrt(4.0 * w - i) * rng.choice([-1.0, 1.0], size=(L, 2, w))
    return torch.from_numpy(R.reshape(L, 2 * w, w)).to(dev, dtype)


def pair_launch(P):
    """geqrt_batched(P, 0, pair=True), checked to launch once as a pair."""
    before = (geqrt_batched.launches, geqrt_batched.pair_launches)
    out = geqrt_batched(P, 0, pair=True)
    assert (geqrt_batched.launches - before[0], geqrt_batched.pair_launches - before[1]) == (1, 1)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w", [128, 77, 72, 32, 1])
@pytest.mark.parametrize("L", [512, 3, 1])
def test_geqrt_pair_kernel_matches_plain(dev, L, w, dtype):
    """B2's triangle-pair body on stacked upper triangles against the plain
    version: a zero bottom block (the odd level's phantom sibling), a zero
    column and, at L = 512, a rank-deficient pair (column 7 = 3 x column 0:
    its later reflectors are rounding noise in any implementation, so that
    node is held by its residual and orthogonality); exact zeros below the
    diagonals of R, V_2 and T; one launch, counted as a pair launch."""
    P = triangle_pairs(L, w, 1000 * L + w, dtype, dev)
    if L >= 3:
        P[1, w:] = 0.0
        P[2, :, min(5, w - 1)] = 0.0
    deficient = L == 512 and w >= 8
    if deficient:
        P[3, :, 7] = 3.0 * P[3, :, 0]
    pk, tau, T = got = pair_launch(P)
    want = geqrt_batched_plain(P, 0)
    keep = [b for b in range(L) if not (deficient and b == 3)]
    for a, b in zip(got, want):
        assert a.is_contiguous() and torch.isfinite(a).all()
        assert rel(a[keep], b[keep]) < TOLS[dtype]
    lower = torch.ones(w, w, dtype=torch.bool, device=dev).tril(-1)
    assert (pk[:, :w][:, lower] == 0).all() and (pk[:, w:][:, lower] == 0).all()
    assert (T[:, lower] == 0).all()
    if L >= 3:
        assert float(tau[2, min(5, w - 1)]) == 0.0
    if deficient:
        A, V, Tb = P[3].double(), unpack_v(pk[3]).double(), T[3].double()
        Q = torch.eye(2 * w, dtype=torch.float64, device=dev) - V @ Tb @ V.T
        R = pk[3, :w].double().triu()
        eps = torch.finfo(dtype).eps
        assert float((A - Q[:, :w] @ R).norm() / A.norm()) < 2 * w * eps
        assert float((Q.T @ Q - torch.eye(2 * w, dtype=torch.float64, device=dev)).norm()) \
            < 8 * w * eps


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("where", ["R_i", "R_i diagonal", "R_j"])
def test_geqrt_pair_kernel_nan_stays_in_its_node(dev, where, dtype):
    """A NaN in one R leaves that node's R, tau and T non-finite, and the
    other nodes as the plain version has them."""
    w = 128
    P = triangle_pairs(4, w, 9, dtype, dev)
    P[1, {"R_i": (3, 40), "R_i diagonal": (20, 20), "R_j": (w + 100, 110)}[where]] = float("nan")
    pk, tau, T = got = pair_launch(P)
    for x in (pk[1, :w].triu(), tau[1], T[1]):
        assert not torch.isfinite(x).all()
    keep = [0, 2, 3]
    for a, b in zip(got, geqrt_batched_plain(P[keep], 0)):
        assert torch.isfinite(a[keep]).all() and rel(a[keep], b) < TOLS[dtype]


def test_geqrt_pair_body_fits_two_ctas_an_sm(dev):
    """The runtime's occupancy: registers, threads and shared memory leave
    2 CTAs of the pair body an SM in float32 at every width, 1 in float64."""
    for w in range(1, 129):
        assert pair_occupancy(w, torch.float32) >= 2
        assert pair_occupancy(w, torch.float64) >= 1


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
    before = (geqrt_batched.launches, chol_with_inv_kernel.launches,
              geqrt_batched.pair_launches, geqrt_batched.leaf_launches)
    Q, R = ct.tsqr(A, cfg)
    launched = (geqrt_batched.launches - before[0], chol_with_inv_kernel.launches - before[1],
                geqrt_batched.pair_launches - before[2], geqrt_batched.leaf_launches - before[3])
    chk = ct.check_qr_device(A, Q, R)
    assert chk.residual_ok
    if leaf == "householder":
        assert launched[0] == 7 and chk.orthogonality_ok      # 64 leaves, 6 levels
        assert launched[2] == 6                               # each level a pair launch
        assert launched[3] == 1                               # the leaves on the blocked body
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
            select_pivots_kernel.launches, newton_certified_kernel.launches)


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


@pytest.mark.parametrize("name", ["chol_inv", "geqrt", "geqrt_batched", "select_pivots",
                                  "newton"])
def test_kernel_wrappers_raise_on_complex(dev, name):
    c64 = torch.complex64
    call = {"chol_inv": lambda: chol_with_inv_kernel(torch.eye(64, dtype=c64, device=dev)),
            "newton": lambda: newton_certified_kernel(torch.eye(64, dtype=c64, device=dev)),
            "geqrt": lambda: geqrt_base(torch.ones(256, 64, dtype=c64, device=dev), 0),
            "geqrt_batched": lambda: geqrt_batched(torch.ones(4, 256, 64, dtype=c64, device=dev), 0),
            "select_pivots": lambda: select_pivots_kernel(
                torch.ones(160, 512, dtype=c64, device=dev), torch.ones(512, dtype=c64, device=dev),
                128)}[name]
    before = _launch_counts()
    with pytest.raises(TypeError):
        call()
    assert _launch_counts() == before


def test_complex_mixed_config_passes_the_residual_gate(dev):
    """C3: complex_config runs every GEMM of a complex input at "highest", so
    MIXED_CONFIG's trailing update (3xTF32 on real input; one TF32 pass
    before C9's repair) does not reach a complex64 qr; at 4096^2 the TF32
    pass read residual 7.194e-04 against the n eps gate of 4.883e-04 before
    C3's repair (H100 80GB HBM3, 700 W)."""
    g = torch.Generator(device=dev).manual_seed(73)
    A = torch.randn(4096, 4096, generator=g, dtype=torch.complex64, device=dev)
    before = _launch_counts()
    Q, R = ct.qr(A, ct.MIXED_CONFIG)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    chk = ct.check_qr_device(A, Q, R)
    assert chk.residual_ok and chk.ok, chk


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_qr_pivoted_on_the_card_launches_no_kernel(dev, dtype):
    """Complex QRCP: geqr2 panels and the plain pivot selection (the select
    kernel is real-only), on a tile the kernel would take for float32."""
    g = torch.Generator(device=dev).manual_seed(9)
    A = torch.randn(1024, 512, generator=g, dtype=dtype, device=dev)
    before = _launch_counts()
    Q, R, piv = ct.qr_pivoted(A)
    Qr, Rr, pr = ct.qr_pivoted(A, rank=200)
    torch.cuda.synchronize()
    assert _launch_counts() == before
    assert torch.equal(torch.sort(piv).values, torch.arange(512, device=dev))
    assert ct.check_qr_device(A[:, piv], Q, R).ok
    assert torch.equal(pr[:128], piv[:128]) and Qr.shape == (1024, 200)
    d = R.diagonal().abs()
    assert float((d[1:] / d[:-1]).max()) < 1.5


@pytest.mark.parametrize("n", [384, 512])
def test_library_eigh_complex64(dev, n):
    """The small Hermitian core of svd and eigh_rand in complex64: eigenvalues
    within n eps ||H|| of complex128's, residual n eps."""
    from cuda_qr_tpu_torch.ops.smalllinalg import library_eigh
    g = torch.Generator(device=dev).manual_seed(n)
    B = torch.randn(2 * n, n, generator=g, dtype=torch.complex64, device=dev)
    H = B.mH @ B / (2 * n)
    w, V = library_eigh(H)
    assert w.dtype == torch.float32 and V.dtype == torch.complex64 and w.is_cuda
    eps = float(torch.finfo(torch.float32).eps)
    w_ref = torch.linalg.eigvalsh(H.to(torch.complex128))
    assert float((w.double() - w_ref).abs().max()) < n * eps * float(w_ref[-1])
    H128, V128 = H.to(torch.complex128), V.to(torch.complex128)
    assert float((H128 @ V128 - V128 * w.double()).norm() / H128.norm()) < n * eps


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


def test_gemm_high_on_the_card(dev):
    """C9: "high" is 3xTF32.  Normwise error ||C - C64||_F / (||A||_F ||B||_F)
    at the 8192^2 factor's trailing product V^H rest (K = 8192) and V W
    (K = 128): "high" within 16x "highest"'s and under 1/100 of "tf32"'s,
    and "tf32" at least 50x "highest"'s (TF32 was on in the passes)."""
    from cuda_qr_tpu_torch.ops.gemm import gemm
    g = torch.Generator(device=dev).manual_seed(12)
    for m, k, n in ((128, 8192, 2048), (8192, 128, 2048)):
        A = torch.randn(m, k, generator=g, device=dev)
        B = torch.randn(k, n, generator=g, device=dev)
        C64 = A.double() @ B.double()
        scale = float(A.double().norm() * B.double().norm())
        err = {p: float((gemm(A, B, p).double() - C64).norm()) / scale
               for p in ("highest", "tf32", "high")}
        assert err["high"] <= 16 * err["highest"] and err["high"] <= err["tf32"] / 100, err
        assert err["tf32"] >= 50 * err["highest"], err


def test_mixed_config_keeps_the_residual_certificate(dev):
    """C9: MIXED_CONFIG at 2048^2 has residual < n eps / 10 (one TF32 pass
    read ~7e-4 at every n, over n eps = 2.441e-04 here)."""
    n = 2048
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    f = ct.qr_blocked(A, ct.MIXED_CONFIG)
    chk = ct.check_qr_device(A, ct.orgqr(f, n, n, ct.MIXED_CONFIG), ct.extract_r(f, n))
    assert chk.residual < n * chk.eps / 10 and chk.ok, chk


def test_tail_schedule_on_the_card(dev):
    """The reference's tuned tail schedule tail8x2_g8, (2,)*24 + (8,)*2 at
    factor_lookahead 8, on 2048^2 at panel width 32 (its 64 panels): the
    gates hold and B1 runs on every panel."""
    n, nb = 2048, 32
    cfg = ct.DEFAULT_CONFIG.replace(panel_width=nb, stage_schedule=(2,) * 24 + (8,) * 2,
                                    factor_lookahead=8)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    before = chol_with_inv_kernel.launches
    f = ct.qr_blocked(A, cfg)
    assert chol_with_inv_kernel.launches - before >= n // nb
    chk = ct.check_qr_device(A, ct.orgqr(f, n, n, cfg), ct.extract_r(f, n))
    assert chk.ok, chk


@pytest.mark.parametrize("state", list(CALLER_STATES))
def test_caller_states_on_the_card(dev, state):
    """C11: under each way a caller leaves the float32 GEMM mode set,
    ``qr`` at 1024^2 (B1 on every panel) passes its gates and leaves both
    fp32_precision reads as it found them; "tf32" reads TF32's error and
    "highest" float32's, so the fp32_precision API drives cuBLAS."""
    from cuda_qr_tpu_torch.ops.gemm import gemm
    n = 1024
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    X = torch.randn(128, 8192, generator=g, device=dev)
    Y = torch.randn(8192, 1024, generator=g, device=dev)
    C64 = X.double() @ Y.double()
    scale = float(X.double().norm() * Y.double().norm())
    with caller_state(state):
        before = fp32_reads()
        launches = chol_with_inv_kernel.launches
        Q, R = ct.qr(A, ct.DEFAULT_CONFIG)
        err = {p: float((gemm(X, Y, p).double() - C64).norm()) / scale
               for p in ("highest", "tf32")}
        assert fp32_reads() == before
    assert chol_with_inv_kernel.launches - launches >= n // 128
    assert ct.check_qr_device(A, Q, R).ok
    assert err["tf32"] >= 50 * err["highest"], err


@pytest.mark.parametrize("method", ["cholqr2_bk", "geqrt"])
def test_high_panels_on_the_card(dev, method):
    """A7: precision="high" (every GEMM 3xTF32) at 2048^2 passes the gates
    on both kernels' panels, and the panel's kernel runs."""
    n = 2048
    cfg = ct.QRConfig(precision="high", panel_method=method)
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    kernel = geqrt_base if method == "geqrt" else chol_with_inv_kernel
    before = kernel.launches
    f = ct.qr_blocked(A, cfg)
    assert kernel.launches > before
    chk = ct.check_qr_device(A, ct.orgqr(f, n, n, cfg), ct.extract_r(f, n))
    assert chk.ok, chk


def test_slogdet_sign_on_the_card(dev):
    """C12: slogdet at 1024^2 (nb 128, 8 panels, the last square) on 8
    seeds: the sign equals torch.linalg.slogdet's in float64 on the same
    input, logabsdet agrees to 1e-4 relative, and B1 runs on every panel."""
    n = 1024
    for seed in range(8):
        A = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (n, n), dtype=np.float32)).to(dev)
        before = chol_with_inv_kernel.launches
        sign, logabs = ct.slogdet(A, ct.DEFAULT_CONFIG)
        assert chol_with_inv_kernel.launches - before >= n // 128
        want_sign, want_logabs = torch.linalg.slogdet(A.double())
        assert float(sign) == float(want_sign), seed
        assert abs(float(logabs) - float(want_logabs)) < 1e-4 * abs(float(want_logabs)), seed


def basis_kernel_M(dev, m, nb, seed):
    """M = I - S Q_J of the basis-kernel panel of a Gaussian m x nb panel,
    Q from CholeskyQR2 on the card (``fast_panel._cholqr2``, B1), as
    ``panel_factor_cholqr2bk`` forms it."""
    from cuda_qr_tpu_torch.ops.fast_panel import _cholqr2
    A = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (m, nb), dtype=np.float32)).to(dev)
    Q, _, _ = _cholqr2(A, ct.DEFAULT_CONFIG)
    QJ = Q[:nb]
    s = torch.where(torch.diagonal(QJ) >= 0, -1.0, 1.0).to(Q.dtype)
    return torch.eye(nb, device=dev) - s[:, None] * QJ


@pytest.mark.parametrize("nb", [32, 64, 128])
@pytest.mark.parametrize("m", [8192, 2048, 512, 160, 128])
def test_newton_kernel_matches_plain(dev, m, nb):
    """B4 against its plain twin on M from live panels from 8192 rows down
    to a square one: the same certificate decision, iterations within one,
    and where the certificate passes N within 1e-5 relative (N converged:
    the two differ by the rounding of other summation orders)."""
    from cuda_qr_tpu_torch.ops import smalllinalg
    m = max(m, nb)
    M = basis_kernel_M(dev, m, nb, seed=m + nb)
    before = newton_certified_kernel.launches
    N, err, cert, iters = newton_certified_kernel(M)
    assert newton_certified_kernel.launches == before + 1
    Np, errp, certp, iters_plain = smalllinalg.newton_certified(M)
    iters_plain = int(iters_plain)
    thr = 100 * torch.finfo(torch.float32).eps
    passes = bool(cert <= thr)
    assert passes == bool(certp <= thr), (float(cert), float(certp))
    assert abs(int(iters) - iters_plain) <= 1, (int(iters), iters_plain)
    if passes:
        assert rel(N, Np) < 1e-5 and float(err) <= 2e-4


def test_newton_kernel_nan_goes_to_hr(dev):
    """A NaN in M: one iteration, non-finite N, a NaN certificate, which the
    panel's decision sends to the HR rebuild."""
    M = basis_kernel_M(dev, 2048, 128, seed=1)
    M[7, 100] = float("nan")
    N, err, cert, iters = newton_certified_kernel(M)
    assert not torch.isfinite(N).any() and torch.isnan(err) and int(iters) == 1
    assert bool(~(cert <= 100 * torch.finfo(torch.float32).eps))


def test_newton_kernel_rejects(dev):
    with pytest.raises(TypeError):
        newton_certified_kernel(torch.eye(64, device=dev, dtype=torch.float64))
    for n in (24, 144):
        with pytest.raises(ValueError):
            newton_certified_kernel(torch.eye(n, device=dev))


def test_qr_8192_launches_newton_once_a_panel(dev):
    """qr of 8192^2 at DEFAULT_CONFIG passes the gates; B4 runs once a panel,
    B1 once or twice; the factor takes 3 host syncs a panel (CholeskyQR2's
    round-2 test, the certificate, the fallback test; the retries take
    none)."""
    from cuda_qr_tpu_torch.ops import smalllinalg
    n = 8192
    panels = n // ct.DEFAULT_CONFIG.panel_width
    A = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (n, n), dtype=np.float32)).to(dev)
    newton, chol = newton_certified_kernel.launches, chol_with_inv_kernel.launches
    syncs = smalllinalg.host_syncs
    Q, R = ct.qr(A)
    torch.cuda.synchronize()
    assert newton_certified_kernel.launches - newton == panels
    assert panels <= chol_with_inv_kernel.launches - chol <= 2 * panels
    assert smalllinalg.host_syncs - syncs == 3 * panels
    assert ct.check_qr_device(A, Q, R).ok


@pytest.mark.parametrize("case", ["high", "tf32", "float64"])
def test_newton_kernel_not_launched_off_highest_float32(dev, case):
    """"high"/"tf32" panels and float64 input keep the plain Newton-Schulz
    chain (one host sync an iteration), and the gates hold."""
    n = 1024
    dtype = torch.float64 if case == "float64" else torch.float32
    cfg = (ct.QRConfig(dtype=torch.float64) if case == "float64"
           else ct.QRConfig(precision=case, trailing_precision="highest",
                            orgqr_precision="highest"))
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((n, n))).to(dev, dtype)
    before = newton_certified_kernel.launches
    f = ct.qr_blocked(A, cfg)
    assert newton_certified_kernel.launches == before
    if case != "tf32":
        assert ct.check_qr_device(A, ct.orgqr(f, n, n, cfg), ct.extract_r(f, n)).ok
