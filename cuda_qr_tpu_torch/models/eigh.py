"""Symmetric (Hermitian) eigendecomposition built from this package's own
pieces.

Counterpart of ``cuda_qr_tpu/models/eigh.py``: QDWH-eig spectral divide and
conquer (Nakatsukasa & Higham 2013) on the QDWH polar iteration
(``models/polar.py``), complete blocked-Householder QRs (``models/qr.py``)
and GEMMs, with a parallel-ordered cyclic Jacobi base case.

One divide step on a symmetric b x b block H:
  1. sigma <- median of diag(H) (retried with Gershgorin-interval points if
     the split degenerates).
  2. U = polar factor of H - sigma I, the matrix sign function: U v = +/- v
     on the eigenvectors of H above / below sigma (``_qdwh_dyn_core``).
  3. P = (I - U)/2 is the orthogonal projector onto the < sigma invariant
     subspace; k = round(trace P) is its dimension.
  4. Subspace iteration (one complete QR of P's k largest columns, iterated
     only if the certificate ||V2^T H V1|| demands it) gives orthonormal
     bases of range(P) and its complement; H restricted to each basis is the
     pair of child blocks.
  5. Recurse on the k x k and (b-k) x (b-k) blocks; the eigenvector
     back-transform is one GEMM per block.

The recursion runs on the host over exact-size blocks, with an explicit
stack.  Each data-dependent decision is one counted host sync
(``smalllinalg.host_syncs``): a node's done test, k per sigma candidate, the
certificate per QR, and one per Jacobi sweep.  The reference runs the whole
recursion as one device program over bucketed, masked block sizes; that
machinery bounds its compiled programs and is not ported, what it computes
is.  One difference follows: the QDWH bound l0 = eps/10/sqrt(b) uses the
block's own size b where the reference uses its bucket size B >= b.  A
second is in the Jacobi rotation (``_rotation``): c = 1 - t^2 / (r (1 + r)),
r = sqrt(1 + t^2), where the reference writes c = 1 / sqrt(1 + t^2): eager
PyTorch rounds that literal form with a one-sided bias, on the CPU and the
card alike, which would leave V 1.4-2.5x less orthogonal than the
reference's.

Blocks of at most ``base_n`` rows are leaves.  They are not solved where
they are met: they are recorded and solved afterwards by ONE batched Jacobi
over the whole leaf stack, so every rotation round is a batched GEMM
instead of one small GEMM chain per leaf.

Jacobi (``_jacobi_eigh``) takes a stack from the start: each round
diagonalizes n/2 disjoint 2x2 blocks in closed form and applies them as one
rotation matrix J, A <- J^H A J, V <- V J, three batched GEMMs.  A matrix
of the stack that has converged is frozen while the others go on, so its
result does not depend on its neighbours.

float32, float64, complex64 and complex128.  Complex Hermitian input takes
the reference's route: a phase factor in each Jacobi rotation, conjugate
transposes throughout, QR steps throughout the QDWH splits, and every GEMM
at ``complex_config``.  Eigenvalues are real.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.blocked import as_tensor, complex_config
from ..ops.gemm import gemm
from ..ops.smalllinalg import eye_like, host_decision, host_values
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from .polar import _qdwh_dyn_core, _real_dtype
from .qr import qr

# Counters of the LAST ``eigh`` / ``eigh_batched`` call only: each call sets
# them to 0 first, one made inside another function (``svd`` with
# eigh_impl="qdwh") included.  Read them right after the call they describe.
last_stats = {"split_nodes": 0, "diag_exits": 0, "fallbacks": 0, "leaves": 0,
              "jacobi_calls": 0, "jacobi_sweeps": 0}


def _round_robin(n: int) -> np.ndarray:
    """(n-1, n//2, 2) round-robin tournament pairs: every round is a perfect
    matching, every unordered pair appears exactly once across rounds."""
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        pairs = sorted((min(players[i], players[n - 1 - i]),
                        max(players[i], players[n - 1 - i]))
                       for i in range(n // 2))
        rounds.append(pairs)
        players = [players[0], players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int32)


def _rr_pairs(n: int) -> np.ndarray:
    """(n-1, n//2, 2) round-robin pairs by the circle method, every round at
    once: player n-1 is fixed, players 0..n-2 rotate.  The same cover as
    ``_round_robin`` in another order; the order the reference's divide and
    conquer uses for its leaves and its Jacobi fallback."""
    k = np.arange(n // 2)[None, :]
    r = np.arange(n - 1)[:, None]
    a = np.where(k == 0, n - 1, (k + r) % (n - 1))
    b = (np.where(k == 0, 0, n - 1 - k) + r) % (n - 1)
    return np.stack([np.minimum(a, b), np.maximum(a, b)], -1).astype(np.int32)


_SCHEDULE_CACHE_MAX_N = 512   # a cached table holds (n-1) n int64 on the device: 2 MB here


def _schedule(kind: str, n: int, device: str) -> torch.Tensor:
    """The (n-1, n/2, 2) pair table on ``device``.  Leaf and bucket sizes
    are kept between calls; a larger table (a Jacobi fallback on a whole
    node: 134 MB at n = 4096) is built for its one use and freed with it."""
    if n <= _SCHEDULE_CACHE_MAX_N:
        return _schedule_cached(kind, n, device)
    return _schedule_cached.__wrapped__(kind, n, device)


@functools.lru_cache(maxsize=16)
def _schedule_cached(kind: str, n: int, device: str) -> torch.Tensor:
    table = _round_robin(n) if kind == "round_robin" else _rr_pairs(n)
    return torch.from_numpy(table.astype(np.int64)).to(device)


def _rotation(tau: torch.Tensor):
    """(c, s) of the Jacobi rotation that zeroes a 2x2 block's off-diagonal,
    tau = (a_qq - a_pp) / (2 |a_pq|): t = tan(theta) is the root of
    t^2 + 2 tau t - 1 = 0 of least magnitude, c = 1 / sqrt(1 + t^2), s = t c.
    """
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)   # sign(0) = 0 would stall equal-diagonal pairs
    t2 = t * t
    r = torch.sqrt(1.0 + t2)
    # Not the reference's literal 1 / sqrt(1 + t^2): rounding 1 + t^2 and then
    # its root breaks ties one way, so that c^2 + s^2 - 1 averages up to
    # +eps/2 and every round scales V's columns by it.  1 - h is one rounding
    # from the exact c, unbiased: (c^2 + s^2 - 1)/eps averages within +-0.03.
    c = 1.0 - t2 / (r * (1.0 + r))
    return c, t * c


def _jacobi_eigh(A: torch.Tensor, schedule: torch.Tensor, max_sweeps: int = 30,
                 sort: bool = True):
    """Cyclic Jacobi with parallel ordering on a Hermitian matrix (n x n) or
    a stack (L x n x n), n even.  Returns (w, V) of the input's leading
    shape, w real.

    One round: closed-form diagonalization of the n/2 disjoint 2x2 blocks
    {(p,q)} -> one sparse rotation matrix J -> A <- J^H A J, V <- V J as
    GEMMs.  Sweeps (n-1 rounds each) run until off(A) <= 4 sqrt(n) eps
    ||A||_F or max_sweeps; the stop is one host decision per sweep.  In a
    stack, each matrix is held to its own tolerance: the sweeps go on while
    any matrix is above it, and a matrix at or below it keeps its state.

    The rotation of each pair is ``_rotation``'s: the reference's angle,
    with c formed so that c^2 + s^2 - 1 has no one-sided rounding bias.

    schedule: (n-1, n/2, 2) pair table on A's device.  sort=False returns
    the eigenvalues on the diagonal positions where they converged, which
    keeps decoupled padding coordinates in place.
    """
    single = A.dim() == 2
    if single:
        A = A[None]
    n = A.shape[-1]
    dt = A.dtype
    cplx = A.is_complex()
    eps = torch.finfo(_real_dtype(dt)).eps
    normF = torch.linalg.norm(A, dim=(-2, -1))
    # each GEMM sweep injects O(sqrt(n) eps ||A||) into off(A); below that
    # further sweeps are no-ops, so it is the honest stopping floor
    tol2 = (4.0 * n ** 0.5 * eps * normF) ** 2
    offmask = 1.0 - eye_like(n, A.real)

    def off2(A):
        # sum |offdiag|^2 directly: ||A||^2 - ||diag||^2 cancels in float32
        # and can read 0 while the true off-norm is still ~1e-4
        return ((A.abs() * offmask) ** 2).sum((-2, -1))

    def one_round(A, V, pq):
        p, q = pq[:, 0], pq[:, 1]
        app, aqq, apq = A[:, p, p].real, A[:, q, q].real, A[:, p, q]
        ab = apq.abs()
        live = ab > 0
        safe = torch.where(live, ab, 1.0)
        c, s = _rotation((aqq - app) / (2.0 * safe))
        s = torch.where(live, s, 0.0).to(dt)
        c = torch.where(live, c, 1.0).to(dt)
        # J = diag(1, phi) G with G the real rotation and phi = conj(apq)/|apq|
        # (sign(apq) for real A): J^H [[a, apq], [conj(apq), d]] J is diagonal
        ph = torch.where(live, apq.conj() / safe if cplx else torch.sign(apq), 1.0)
        J = torch.zeros_like(A)
        J[:, p, p] = c
        J[:, p, q] = s
        J[:, q, p] = -s * ph
        J[:, q, q] = c * ph
        # at "highest" whatever config.precision says, as the reference's
        # rotation (its _H, cuda_qr_tpu/models/eigh.py:172-174)
        return gemm(J.mH, gemm(A, J, "highest"), "highest"), gemm(V, J, "highest")

    V = eye_like(n, A).expand_as(A).contiguous()
    sweeps = 0
    for _ in range(max_sweeps):
        active = off2(A) > tol2
        if not host_decision(active.any()):
            break
        A1, V1 = A, V
        for r in range(n - 1):
            A1, V1 = one_round(A1, V1, schedule[r])
        A1 = (A1 + A1.mH) * 0.5
        keep = active[:, None, None]
        A, V = torch.where(keep, A1, A), torch.where(keep, V1, V)
        sweeps += 1
    last_stats["jacobi_calls"] += 1
    last_stats["jacobi_sweeps"] += sweeps
    w = torch.diagonal(A, 0, -2, -1).real
    if sort:
        w, order = torch.sort(w, dim=-1, stable=True)
        V = torch.gather(V, 2, order[:, None, :].expand_as(V))
    return (w[0], V[0]) if single else (w.contiguous(), V)


def _pad_sentinel(A: torch.Tensor, npad: int, sentinel: float) -> torch.Tensor:
    n = A.shape[0]
    if npad == n:
        return A
    P = F.pad(A, (0, npad - n, 0, npad - n))
    idx = torch.arange(n, npad, device=A.device)
    P[idx, idx] = sentinel
    return P


def _bucket(n: int, bucket: int) -> int:
    return -(-n // bucket) * bucket


def _gershgorin(A: torch.Tensor):
    """(lo, hi) enclosing the spectrum, as two 0-d tensors."""
    d = torch.diagonal(A)
    r = A.abs().sum(1) - d.abs()
    return (d.real - r).min(), (d.real + r).max()


def _eigh_base(A: torch.Tensor, bucket: int, max_sweeps: int, lo: float, hi: float):
    """The direct path: Jacobi on A padded to a multiple of ``bucket`` with
    decoupled sentinel eigenvalues below the spectrum."""
    n = A.shape[0]
    npad = _bucket(max(n, 2), bucket)
    sentinel = lo - 0.125 * (hi - lo) - 1.0
    Ap = _pad_sentinel(A, npad, sentinel)
    w, V = _jacobi_eigh(Ap, _schedule("round_robin", npad, str(A.device)),
                        max_sweeps=max_sweeps)
    # sentinel eigenpairs are exactly the npad-n smallest (sentinel < lo)
    return w[npad - n:], V[:n, npad - n:]


def _invariant_bases(P: torch.Tensor, H: torch.Tensor, rank: int, config: QRConfig):
    """Split C^b (R^b) into range(P) and its complement by subspace iteration.

    P: Hermitian projector (b x b) of rank ``rank``.  Returns (V1 (b x rank),
    V2 (b x (b - rank))), orthonormal bases of range(P) and its complement.
    One complete blocked-Householder QR of the ``rank`` largest columns of P
    converges almost always in one step (the projector's eigenvalue gap is
    exactly 1); H supplies the certificate ||V2^H H V1|| <= 10 eps ||H||, and
    at most 3 QRs run.
    """
    eps = torch.finfo(_real_dtype(P.dtype)).eps
    order = torch.argsort(-torch.linalg.norm(P, dim=0), stable=True)
    X = P[:, order[:rank]]
    thresh = 10.0 * eps * torch.linalg.norm(H)
    prec = config.precision
    for it in range(3):
        Q, _ = qr(X, config, mode="complete")
        V1, V2 = Q[:, :rank], Q[:, rank:]
        err = torch.linalg.norm(gemm(V2.mH, gemm(H, V1, prec), prec))
        if it == 2 or not host_decision(err > thresh):
            break
        X = gemm(P, V1, prec)
    return V1, V2


def _split_node(H: torch.Tensor, config: QRConfig):
    """One divide step on a Hermitian block H (b x b).

    sigma candidates (diagonal median, then Gershgorin midpoint and
    quartiles, clipped into the interval) are tried until the matrix sign
    function U = sign(H - sigma I) yields a proper split 0 < k < b, at most
    4.  Subspace iteration on the smaller-rank projector then produces the
    two invariant-subspace bases.

    Returns (V_minus (b x k), V_plus (b x (b - k)), k), bases of the
    < sigma and >= sigma eigenspaces, or None when no candidate split.
    """
    b = H.shape[0]
    eps = float(torch.finfo(_real_dtype(H.dtype)).eps)
    dre = torch.diagonal(H).real
    med = torch.quantile(dre, 0.5)
    gr = H.abs().sum(1) - dre.abs()
    lo, hi = (dre - gr).min(), (dre + gr).max()
    width = (hi - lo).clamp_min(eps)
    cands = torch.stack([med, lo + 0.5 * width, lo + 0.25 * width, lo + 0.75 * width])
    cands = torch.clamp(cands, lo + 1e-3 * width, hi - 1e-3 * width)
    eye = eye_like(b, H)
    l0 = eps / 10.0 / float(b) ** 0.5
    for i in range(4):
        Hs = H - cands[i] * eye
        absHs = Hs.abs()
        alpha = torch.sqrt(absHs.sum(0).max() * absHs.sum(1).max())
        alpha = torch.where(alpha > 0, alpha, torch.ones_like(alpha))
        U = _qdwh_dyn_core(Hs / alpha, l0, config)
        k = host_values(torch.round(torch.trace((eye - U) * 0.5).real))
        k = int(k) if np.isfinite(k) else 0     # a broken-down iteration splits nothing
        if 0 < k < b:
            break
    else:
        return None
    if b - k < k:
        V_plus, V_minus = _invariant_bases((eye + U) * 0.5, H, b - k, config)
    else:
        V_minus, V_plus = _invariant_bases((eye - U) * 0.5, H, k, config)
    return V_minus, V_plus, k


def _eigh_dc(A: torch.Tensor, config: QRConfig, term: int, max_sweeps: int):
    """The divide and conquer on an exact-size Hermitian A (N x N), N above
    the leaf size.  Returns (w ascending, real; V)."""
    N = A.shape[0]
    dt = A.dtype
    eps = float(torch.finfo(_real_dtype(dt)).eps)
    prec = config.precision
    H0n = torch.linalg.norm(A)
    cutoff = min(N + (N % 2), term)
    dev = str(A.device)
    w = torch.zeros(N, dtype=A.real.dtype, device=A.device)
    vecs = eye_like(N, A)
    leaves = []                                   # (offset, block)
    stack = [(0, A)]
    while stack:
        o, Hb = stack.pop()
        b = Hb.shape[0]
        if b <= cutoff:
            leaves.append((o, Hb))
            continue
        nrm = torch.linalg.norm(Hb)
        dvec = torch.diagonal(Hb)
        offd = torch.linalg.norm(Hb - torch.diag(dvec))
        # cluster / noise-floor exits (Nakatsukasa-Higham section 5.2): a
        # block that is diagonal to working precision, or pure numerical
        # noise relative to the input, is done; clustered and rank-deficient
        # spectra need this, since no sigma can split them
        if host_decision((offd <= 5.0 * eps * nrm) | (nrm < eps * H0n)):
            w[o:o + b] = dvec.real
            last_stats["diag_exits"] += 1
            continue
        V0 = vecs[:, o:o + b]
        split = _split_node(Hb, config)
        if split is None:
            # no candidate separated the spectrum (a tight multi-cluster):
            # Jacobi terminates at any size, just without the divide step
            last_stats["fallbacks"] += 1
            be = b + (b % 2)
            wl, Vj = _jacobi_eigh(F.pad(Hb, (0, be - b, 0, be - b)),
                                  _schedule("circle", be, dev),
                                  max_sweeps=max_sweeps, sort=False)
            vecs[:, o:o + b] = gemm(V0, Vj[:b, :b], prec)
            w[o:o + b] = wl[:b]
            continue
        V_minus, V_plus, k = split
        last_stats["split_nodes"] += 1
        H1 = gemm(V_minus.mH, gemm(Hb, V_minus, prec), prec)
        H2 = gemm(V_plus.mH, gemm(Hb, V_plus, prec), prec)
        vecs[:, o:o + b] = torch.cat([gemm(V0, V_minus, prec), gemm(V0, V_plus, prec)], 1)
        stack.append((o, (H1 + H1.mH) * 0.5))
        stack.append((o + k, (H2 + H2.mH) * 0.5))

    # Batched leaf solve: one Jacobi over the recorded stack, each leaf
    # zero-padded to the cutoff size (its padding rows and columns are zero,
    # so every rotation that touches them is the identity and they stay
    # put), then the eigenvalues and one N x b back-transform GEMM per leaf.
    last_stats["leaves"] += len(leaves)
    if leaves:
        Hstk = torch.stack([F.pad(Hb, (0, cutoff - Hb.shape[0], 0, cutoff - Hb.shape[0]))
                            for _, Hb in leaves])
        ws, Vs = _jacobi_eigh(Hstk, _schedule("circle", cutoff, dev),
                              max_sweeps=max_sweeps, sort=False)
        for i, (o, Hb) in enumerate(leaves):
            b = Hb.shape[0]
            vecs[:, o:o + b] = gemm(vecs[:, o:o + b], Vs[i, :b, :b], prec)
            w[o:o + b] = ws[i, :b]
    w, order = torch.sort(w, stable=True)
    return w, vecs[:, order]


def eigh(A, config: QRConfig = DEFAULT_CONFIG, *, base_n: int = 128,
         bucket: int | None = None, max_sweeps: int = 30):
    """Full Hermitian eigendecomposition A = V diag(w) V^H, w ascending (real).

    torch.linalg.eigh drop-in built from this package's own pieces (QDWH
    sign-function splits, blocked-Householder subspace bases, Jacobi base
    case); no library eigensolver anywhere.  A real symmetric or complex
    Hermitian (float32, float64, complex64, complex128); only the Hermitian
    part (A + A^H)/2 is used.

    base_n: largest block solved directly by the Jacobi base case (also the
      divide and conquer's leaf size).
    bucket: direct-path (n <= base_n) Jacobi blocks are padded up to
      multiples of this (default min(base_n, 64)) with sentinel eigenvalues.

    A ``config.stage_schedule`` is dropped, as the reference drops it
    (``cuda_qr_tpu/models/eigh.py:671-672``): the divide and conquer runs
    QRs of many panel counts, and no one schedule sums to all of them.
    """
    A = as_tensor(A, config)
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise QRShapeError(f"eigh needs a square matrix, got {tuple(A.shape)}")
    if bucket is None:
        bucket = min(base_n, 64)
    bucket = max(2, bucket + (bucket % 2))  # Jacobi pairs need even sizes
    if config.dtype != A.dtype:
        config = config.replace(dtype=A.dtype)
    config = complex_config(A, config).replace(stage_schedule=None)
    for key in last_stats:
        last_stats[key] = 0
    A = (A + A.mH) * 0.5
    n = A.shape[0]
    if n <= base_n:
        lo, hi = host_values(torch.stack(_gershgorin(A)))
        return _eigh_base(A, bucket, max_sweeps, lo, hi)
    return _eigh_dc(A, config, base_n + (base_n % 2), max_sweeps)


def eigh_batched(As, max_sweeps: int = 30, config: QRConfig = DEFAULT_CONFIG):
    """Batched Hermitian eigendecomposition of a (B, n, n) stack.

    Parallel-ordered Jacobi over the whole stack: every sweep round is one
    batched GEMM pair, the natural shape for many small eigenproblems (the
    batched analog of ``qr_batched``).  Sizes where one matrix's divide and
    conquer wins (n >> 512) should call ``eigh`` per matrix instead.
    Returns (ws (B, n) ascending, real; Vs (B, n, n)).  ``config`` only says
    where numpy input is placed.
    """
    As = as_tensor(As, config)
    if As.dim() != 3 or As.shape[1] != As.shape[2]:
        raise QRShapeError(f"eigh_batched needs (B, n, n), got {tuple(As.shape)}")
    for key in last_stats:
        last_stats[key] = 0
    B, n = As.shape[:2]
    npad = n + (n % 2)
    if npad != n:  # Jacobi pairing needs even n; one decoupled pad row
        As = F.pad(As, (0, 1, 0, 1))
        As[:, n, n] = 1.0
    As = (As + As.mH) * 0.5
    ws, Vs = _jacobi_eigh(As, _schedule("round_robin", npad, str(As.device)),
                          max_sweeps=max_sweeps)
    if npad != n:
        # the pad eigenpair is (1, e_n); drop it wherever it sorted to
        idx = torch.argmax(Vs[:, n, :].abs(), dim=1)                  # (B,)
        ar = torch.arange(npad, device=As.device)
        keep = torch.where(ar[None] < idx[:, None], ar[None], ar[None] + 1)[:, :n]
        ws = torch.gather(ws, 1, keep)
        Vs = torch.gather(Vs[:, :n], 2, keep[:, None, :].expand(B, n, n))
    return ws, Vs
