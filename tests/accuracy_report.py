"""Accuracy of the port's blocked QR against the JAX reference on the CPU.

    JAX_PLATFORMS=cpu python tests/accuracy_report.py [c5] [factor] [gemm]

Not a test: it prints the numbers behind fault C5 and the bisection of the
factor's accuracy (ROADMAP.md Queue C), both packages on the same seeded
float32 input.  Run from a checkout's root; run in a checkout of an older
commit, it reads that commit's port.

c5      port/reference ||Q^T Q - I||_F and ||A - QR||/||A|| of ``qr`` at the
        reference's default config (nb 128, scan_stages 4), geqr2 and geqrt
        panels, k = 2, 4, 8 panels: geometric mean over seeds 0-3 (max).
factor  geqr2 512^2, seeds 0-7, one step at a time: Q formed in float64
        from packed V and tau alone (no T); T against a float64 larft of
        the same V and tau, each package's larft also on a float64 Gram;
        then the factor rebuilt panel by panel with geqr2, larft and the
        trailing larfb each taken from either package (at k = 4 the
        default groups are single panels, so this is the driver's own
        order), Q formed by the reference's orgqr; and the port's steps
        continued from the reference's state after panel i.
gemm    one float32 GEMM, V^T B and the Gram V^T V, in each library against
        float64, at the shapes the factor and larft give it.
k8      tests/test_torch_accuracy.py's two k = 8 cases whose residual is
        held to 1.2x (256^2, nb 32, seeds 0-3), then again with the
        reference's own panel factorization inside the port's driver.
nb16    cholqr2_bk at panel width 16, where the 16 x 16 GEMMs of its
        Newton-Schulz and Cholesky steps differ between the libraries.
"""

import itertools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.getcwd())

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import cuda_qr_tpu as ref  # noqa: E402
import cuda_qr_tpu_torch as ct  # noqa: E402
from cuda_qr_tpu.ops import householder as rh  # noqa: E402
from cuda_qr_tpu.ops.blocked import PackedQR as RefPackedQR  # noqa: E402
from cuda_qr_tpu_torch.ops import householder as ph  # noqa: E402
from cuda_qr_tpu_torch.utils.interop import config_from_reference  # noqa: E402

HI = jax.lax.Precision.HIGHEST


def gaussian(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def orth(Q):
    Q = np.asarray(Q, np.float64)
    return np.linalg.norm(Q.T @ Q - np.eye(Q.shape[1]))


def resid(A, Q, R):
    A = np.asarray(A, np.float64)
    QR = np.asarray(Q, np.float64) @ np.asarray(R, np.float64)
    return np.linalg.norm(A - QR) / np.linalg.norm(A)


def gmean(x, axis=0):
    return np.exp(np.log(np.asarray(x)).mean(axis))


def c5():
    print("c5: qr at the reference's default config, float32; port/reference, "
          "geometric mean over seeds 0-3 (max)")
    for method, k in itertools.product(("geqr2", "geqrt"), (2, 4, 8)):
        n = 128 * k
        rcfg = ref.QRConfig(dtype=jnp.float32, panel_method=method, use_pallas=method != "geqr2")
        cfg = config_from_reference(rcfg, device="cpu")
        r = []
        for seed in range(4):
            A = gaussian(seed, n, n)
            rQ, rR = ref.qr(jnp.asarray(A), rcfg)
            Q, R = ct.qr(A, cfg)
            r.append((orth(Q) / orth(rQ), resid(A, Q, R) / resid(A, rQ, rR)))
        r = np.array(r)
        om, rm = gmean(r)
        print(f"  {method:5s} {n}^2 (k = {k}): orthogonality {om:.3f} ({r[:, 0].max():.3f}), "
              f"residual {rm:.3f} ({r[:, 1].max():.3f})")


def larft64(V, tau):
    V, tau = np.asarray(V, np.float64), np.asarray(tau, np.float64)
    G = V.T @ V
    T = np.zeros((V.shape[1],) * 2)
    for j in range(V.shape[1]):
        T[:j, j] = -tau[j] * T[:j, :j] @ G[:j, j]
        T[j, j] = tau[j]
    return T


def q_from_reflectors(packed, taus):
    """Q = H_0 H_1 ... in float64 from packed V and tau alone."""
    P = np.asarray(packed, np.float64)
    tau = np.asarray(taus, np.float64).reshape(-1)
    m, n = P.shape
    V = np.tril(P, -1) + np.eye(m, n)
    Q = np.eye(m, n)
    for j in reversed(range(n)):
        Q -= tau[j] * np.outer(V[:, j], V[:, j] @ Q)
    return Q


@jax.jit
def _ref_larft_of_gram(G, tau):
    """The reference's larft recurrence (``cuda_qr_tpu/ops/householder.py``)
    on a given float32 Gram."""
    n = G.shape[0]
    idx = jnp.arange(n)

    def body(j, T):
        g = jnp.where(idx < j, G[:, j], 0)
        tcol = -tau[j] * jnp.einsum("ij,j->i", T, g, precision=HI) \
            + tau[j] * (idx == j).astype(G.dtype)
        return T.at[:, j].set(tcol)
    return jax.lax.fori_loop(0, n, body, jnp.zeros((n, n), G.dtype))


def gram64(V):
    return (V.astype(np.float64).T @ V.astype(np.float64)).astype(np.float32)


_ref_larfb = jax.jit(lambda B, V, T: rh.larfb(B, V, T, transpose=True, precision=HI))
STEPS = {
    "geqr2": {"r": lambda P: tuple(np.asarray(x) for x in rh.geqr2(jnp.asarray(P))),
              "p": lambda P: tuple(x.numpy() for x in ph.geqr2(torch.from_numpy(P)))},
    # R / P: each package's larft with the Gram formed in float64
    "larft": {"r": lambda V, t: np.asarray(rh.larft(jnp.asarray(V), jnp.asarray(t))),
              "p": lambda V, t: ph.larft(torch.from_numpy(V), torch.from_numpy(t)).numpy(),
              "R": lambda V, t: np.asarray(_ref_larft_of_gram(jnp.asarray(gram64(V)),
                                                              jnp.asarray(t))),
              "P": lambda V, t: ph.larft(torch.from_numpy(V), torch.from_numpy(t),
                                         torch.float64).numpy()},
    "larfb": {"r": lambda B, V, T: np.asarray(_ref_larfb(jnp.asarray(B), jnp.asarray(V),
                                                         jnp.asarray(T))),
              "p": lambda B, V, T: ph.larfb(torch.from_numpy(B), torch.from_numpy(V),
                                            torch.from_numpy(T)).numpy()},
}


def unit_lower(lo):
    return np.tril(lo, -1) + np.eye(*lo.shape, dtype=lo.dtype)


def rebuild(A, nb, pick):
    """The factor panel by panel; pick(i, step) says whose step ("r"/"p")."""
    A = A.copy()
    n = A.shape[1]
    k = n // nb
    taus, Ts = np.zeros((k, nb), np.float32), np.zeros((k, nb, nb), np.float32)
    for i in range(k):
        off = i * nb
        lo, tau = STEPS["geqr2"][pick(i, "geqr2")](np.ascontiguousarray(A[off:, off:off + nb]))
        V = unit_lower(lo)
        T = STEPS["larft"][pick(i, "larft")](V, tau)
        A[off:, off:off + nb], taus[i], Ts[i] = lo, tau, T
        if off + nb < n:
            A[off:, off + nb:] = STEPS["larfb"][pick(i, "larfb")](
                np.ascontiguousarray(A[off:, off + nb:]), V, T)
    return A, taus, Ts


def factor():
    n, nb = 512, 128
    k = n // nb
    rcfg = ref.QRConfig(dtype=jnp.float32, panel_method="geqr2", use_pallas=False)
    cfg = config_from_reference(rcfg, device="cpu")
    seeds = range(8)
    rows, terr, hyb, cont = [], [], {}, {}
    for seed in seeds:
        A = gaussian(seed, n, n)
        rf, pf = ref.qr_blocked(jnp.asarray(A), rcfg), ct.qr_blocked(A, cfg)
        rows.append(orth(q_from_reflectors(pf.packed.numpy(), pf.taus.numpy()))
                    / orth(q_from_reflectors(rf.packed, rf.taus)))
        for name, f in (("reference", rf), ("port", pf)):
            P, taus = np.asarray(f.packed), np.asarray(f.taus)
            for i in range(k):
                V = unit_lower(P[i * nb:, i * nb:(i + 1) * nb])
                T64 = larft64(V, taus[i])
                Tg = STEPS["larft"][name[0].upper()](V, taus[i])
                for label, Tm in ((name, f.Ts[i]), (f"{name}, float64 Gram", Tg)):
                    terr.append((label, i, np.linalg.norm(np.asarray(Tm, np.float64) - T64)
                                 / np.linalg.norm(T64)))

        def qr_of(P, taus, Ts):
            VJs = np.stack([unit_lower(P[i * nb:, i * nb:(i + 1) * nb])[:nb] for i in range(k)])
            fac = RefPackedQR(*(jnp.asarray(x) for x in (P, taus, Ts, VJs)))
            Q = np.asarray(ref.orgqr(fac, n, n, rcfg), np.float64)
            return orth(Q), resid(A, Q, np.triu(P))

        for combo in [*itertools.product("rp", repeat=3), "rRr", "rPr"]:
            pick = dict(zip(("geqr2", "larft", "larfb"), combo))
            hyb.setdefault("".join(combo), []).append(qr_of(*rebuild(A, nb, lambda i, s: pick[s])))
        for i0 in range(k):
            cont.setdefault(i0, []).append(
                qr_of(*rebuild(A, nb, lambda i, s: "r" if i < i0 else "p")))
    print(f"factor: geqr2 {n}^2 float32, seeds 0-7")
    print(f"  Q from packed V and tau alone (no T), float64: port/reference orthogonality "
          f"{gmean(rows):.3f} (geometric mean)")
    for name in ("reference", "port", "reference, float64 Gram", "port, float64 Gram"):
        e = [np.mean([x for nm, i, x in terr if nm == name and i == j]) for j in range(k)]
        print(f"  T of its own V, tau vs a float64 larft, {name}: "
              + ", ".join(f"{x:.3e}" for x in e) + " (panels 0-3)")
    base = np.array(hyb["rrr"])
    print("  rebuilt with geqr2 / larft / larfb of the (r)eference or the (p)ort (R, P: "
          "that package's larft on a float64 Gram); Q by the reference's orgqr; "
          "orthogonality, residual over rrr:")
    for key, v in hyb.items():
        print(f"    {key}: " + " ".join(f"{x:.3f}" for x in gmean(np.array(v) / base)))
    print("  the reference's steps for panels < i, the port's after; over rrr:")
    for i0, v in cont.items():
        print(f"    i = {i0}: " + " ".join(f"{x:.3f}" for x in gmean(np.array(v) / base)))


def gemm():
    mm = jax.jit(lambda A, B: jnp.einsum("ri,rj->ij", A, B, precision=HI))
    print("gemm: float32 V^T B (V Householder vectors) against float64, ||error||_F, "
          "mean over seeds 0-7")
    for m, w, nr in ((128, 64, 64), (192, 64, 128), (256, 64, 192), (512, 128, 384),
                     (1024, 128, 896), (256, 32, 0), (512, 128, 0), (4096, 128, 0)):
        e = []
        for seed in range(8):
            lo, _ = rh.geqr2(jnp.asarray(gaussian(seed, m, w)))
            V = np.asarray(rh.unpack_v(lo))
            B = gaussian(seed + 50, m, nr) if nr else V          # nr = 0: the Gram V^T V
            exact = V.astype(np.float64).T @ B.astype(np.float64)
            torch_ = (torch.from_numpy(V).mT @ torch.from_numpy(B)).numpy()
            e.append((np.linalg.norm(np.asarray(mm(V, B), np.float64) - exact),
                      np.linalg.norm(torch_.astype(np.float64) - exact)))
        e = np.array(e).mean(0)
        what = f"B {m}x{nr}" if nr else "the Gram V^T V"
        print(f"  V {m}x{w}, {what}: XLA {e[0]:.3e}, torch (MKL) {e[1]:.3e}, "
              f"ratio {e[1] / e[0]:.3f}")
    nn = jax.jit(lambda A, B: jnp.einsum("ij,jk->ik", A, B, precision=HI))
    for n in (16, 32):
        e = []
        for seed in range(200):
            A, B = gaussian(seed, n, n), gaussian(seed + 1000, n, n)
            exact = A.astype(np.float64) @ B.astype(np.float64)
            e.append((np.abs(np.asarray(nn(A, B), np.float64) - exact).mean(),
                      np.abs((torch.from_numpy(A) @ torch.from_numpy(B)).numpy()
                             .astype(np.float64) - exact).mean()))
        e = np.array(e).mean(0)
        print(f"  Gaussian {n}x{n} @ {n}x{n}, seeds 0-199, mean |error|: XLA {e[0]:.3e}, "
              f"torch (MKL) {e[1]:.3e}, ratio {e[1] / e[0]:.3f}")


def k8():
    from cuda_qr_tpu.ops import blocked as rb
    from cuda_qr_tpu_torch.ops import blocked as pb
    n, nb = 256, 32
    print(f"k8: {n}^2 float32, nb {nb}, k = 8; port/reference orthogonality, residual, "
          "geometric mean over seeds 0-3")
    own = pb._panel_factor
    for method in ("geqrt", "cholqr2_hr"):
        rcfg = ref.QRConfig(dtype=jnp.float32, panel_width=nb, panel_method=method,
                            use_chol_kernel=False)
        cfg = config_from_reference(rcfg, device="cpu")
        rpanel = jax.jit(rb._panel_factor_dyn, static_argnames=("config",))

        def ref_panel(panel, off, config, rcfg=rcfg, rpanel=rpanel):
            return tuple(torch.from_numpy(np.array(x))
                         for x in rpanel(jnp.asarray(panel.numpy()), off, rcfg))

        for label, panel_fn in (("the port's panels", own), ("the reference's panels", ref_panel)):
            pb._panel_factor = panel_fn
            r = []
            for seed in range(4):
                A = gaussian(seed, n, n)
                rQ, rR = ref.qr(jnp.asarray(A), rcfg)
                Q, R = ct.qr(A, cfg)
                r.append((orth(Q) / orth(rQ), resid(A, Q, R) / resid(A, rQ, rR)))
            pb._panel_factor = own
            print(f"  {method}, {label}: " + " ".join(f"{x:.3f}" for x in gmean(np.array(r))))


def nb16():
    rcfg = ref.QRConfig(dtype=jnp.float32, panel_width=16, use_chol_kernel=False)
    cfg = config_from_reference(rcfg, device="cpu")
    r = []
    for seed in range(4):
        A = gaussian(seed, 32, 32)
        rQ, rR = ref.qr(jnp.asarray(A), rcfg)
        Q, R = ct.qr(A, cfg)
        r.append((orth(Q) / orth(rQ), resid(A, Q, R) / resid(A, rQ, rR)))
    print("nb16: cholqr2_bk 32^2 float32, nb 16, k = 2; port/reference orthogonality, "
          "residual, geometric mean over seeds 0-3: "
          + " ".join(f"{x:.3f}" for x in gmean(np.array(r))))


if __name__ == "__main__":
    parts = sys.argv[1:] or ["c5", "factor", "gemm", "k8", "nb16"]
    for part in parts:
        {"c5": c5, "factor": factor, "gemm": gemm, "k8": k8, "nb16": nb16}[part]()
