"""Reference for a thin QR, A (m x n, m >= n) = Q R.

The reference factors A again in float64 (``torch.linalg.qr``) and fixes
its signs to a positive diagonal of R.  A QR is unique up to the signs of
R's rows (Q's columns), so each answer is compared after the same fix
(signs read from the answer's own diagonal of R).  Numbers, each the worst
over the judged calls:

  residual       ||A - Q R||_F / ||A||_F, float64
  orthogonality  ||Q^T Q - I||_F, float64
  r_lower        max |strict lower triangle of R|
  r_gap          ||D R - R_ref||_F / ||R_ref||_F
  q_gap          ||Q D - Q_ref||_F / ||Q_ref||_F
"""

from __future__ import annotations

import torch


def signs(R: torch.Tensor) -> torch.Tensor:
    """sign(diag R), with +1 for a zero diagonal entry."""
    d = torch.sign(torch.diagonal(R))
    return torch.where(d == 0, torch.ones_like(d), d)


def factor(A: torch.Tensor):
    """(Q, R) of A in float64, R with a positive diagonal."""
    Q, R = torch.linalg.qr(A.to(torch.float64), mode="reduced")
    d = signs(R)
    return Q * d, R * d[:, None]


def numbers(A: torch.Tensor, Q: torch.Tensor, R: torch.Tensor, ref) -> dict:
    """The five numbers of one answer (Q, R) of A, against ``ref = factor(A)``."""
    Qr, Rr = ref
    A64, Q64, R64 = A.to(torch.float64), Q.to(torch.float64), R.to(torch.float64)
    residual = torch.linalg.norm(A64 - Q64 @ R64) / torch.linalg.norm(A64)
    G = Q64.T @ Q64
    G.diagonal().sub_(1.0)
    d = signs(R64)
    return {
        "residual": float(residual),
        "orthogonality": float(torch.linalg.norm(G)),
        "r_lower": float(torch.tril(R64, -1).abs().max()) if R64.shape[0] > 1 else 0.0,
        "r_gap": float(torch.linalg.norm(R64 * d[:, None] - Rr) / torch.linalg.norm(Rr)),
        "q_gap": float(torch.linalg.norm(Q64 * d - Qr) / torch.linalg.norm(Qr)),
    }


def judge(pools: dict, samples: list, setup: dict) -> dict:
    """The worst of each number over ``samples`` (each {"a": index into
    pools["A"], "out": (Q, R)}); one reference factorization per input."""
    worst: dict = {}
    for a in sorted({s["a"] for s in samples}):
        A = pools["A"][a]
        ref = factor(A)
        for s in samples:
            if s["a"] != a:
                continue
            Q, R = s["out"]
            if Q.shape != (A.shape[0], A.shape[1]) or R.shape != (A.shape[1], A.shape[1]):
                return {}
            for name, value in numbers(A, Q, R, ref).items():
                worst[name] = max(worst.get(name, value), value)
        del ref
    return worst
