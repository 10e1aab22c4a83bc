"""Reference for Q^T B, with Q the orthogonal factor of a square A that
set-up factored once.

The reference factors A again in float64 (``thin_qr.factor``, positive
diagonal of R).  The answer's Q carries the signs of its own R's diagonal
(D = sign(diag R) of the factor set-up made), so Q^T B is D Q_ref^T B.
Numbers, each the worst over the judged calls:

  factor_r_gap  ||D R - R_ref||_F / ||R_ref||_F of set-up's factor
  qtb_backward  max over columns j of ||(R^T X - A^T B)_j|| / ||(A^T B)_j||,
                X the answer: (Q R)^T B = A^T B, with set-up's R (itself
                held to R_ref by factor_r_gap); a backward error, so it does
                not swing with the conditioning of A's trailing columns
  qtb_gap       ||X - D Q_ref^T B||_F / ||B||_F, the forward error
                (it does swing with that conditioning)
"""

from __future__ import annotations

import torch

from .thin_qr import factor, signs


def judge(pools: dict, samples: list, setup: dict) -> dict:
    """``samples``: {"b": index into pools["B"], "out": (X,)}; ``setup``
    holds the factor's R ("R") as set-up made it."""
    A = pools["A"][0]
    m, n = A.shape
    if m != n:
        raise ValueError(f"the apply_qt reference judges a square A, got {m} x {n}")
    Qr, Rr = factor(A)
    R64 = setup["R"].to(torch.float64)
    if R64.shape != (n, n):
        return {}
    d = signs(R64)
    A64 = A.to(torch.float64)
    worst = {"factor_r_gap": float(torch.linalg.norm(R64 * d[:, None] - Rr)
                                   / torch.linalg.norm(Rr))}
    for s in samples:
        B = pools["B"][s["b"]].to(torch.float64)
        X = s["out"][0]
        if X.shape != B.shape:
            return {}
        X = X.to(torch.float64)
        bnorm = torch.linalg.norm(B)
        QtB = Qr.T @ B
        AtB = A64.T @ B
        cols = torch.linalg.norm(R64.T @ X - AtB, dim=0) / torch.linalg.norm(AtB, dim=0)
        gaps = {"qtb_backward": float(cols.max()),
                "qtb_gap": float(torch.linalg.norm(X - d[:, None] * QtB) / bnorm)}
        for name, value in gaps.items():
            worst[name] = max(worst.get(name, value), value)
    return worst
