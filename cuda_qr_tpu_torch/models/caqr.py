"""User-facing distributed CAQR: the padding wrapper over ``parallel/caqr.py``
(``cuda_qr_tpu/models/caqr.py``), BASELINE config 5's entry point.

Every rank calls these with the same arguments.  A is the full matrix on
every rank (tensor or numpy; only this rank's rows reach its device) or a
row-sharded DTensor.  Q comes back as a row-sharded DTensor of the
logical (m x n) Q, R as a plain tensor, the same on every rank.  Complex A
runs at its own dtype with the "allgather" combine and no kernel, whatever
``combine`` says (the reference's routing, ``cuda_qr_tpu/models/caqr.py:49-52``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..ops.blocked import complex_config, is_complex
from ..parallel.caqr import _logical_rows, caqr_factor, caqr_orgqr
from ..parallel.collectives import coord, redistribute_rows
from ..parallel.mesh import as_row_sharded, mesh_device
from ..utils.config import DEFAULT_CONFIG, QRConfig
from ..utils.errors import QRShapeError
from ..utils.geometry import ceildiv, round_up


def _padded_shape(m: int, n: int, P: int, nb: int) -> tuple[int, int]:
    """(m_pad, n_pad): rows a multiple of P*nb (at least n_pad), columns a
    multiple of nb."""
    n_pad = round_up(n, nb)
    return max(round_up(m, P * nb), round_up(n_pad, P * nb)), n_pad


def _chunk_rows(m: int, P: int):
    """rank -> its logical rows of an m-row DTensor with Shard(0) (torch's
    split: ceil(m / P) rows a rank, the last ranks fewer or none)."""
    c = ceildiv(m, P)
    return lambda r: np.arange(min(r * c, m), min((r + 1) * c, m))


def _storage_rows(layout: str, nb: int, mloc: int, P: int):
    """rank -> its logical rows in the layout's storage order."""
    return lambda r: _logical_rows(layout, nb, mloc, P, r, mloc).numpy()


def _pad_for_mesh(A, mesh: DeviceMesh, nb: int, layout: str = "block"):
    """A zero-padded to ``_padded_shape``, as a row-sharded DTensor in the
    layout's storage order.  A full A (on every rank) gives each rank its
    own rows; a row-sharded DTensor's rows move by one all-to-all
    (``redistribute_rows``) unless they are in place already (block
    layout, no padding rows)."""
    m, n = A.shape
    P = mesh.size(0)
    m_pad, n_pad = _padded_shape(m, n, P, nb)
    rows = _storage_rows(layout, nb, m_pad // P, P)
    if isinstance(A, DTensor):
        a = A.to_local()
        if layout == "cyclic" or m_pad != m:            # else the rows are in place
            a = redistribute_rows(a, _chunk_rows(m, P), rows, mesh)
    else:
        idx = rows(coord(mesh))
        live = idx < m                                  # the others are padding
        if isinstance(A, torch.Tensor):
            src = A[torch.as_tensor(idx[live], device=A.device)]
        else:
            src = torch.as_tensor(np.asarray(A)[idx[live]], device=mesh_device(mesh))
        a = torch.zeros((idx.size, n), dtype=src.dtype, device=src.device)
        a[torch.as_tensor(live, device=a.device)] = src
    if n_pad != n:
        a = torch.nn.functional.pad(a, (0, n_pad - n))
    return as_row_sharded(a, mesh, m_pad)


def _check(A, config: QRConfig, combine: str):
    """(config, combine) A runs at, after the shape check: complex A takes
    its own dtype, no kernel and the "allgather" combine."""
    m, n = A.shape
    if m < n:
        raise QRShapeError(f"caqr requires m >= n, got {m}x{n}")
    if is_complex(A):
        return complex_config(A, config), "allgather"
    return config, combine


def caqr(A, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
         layout: str = "block", combine: str = "bk"):
    """Thin distributed QR: (Q (m x n) row-sharded DTensor, R (n x n)
    replicated).  Any m >= n; pads internally to the mesh grid.

    layout="cyclic" deals nb-row blocks round-robin over the ranks (the
    ScaLAPACK-style distribution of BASELINE config 5); rows move into and
    out of the cyclic storage order by one all-to-all each way, so no rank
    holds more than its share of A or Q.  combine="bk" (default) applies
    each panel's tree Q in basis-kernel form (one nb x trailing all_reduce
    per panel); "allgather" is the one-round redundant stacked-QR combine.
    """
    config, combine = _check(A, config, combine)
    m, n = A.shape
    nb, P = config.panel_width, mesh.size(0)
    Ap = _pad_for_mesh(A, mesh, nb, layout)
    factors, R = caqr_factor(Ap, mesh, config, layout=layout, combine=combine)
    Q = caqr_orgqr(factors, mesh, n, config, layout=layout)
    if Q.shape[0] == m and layout == "block":
        return Q, R[:n, :n]
    rows = _storage_rows(layout, nb, Ap.shape[0] // P, P)
    q = redistribute_rows(Q.to_local(), rows, _chunk_rows(m, P), mesh)
    return as_row_sharded(q, mesh, m), R[:n, :n]


def caqr_r(A, mesh: DeviceMesh, config: QRConfig = DEFAULT_CONFIG,
           combine: str = "bk") -> torch.Tensor:
    """R-only distributed factorization: R (n x n), replicated."""
    config, combine = _check(A, config, combine)
    n = A.shape[1]
    Ap = _pad_for_mesh(A, mesh, config.panel_width)
    _, R = caqr_factor(Ap, mesh, config, combine=combine)
    return R[:n, :n]
