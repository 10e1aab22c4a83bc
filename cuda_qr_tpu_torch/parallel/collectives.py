"""The collectives of the distributed paths, one function per collective
that the reference's ``shard_map`` bodies use, on the row mesh's group.

  jax.lax.psum                ``psum``        all_reduce(SUM)
  jax.lax.all_gather          ``all_gather``  all_gather_into_tensor, rank order
  jax.lax.ppermute            ``ppermute``    batch_isend_irecv
  lax.cond on a psum'd flag   ``agree``       all_reduce(MAX) of the flag, then
                                              one host decision
  a resharding (``A[perm]``   ``redistribute_rows``  all_to_all_single: each
  of a row-sharded array)                     rank sends each other rank the
                                              rows it gets, nothing more

Every rank must reach the same collectives in the same order, so every
data-dependent branch of a distributed path goes through ``agree``: a rank
whose local copy of a flag differed by a bit would otherwise skip a
collective and hang the others (until the process group's timeout).

gloo on CUDA tensors serves all_reduce, broadcast and all_gather; its
point-to-point operations take CPU tensors only.  Those, and the
all-to-all with them (``HOST_OPS``), go through host memory: the tensor is
copied to the host, exchanged there and copied back.  ``host_hops`` counts
each such hop by operation.  Compute never leaves the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.smalllinalg import host_decision, host_values
from .mesh import ROW_AXIS, mesh_device

HOST_OPS = frozenset({"ppermute", "all_to_all"})

# all_gather_into_tensor, under the name newer torch releases give it
_all_gather_single = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)

# Operations that went through host memory since the last reset, by name.
host_hops: dict[str, int] = {}


def coord(mesh: DeviceMesh) -> int:
    """This rank's coordinate on the row axis (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(ROW_AXIS)


def _group(mesh: DeviceMesh):
    return mesh.get_group(ROW_AXIS)


def _via_host(x: torch.Tensor, mesh: DeviceMesh, op: str) -> bool:
    if x.is_cuda and op in HOST_OPS and dist.get_backend(_group(mesh)) == "gloo":
        host_hops[op] = host_hops.get(op, 0) + 1
        return True
    return False


def psum(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum of x over the ranks, on every rank (x is not modified)."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=_group(mesh))
    return y


def all_gather(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """(P, *x.shape): every rank's x, in rank (= mesh coordinate) order."""
    P = mesh.size(0)
    out = torch.empty((P * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x.contiguous(), group=_group(mesh))
    return out.view((P,) + tuple(x.shape))


def gather_rows(A, mesh: DeviceMesh) -> torch.Tensor:
    """A row-sharded DTensor A, whole, on every rank."""
    if A.shape[0] % mesh.size(0):                   # uneven shards
        return A.full_tensor()
    return all_gather(A.to_local(), mesh).reshape(tuple(A.shape))


def broadcast(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's x on every rank (x is not modified)."""
    y = x.contiguous().clone()
    dist.broadcast(y, dist.get_global_rank(_group(mesh), 0), group=_group(mesh))
    return y


def ppermute(x: torch.Tensor, mesh: DeviceMesh, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) coordinate
    pairs; returns the x sent to this rank (zeros if none is)."""
    me, g = coord(mesh), _group(mesh)
    host = _via_host(x, mesh, "ppermute")
    send = x.contiguous().cpu() if host else x.contiguous()
    recv = torch.zeros_like(send)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(g, dst), g))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(g, src), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv.to(x.device) if host else recv


def all_to_all(x: torch.Tensor, send_rows, recv_rows, mesh: DeviceMesh) -> torch.Tensor:
    """Rows of x to every rank: the first ``send_rows[0]`` rows to rank 0,
    the next ``send_rows[1]`` to rank 1, ...; returns the rows received,
    ``recv_rows[s]`` from rank s, in rank order."""
    host = _via_host(x, mesh, "all_to_all")
    send = x.contiguous().cpu() if host else x.contiguous()
    recv = torch.empty((sum(recv_rows),) + tuple(x.shape[1:]), dtype=x.dtype, device=send.device)
    dist.all_to_all_single(recv, send, [int(r) for r in recv_rows], [int(r) for r in send_rows],
                           group=_group(mesh))
    return recv.to(x.device) if host else recv


def redistribute_rows(x: torch.Tensor, rows_before, rows_after, mesh: DeviceMesh) -> torch.Tensor:
    """Move the rows of a row-sharded matrix from one distribution to
    another in one all-to-all; no rank holds more than its own rows.

    ``x`` is this rank's rows before.  ``rows_before(r)`` and
    ``rows_after(r)`` give, for every rank r, the logical row index of each
    of r's local rows (1-D integer numpy arrays).  Returns this rank's rows
    after: zeros where no rank held the logical row (padding); a row with
    no place after is dropped."""
    P, me = mesh.size(0), coord(mesh)
    before = [np.asarray(rows_before(r), np.int64) for r in range(P)]
    after = [np.asarray(rows_after(r), np.int64) for r in range(P)]
    size = 1 + max((int(a.max()) for a in before + after if a.size), default=-1)
    owner, pos = np.full(size, -1), np.zeros(size, np.int64)
    for r, rows in enumerate(after):
        owner[rows], pos[rows] = r, np.arange(rows.size)

    def plan(r):
        """(local indices of the rows rank r sends, their destinations),
        grouped by destination; every rank computes the same plan."""
        dest = owner[before[r]]
        keep = np.flatnonzero(dest >= 0)
        keep = keep[np.argsort(dest[keep], kind="stable")]
        return keep, dest[keep]

    keep, dest = plan(me)
    incoming = []
    for r in range(P):
        k, d = plan(r)
        incoming.append(pos[before[r][k[d == me]]])
    got = all_to_all(x[torch.as_tensor(keep, device=x.device)], np.bincount(dest, minlength=P),
                     [len(p) for p in incoming], mesh)
    out = torch.zeros((after[me].size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    out[torch.as_tensor(np.concatenate(incoming), device=x.device)] = got
    return out


def pmax(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Elementwise maximum of x over the ranks, on every rank."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_group(mesh))
    return y


def agree(flag: torch.Tensor, mesh: DeviceMesh) -> bool:
    """A rank-uniform host decision: True on every rank if ``flag`` (a 0-d
    bool tensor) is True on any (one all_reduce(MAX), one host sync)."""
    v = flag.reshape(1).to(mesh_device(mesh), torch.int32)
    dist.all_reduce(v, op=dist.ReduceOp.MAX, group=_group(mesh))
    return host_decision(v[0] > 0)


def pmin(value: int, mesh: DeviceMesh) -> int:
    """The least of an integer over the ranks, on every rank."""
    v = torch.tensor([value], dtype=torch.int64, device=mesh_device(mesh))
    dist.all_reduce(v, op=dist.ReduceOp.MIN, group=_group(mesh))
    return int(host_values(v)[0])
