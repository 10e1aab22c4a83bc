"""The row mesh of the distributed paths (``cuda_qr_tpu/parallel/mesh.py``).

The reference is single-controller: one ``jax.sharding.Mesh`` over the
``"rows"`` axis, and one call runs a ``shard_map`` body on every device.
Here each rank is a process (``torch.distributed``), every rank calls the
same entry point, and the mesh is a 1-D ``DeviceMesh`` over all ranks:

  row_sharding(mesh) / replicated(mesh)  placements (Shard(0),) / (Replicate(),)
  jax.device_put(A, row_sharding(mesh))  ``shard_rows`` + ``as_row_sharded``
  a row-sharded result (Q)               a DTensor with Shard(0)
  a replicated result (R, x, s, ...)     a plain tensor, the same on every rank
  jax.lax.axis_index(ROW_AXIS)           ``collectives.coord(mesh)``

Backend and device, per rank: NCCL with rank r on ``cuda:r`` (by
LOCAL_RANK under ``torchrun``) when the ranks fit the host's cards; gloo
with every rank on ``cuda:0`` when there are more ranks than cards (the
stand-in for the reference's virtual mesh, compute still on the card); gloo
on the CPU for ``device="cpu"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.config import DEFAULT_CONFIG
from ..utils.errors import QRShapeError

ROW_AXIS = "rows"


def backend_for(n_ranks: int, device: str) -> str:
    """gloo on the CPU; on cards NCCL when every rank has a card of its
    own, else gloo (NCCL refuses two ranks on one card)."""
    if device == "cpu":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device of ``rank``: its own card under NCCL, card 0 under gloo."""
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda", 0)


def row_mesh(n_devices: int | None = None, device: str | None = None) -> DeviceMesh:
    """1-D mesh over the row (m) axis of all ranks, the TSQR/CAQR reduction
    axis.  Called by every rank.  Without a process group yet, one is made
    from the environment ``torchrun`` sets, with the backend of
    ``backend_for``.  ``n_devices`` (if given) must equal the world size:
    every rank of the group is a shard."""
    device = device or DEFAULT_CONFIG.device
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        backend = backend_for(world, device)
        if device != "cpu":
            torch.cuda.set_device(rank_device(backend, device, int(os.environ.get("RANK", "0"))))
        dist.init_process_group(backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"row_mesh({n_devices}) in a group of {world} ranks: "
                         f"the mesh spans every rank")
    if device != "cpu":
        torch.cuda.set_device(rank_device(dist.get_backend(), device, rank))
    mesh = init_device_mesh("cpu" if device == "cpu" else "cuda", (world,),
                            mesh_dim_names=(ROW_AXIS,))
    # Gathers come back in group-rank order and the code indexes them by the
    # mesh coordinate: the two must be one number.
    if dist.get_rank(mesh.get_group(ROW_AXIS)) != mesh.get_local_rank(ROW_AXIS):
        raise RuntimeError("row mesh coordinate differs from the group rank")
    return mesh


def row_sharding(mesh: DeviceMesh):
    return (Shard(0),)


def replicated(mesh: DeviceMesh):
    return (Replicate(),)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def shard_rows(A, mesh: DeviceMesh):
    """(this rank's rows of A, global row count m).

    A is a row-sharded DTensor (its local tensor, as it lies), or a full
    matrix that every rank holds (tensor or numpy; only this rank's block of
    m / P rows is moved to the rank's device).  m must divide the mesh.
    """
    P = mesh.size(0)
    if isinstance(A, DTensor):
        if tuple(A.placements) != row_sharding(mesh):
            raise ValueError(f"expected a row-sharded DTensor, got placements {A.placements}")
        return A.to_local(), A.shape[0]
    if not isinstance(A, torch.Tensor):
        A = np.asarray(A)
    m = A.shape[0]
    if m % P:
        raise QRShapeError(f"m={m} must divide the mesh ({P} shards)")
    i, mloc = mesh.get_local_rank(ROW_AXIS), m // P
    return torch.as_tensor(A[i * mloc:(i + 1) * mloc], device=mesh_device(mesh)), m


def as_row_sharded(local: torch.Tensor, mesh: DeviceMesh, m: int) -> DTensor:
    """The row-sharded DTensor (m x ...) whose shard on this rank is
    ``local``; no communication."""
    shape = (m,) + tuple(local.shape[1:])
    stride = tuple(int(np.prod(shape[d + 1:])) for d in range(len(shape)))
    return DTensor.from_local(local.contiguous(), mesh, row_sharding(mesh), run_check=False,
                              shape=torch.Size(shape), stride=stride)
