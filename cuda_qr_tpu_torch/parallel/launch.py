"""Run a function on P ranks of this host: the counterpart of the virtual
8-device CPU mesh the reference's tests use (``tests/conftest.py``).

``run_ranks(P, target, *args, device=...)`` spawns P processes.  Each sets
one thread, joins a process group through a ``file://`` store in a
temporary directory (no ports) with a collective timeout of
``COLLECTIVE_TIMEOUT_S``, builds
``row_mesh`` and calls ``target(mesh, *args)``.  The results come back in
rank order, converted for the host (``to_host``); the first failing rank's
exception is raised in the caller.  If the ranks have not finished within
``join_timeout`` seconds, they are killed and TimeoutError is raised, so a
hang costs one call, not a whole run.

``target`` must be importable by name (a module-level function of this
package), so that a spawned rank imports neither a test file nor JAX.
``call_many`` is such a target for any list of entry-point calls.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor

from ..utils.config import DEFAULT_CONFIG
from .collectives import gather_rows
from .mesh import backend_for, rank_device, row_mesh

GRACE_SECONDS = 2.0   # how long the other ranks may finish after one fails
COLLECTIVE_TIMEOUT_S = 60   # a collective that waits longer fails its rank


def to_host(obj, mesh):
    """``obj`` with every tensor as a numpy array: a row-sharded DTensor is
    gathered whole (every rank must call this on results of one
    structure), a plain tensor copied.  Tuples (named ones too), lists and
    dicts are walked."""
    if isinstance(obj, DTensor):
        return gather_rows(obj, mesh).cpu().numpy()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_host(v, mesh) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_host(v, mesh) for v in obj)
    if isinstance(obj, dict):
        return {k: to_host(v, mesh) for k, v in obj.items()}
    return obj


def _write(path: str, payload) -> None:
    with open(path + ".tmp", "wb") as f:
        pickle.dump(payload, f)
    os.replace(path + ".tmp", path)


def _rank_main(rank, P, tmp, backend, device):
    try:
        target, args = _load(os.path.join(tmp, "job.pkl"))
        torch.set_num_threads(1)
        if device != "cpu":
            torch.cuda.set_device(rank_device(backend, device, rank))
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                                rank=rank, world_size=P,
                                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = row_mesh(P, device)
        out = to_host(target(mesh, *args), mesh)
        if device != "cpu":
            torch.cuda.synchronize()
    except Exception as exc:  # reported to the caller, which re-raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(exc)
        except (pickle.PicklingError, TypeError, AttributeError):
            exc = RuntimeError(str(exc))   # it cannot cross the process boundary
        _write(os.path.join(tmp, f"error_{rank}.pkl"), (exc, tb))
        os._exit(1)   # skip teardown: the other ranks may sit in a collective
    _write(os.path.join(tmp, f"result_{rank}.pkl"), out)
    dist.destroy_process_group()


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_ranks(P: int, target, *args, device: str = DEFAULT_CONFIG.device,
              backend: str | None = None, join_timeout: float = 600.0) -> list:
    """``target(mesh, *args)`` on P spawned ranks; its results in rank order.

    ``device`` "cuda" (default) or "cpu"; ``backend`` defaults to
    ``mesh.backend_for(P, device)``; ``join_timeout`` bounds the whole run
    (s).
    """
    backend = backend or backend_for(P, device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cqt_ranks_") as tmp:
        # The job goes through a file: a large argument written into a
        # spawned child's pipe would hold up each start until that child
        # has imported torch, and the ranks would start one by one.
        _write(os.path.join(tmp, "job.pkl"), (target, args))
        procs = [ctx.Process(target=_rank_main, args=(r, P, tmp, backend, device))
                 for r in range(P)]
        for p in procs:
            p.start()
        results = [os.path.join(tmp, f"result_{r}.pkl") for r in range(P)]
        errors = [os.path.join(tmp, f"error_{r}.pkl") for r in range(P)]
        deadline = time.monotonic() + join_timeout
        failed_at = None
        try:
            while not all(map(os.path.exists, results)):
                if failed_at is None and (any(map(os.path.exists, errors)) or any(
                        p.exitcode not in (None, 0) for p in procs)):
                    failed_at = time.monotonic()
                if failed_at is not None and time.monotonic() - failed_at > GRACE_SECONDS:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {P} ranks of {target.__name__} did not "
                                       f"finish within {join_timeout:g} s")
                time.sleep(0.02)
            for r, path in enumerate(errors):
                if os.path.exists(path):
                    exc, tb = _load(path)
                    exc.add_note(f"raised on rank {r} of {P}:\n{tb}")
                    raise exc
            missing = [r for r, path in enumerate(results) if not os.path.exists(path)]
            if missing:
                raise RuntimeError(f"run_ranks: ranks {missing} exited without a result "
                                   f"(exit codes {[procs[r].exitcode for r in missing]})")
            return [_load(path) for path in results]
        finally:
            _kill(procs)


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


MESH = "<mesh>"   # stands for the rank's mesh in the arguments of ``call_many``


def _resolve(name: str):
    """A public name of cuda_qr_tpu_torch, or "module:function" inside it."""
    import importlib

    import cuda_qr_tpu_torch as ct
    if ":" not in name:
        return getattr(ct, name)
    module, fn = name.split(":")
    return getattr(importlib.import_module(f"cuda_qr_tpu_torch.{module}"), fn)


def call_many(mesh, calls):
    """Rank body: each (name, args, kwargs) of ``calls`` in turn, ``MESH``
    in the arguments standing for the mesh.  Returns the results in order;
    a call that raised gives its exception in place of a result, so a
    single spawn can hold error cases too (they must raise on every rank
    alike, before any collective)."""
    out = []
    for name, args, kwargs in calls:
        args = [mesh if isinstance(a, str) and a == MESH else a for a in args]
        try:
            out.append(_resolve(name)(*args, **kwargs))
        except Exception as exc:  # returned to the caller as the call's result
            out.append(exc)
    return out
