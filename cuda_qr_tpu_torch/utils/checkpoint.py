"""Checkpoint/resume for long-running factorizations
(``cuda_qr_tpu/utils/checkpoint.py``).

State is a dict of arrays (tensors are copied to the host) plus a
JSON-able meta dict, written atomically (tmp + rename) so that a crash
mid-write never corrupts the previous snapshot.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_state(path: str, state: dict, meta: dict) -> None:
    """Atomically write {name: array} + meta to ``path`` (.npz)."""
    arrays = {k: _host(v) for k, v in state.items()}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str):
    """Returns (state dict of numpy arrays, meta dict), or (None, None)."""
    if not os.path.exists(path):
        return None, None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        state = {k: z[k] for k in z.files if k != "__meta__"}
    return state, meta
