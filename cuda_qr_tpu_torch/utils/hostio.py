"""Host <-> device helpers (the public ``to_device``/``to_host``).

The reference's versions (``cuda_qr_tpu/utils/hostio.py``) split complex
arrays into real parts because its remote TPU link could not carry complex
bytes.  A local card has no such limit, so both are plain here:

``to_device(x)``: a tensor passes through unchanged; anything else becomes
  a tensor on ``DEFAULT_CONFIG.device`` (the card by default).  Without a
  card that raises torch's own error: nothing falls back to the host.
``to_host(x)``: a numpy array.  A row-sharded DTensor is gathered whole
  (every rank must call it); bfloat16, which numpy has no dtype for, comes
  back as float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_CONFIG


def to_device(x) -> torch.Tensor:
    """``x`` as a tensor on ``DEFAULT_CONFIG.device`` (a tensor unchanged)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=DEFAULT_CONFIG.device)


def to_host(x) -> np.ndarray:
    """``x`` as a numpy array (bfloat16 as float32)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        from ..parallel.collectives import gather_rows
        x = gather_rows(x, x.device_mesh)
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)
