"""The one generator of every traffic mix: inputs from the seed, and the
calls of a closed loop into the program.

A traffic file names the program's entry point and its inputs:

  entry        the function called in the loop: an attribute of the
               program (``qr``, ``tsqr``), or with ``setup``, of what
               set-up returned (``apply_qt`` of a ``QRResult``);
  kwargs       keyword arguments of every call;
  setup        a function of the program called once in set-up on the
               first input, with the configuration (``qr_factor``);
  setup_outputs  attributes of set-up's result that the reference judges;
  pool         matrices A (the configuration's shape) drawn from the seed,
               cycled call by call;
  rhs_cols, rhs_pool  right-hand sides B (rows of A x rhs_cols), cycled;
  warmup_calls calls made before the window, which cover the pool;
  check, check_calls, trace_calls  the reference, how many calls of a run
               it judges (a sample drawn from the seed), how many calls a
               traced run profiles.

Every seed gets the same sizes and the same order of pool entries; only
the numbers differ.
"""

from __future__ import annotations

import torch

def qr_config(program, config: dict, device: str, overrides: dict | None = None):
    """The program's QRConfig as the configuration file states it."""
    fields = dict(config["qr_config"])
    fields.update({k: v for k, v in (overrides or {}).items() if k != "why"})
    fields["dtype"] = getattr(torch, fields["dtype"])
    return program.QRConfig(**fields, device=device)


class Generator:
    """Inputs of one run and the calls into the program."""

    def __init__(self, program, config: dict, traffic: dict, seed: int, device: str,
                 overrides: dict | None = None):
        self.traffic = traffic
        self.qcfg = qr_config(program, config, device, overrides)
        dtype = getattr(torch, config["dtype"])
        m, n = config["shape"]
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % (1 << 64))
        self.pools = {"A": torch.randn((traffic["pool"], m, n), generator=gen,
                                       device=device, dtype=dtype)}
        if traffic.get("rhs_cols"):
            self.pools["B"] = torch.randn((traffic["rhs_pool"], m, traffic["rhs_cols"]),
                                          generator=gen, device=device, dtype=dtype)
        self.kwargs = traffic.get("kwargs", {})
        self.handle = None
        if traffic.get("setup"):
            self.handle = getattr(program, traffic["setup"])(self.pools["A"][0], self.qcfg)
            self._fn = getattr(self.handle, traffic["entry"])
        else:
            self._fn = getattr(program, traffic["entry"])

    def key(self, i: int) -> dict:
        """Which pool entries call ``i`` reads."""
        key = {"a": i % self.traffic["pool"]}
        if "B" in self.pools:
            key["b"] = i % self.traffic["rhs_pool"]
        return key

    def call(self, i: int) -> tuple:
        """Call ``i`` of the loop; its answers as a tuple of tensors."""
        key = self.key(i)
        if self.handle is not None:
            out = self._fn(self.pools["B"][key["b"]], **self.kwargs)
        else:
            out = self._fn(self.pools["A"][key["a"]], self.qcfg, **self.kwargs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    def setup_outputs(self) -> dict:
        """What the reference reads of set-up's result."""
        return {name: getattr(self.handle, name)
                for name in self.traffic.get("setup_outputs", [])}
