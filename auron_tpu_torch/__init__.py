"""auron_tpu_torch — the PyTorch/CUDA port of the auron_tpu query engine.

The package keeps the JAX package's module layout (ir, config, columnar,
exprs, ops, runtime) so each module's counterpart is found by name, and
imports nothing from it: what it needs it keeps its own copy of.  It runs
on one NVIDIA GPU.  Every entry point takes `device=` and defaults to the
card; without one it raises unless the caller asked for the CPU, where the
kernels run their plain PyTorch versions (the parity tests do that).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device a task runs on: `cuda` unless the caller names another.

    Raises when a CUDA device is asked for (or defaulted to) and none is
    present: the engine never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "auron_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["__version__", "resolve_device"]
