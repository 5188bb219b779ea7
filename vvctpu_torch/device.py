"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for another device; they
never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The torch.device an entry point runs on: ``cuda`` by default.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and is not available; pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return dev


_CONSTS: dict = {}


def const(a, device) -> torch.Tensor:
    """Device copy of a module-level numpy constant, uploaded once per
    device (an upload from pageable memory waits for the stream)."""
    key = (id(a), str(device))
    hit = _CONSTS.get(key)
    if hit is None or hit[0] is not a:
        hit = _CONSTS[key] = (a, torch.as_tensor(a, device=device))
    return hit[1]
