"""PyTorch + CUDA port of the PUMA serving stack (the JAX package ``repro`` is
the reference it is checked against).

Entry points take ``device=`` and default to ``"cuda"``.  Without a card the
caller has to ask for ``"cpu"`` explicitly: nothing falls back quietly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(name) -> torch.dtype:
    """Config dtype string (``"bfloat16"``, ...) -> ``torch.dtype``."""
    return _DTYPES[name]
