"""Device selection for the port's entry points.

Entry points (``FieldEngine``, ``serve_field``) run on the CUDA card unless
the caller asks for the CPU by name.  There is no silent fallback: with no
card and no explicit ``device="cpu"`` they raise.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
