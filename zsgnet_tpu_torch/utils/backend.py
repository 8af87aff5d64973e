"""Device selection for the entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Asking for
a CUDA device on a machine without one raises: the port never falls back
to the CPU on its own. The CPU runs only when the caller asks for it, as
the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
