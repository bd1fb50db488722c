"""Device selection for the port (no JAX counterpart: JAX picks its backend).

Every entry point takes `device=None` and resolves it here.  The default
is the GPU; the CPU runs only when the caller asks for it by name, as the
tests do.  Nothing falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda` by default, or the device the caller named.

    Raises RuntimeError when a CUDA device is wanted and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
