"""Device selection for the port (counterpart of the JAX package's
``utils/jaxenv.py``).

Every entry point takes ``device=None`` and resolves it here: the card
when CUDA is present, and an error when it is not. The CPU is used only
when the caller asks for it by name, as the tests do; nothing falls back
to it silently.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and absent."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device for the launches under it (a
    kernel goes to the current device's context, so a launch on another
    device's stream must be made there); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
