"""Device resolution for the port.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without CUDA raises — the
port never drops to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (``None`` -> ``cuda``).
    Raises RuntimeError when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but torch.cuda is not "
            "available; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def hopper_ok(device: Optional[torch.device] = None) -> bool:
    """True when CUDA is available and the (current) card has compute
    capability (9, 0) — the ``sm_90a`` target the hand kernels are built for."""
    if not torch.cuda.is_available():
        return False
    idx = None if device is None or device.index is None else device.index
    return torch.cuda.get_device_capability(idx) == (9, 0)


def device_key(device: Optional[torch.device] = None) -> str:
    """``"<backend>:<device kind>"`` — the tunedb fingerprint form, so a
    record measured on one platform never serves another: ``"cuda:<card
    name>"`` or ``"cpu:cpu"`` (the JAX package's CPU key).  ``None`` means
    the entry points' default, the card, or the CPU where CUDA is absent."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu:cpu"
