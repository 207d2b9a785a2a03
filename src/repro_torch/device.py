"""Device resolution for the port.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and a CUDA request on a machine without CUDA raises — the
port never drops to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def fake_group() -> bool:
    """Whether the default process group is a ``fake`` one: the dry-run's
    (:mod:`repro_torch.launch.dryrun`), whose program runs on fake tensors
    for the plan's target device, with no such device present."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and \
        dist.get_backend() == "fake"


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (``None`` -> ``cuda``).
    Raises RuntimeError when CUDA is asked for and absent, except on a
    :func:`fake_group`, where the card is the target of a program that
    allocates nothing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and \
            not fake_group():
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
    if dev.type == "cuda" and not torch.cuda.is_available():
        return "cuda:fake"                  # a fake group's target
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return "cpu:cpu"


def init_process_group(world_size: int = 1, rank: int = 0,
                       device: DeviceLike = None,
                       init_file: Optional[str] = None) -> str:
    """Start the default process group of this process, if none is: ``nccl``
    on the card (the rank's card is ``cuda:<rank % device_count>``),
    ``gloo`` on the CPU, over a ``FileStore`` at ``init_file`` (every rank
    of the group passes the same path; a fresh file in a temp dir when
    ``world_size`` is 1), so no port or network is needed.  A group that is
    already up must have ``world_size`` ranks, or this raises ValueError.
    Returns the backend's name."""
    import os
    import tempfile

    import torch.distributed as dist
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise ValueError(
                f"the process group has {dist.get_world_size()} ranks, not "
                f"the {world_size} asked for")
        return dist.get_backend()
    if init_file is None:
        if world_size != 1:
            raise ValueError("a group of more than one rank needs the "
                             "init_file every rank shares")
        init_file = os.path.join(tempfile.mkdtemp(prefix="repro_pg_"),
                                 "store")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        idx = rank % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        kw["device_id"] = torch.device("cuda", idx)
    dist.init_process_group(backend, store=dist.FileStore(init_file,
                                                          world_size),
                            rank=rank, world_size=world_size, **kw)
    return backend
