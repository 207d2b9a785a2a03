"""The work a hand kernel's shape-only stand-in counts.

Each kernel module holds, beside its wrapper, a ``*_fake`` function with
the wrapper's signature: it returns outputs of the right shape and dtype
(``torch.empty``: under a ``FakeTensorMode`` nothing is allocated) and
adds the kernel's floating-point operations and the bytes it must move
(each input read once, each output written once) to :data:`COST`, by
kernel.  The registry hands the stand-ins out inside
:func:`repro_torch.kernels.registry.fake_kernels`, which only the dry-run
(:mod:`repro_torch.launch.dryrun`) enters: a wrapper launches through
device pointers and cannot run on fake tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

#: kernel -> {"calls", "flops", "bytes"}, summed over the stand-ins' calls
COST: Dict[str, Dict[str, int]] = {}


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    """The bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def count(kernel: str, flops: int, moved: int) -> None:
    c = COST.setdefault(kernel, {"calls": 0, "flops": 0, "bytes": 0})
    c["calls"] += 1
    c["flops"] += int(flops)
    c["bytes"] += int(moved)


def attended(Sq: int, Skv: int, causal: bool, window: Optional[int],
             q_offset: int = 0) -> int:
    """The (query, key) pairs a row of ``Sq`` queries scores over ``Skv``
    keys: every pair, or with ``causal`` the keys at or before the query's
    position (``q_offset + i``), and with ``window`` only the ``window``
    latest of those."""
    p = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.minimum(p, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(0, p - window + 1) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())
