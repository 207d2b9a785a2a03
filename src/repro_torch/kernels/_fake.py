"""The work a hand kernel's shape-only stand-in counts.

Each kernel module holds, beside its wrapper, a ``*_fake`` function with
the wrapper's signature: it returns outputs of the right shape and dtype
(``torch.empty``: under a ``FakeTensorMode`` nothing is allocated) and
adds the kernel's floating-point operations and the bytes it must move
(each input read once, each output written once) to :data:`COST`, by
kernel.  The registry hands the stand-ins out inside
:func:`repro_torch.kernels.registry.fake_kernels`, which only the dry-run
(:mod:`repro_torch.launch.dryrun`) enters: a wrapper launches through
device pointers and cannot run on fake tensors.  Inside :func:`scan` the
counts are taken by a scan's trip count (the dry-run's own counters of
the ops outside the kernels read :func:`trips` too).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

#: kernel -> {"calls", "flops", "bytes"}, summed over the stand-ins' calls
COST: Dict[str, Dict[str, int]] = {}
#: the scans being costed, innermost last: (name, trip count)
_SCANS: List[Tuple[str, int]] = []
#: scan -> {"flops", "bytes"}: the work counted inside each named scan
SCAN_COST: Dict[str, Dict[str, int]] = {}


@contextlib.contextmanager
def scan(name: str, trips: int):
    """Inside, the work the dry-run's counters see is taken ``trips`` times
    (times the enclosing scans' trips) and tallied under ``name`` in
    :data:`SCAN_COST`: a loop whose trips all do the same work runs its
    body once and stands for every trip, as a traced ``lax.scan`` costs
    its body by its trip count."""
    _SCANS.append((name, int(trips)))
    try:
        yield
    finally:
        _SCANS.pop()


def trips() -> int:
    """How many times the work counted now is taken (:func:`scan`)."""
    return math.prod(n for _, n in _SCANS)


def tally(flops: int, moved: int) -> None:
    """Add work already taken :func:`trips` times to every scan open."""
    for name in dict.fromkeys(n for n, _ in _SCANS):
        c = SCAN_COST.setdefault(name, {"flops": 0, "bytes": 0})
        c["flops"] += int(flops)
        c["bytes"] += int(moved)


def nbytes(*ts: Optional[torch.Tensor]) -> int:
    """The bytes of the tensors given (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def count(kernel: str, flops: int, moved: int) -> None:
    n = trips()
    c = COST.setdefault(kernel, {"calls": 0, "flops": 0, "bytes": 0})
    c["calls"] += n
    c["flops"] += n * int(flops)
    c["bytes"] += n * int(moved)
    tally(n * int(flops), n * int(moved))


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
