"""lru_scan — the diagonal linear recurrence of the RG-LRU,
``h_t = a_t * h_{t-1} + b_t`` with ``h_0 = 0``, as hand-written CUDA
kernels for Hopper (``csrc/lru_scan.cu``).

Replaces the Pallas kernel ``lru_scan`` of ``src/repro/kernels/lru_scan.py``
(the prefill scan of the ``rg_lru`` op): the state stays in fp32 and never
reaches device memory between steps; h is written in a's dtype.  The
hybrid hands it fp32 ``a`` and ``b`` in both model precisions (``op_rg_lru``
computes the gate and the gated input in fp32).

What bounds it on the H100: the bytes.  It reads a and b once and writes h
once, two operations (one FMA) per element: at recurrentgemma-2b's prefill
shape (B=8, S=512, W=2560, fp32) that is 3 x 41.9 MB against 21 MFLOP, so
~0.038 ms at 3.35 TB/s; the window run's (1, 2080, 2560) ~0.019 ms.

Two schedules, picked by :func:`_schedule` (a dispatch between hand-written
kernels, not a fallback):

- ``chunked``: a chunked two-pass scan.  A block is a strip of 128 bytes of
  channels of one batch row (32 fp32 or 64 bf16 channels, 4 bytes a lane)
  by C warps along S; it walks S in windows of TS steps through a
  three-window ``cp.async`` ring in shared memory.  In a window each warp
  scans its 8 steps to a product and a local end, every warp folds the C
  pairs in order into its carry-in, then rescans its steps from it and
  writes h.  TS (32, 64 or 128; C = TS / 8) comes from
  :func:`scan_geometry`: the smallest window that keeps 48 KB of loads in
  flight on an SM, so that one row (B = 1: 80 blocks of 16 warps at W 2560)
  still has two 32 KB windows of loads in flight on every SM it occupies.
  Needs W * elem a multiple of 16 and 16-byte aligned operands.
- ``seq``: the kernel before it, one thread a (b, w) channel walking S in
  order, 16 steps of loads ahead; for the rest (odd widths, unaligned
  views).  At B = 1 it has 2,560 threads on a 132-SM card: latency-bound.

The chunked scan reassociates the recurrence across chunks, as the plain
version (log-step doubling) and the JAX package's ``lru_scan_ref``
(associative scan) do.  Neither schedule takes a tile: the window follows
:func:`scan_geometry`, and no ``plan.tiles`` entry names the scan (the
JAX kernel takes none either).

On a CPU tensor the wrapper runs :func:`lru_scan_plain`; on a CUDA tensor
it launches a kernel or raises.  ``lru_scan.launches`` counts the
launches, ``lru_scan.schedules`` splits them by schedule and
``lru_scan.shapes`` by (B, S, W, dtype).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_fused import _sm_count

SCHEDULES = ("chunked", "seq")
STEPS_A_WARP = 8            # a warp's steps of a window (csrc STEPS_A_WARP)
NSTAGE = 3                  # windows in the cp.async ring (csrc NSTAGE)
ROW_BYTES = 128             # a strip's bytes a step (csrc ROW_BYTES)
WINDOW_STEPS = (32, 64, 128)
INFLIGHT_BYTES = 48 * 1024  # loads in flight an SM that the window aims at


def scan_geometry(B: int, S: int, W: int, elem: int,
                  sms: int = 132) -> Tuple[int, int, int]:
    """(steps, warps, blocks) of the chunked schedule: a block per 128-byte
    strip of one row's channels, the window TS the smallest of 32, 64, 128
    (and no longer than S calls for) whose NSTAGE - 1 windows ahead of a
    and b, over the blocks an SM holds, reach INFLIGHT_BYTES; C = TS / 8
    warps a block."""
    blocks = B * -(-W * elem // ROW_BYTES)
    per_sm = -(-blocks // sms)
    steps = WINDOW_STEPS[0]
    while (steps < WINDOW_STEPS[-1] and steps < S and per_sm * (NSTAGE - 1)
           * steps * 2 * ROW_BYTES < INFLIGHT_BYTES):
        steps *= 2
    return steps, steps // STEPS_A_WARP, blocks


def _schedule(W: int, elem: int, aligned: bool) -> str:
    """``chunked`` when a row of W elements is a whole number of 16-byte
    chunks and a, b and h are 16-byte aligned, else ``seq``."""
    return "chunked" if aligned and (W * elem) % 16 == 0 else "seq"


def lru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: an fp32 scan by log-step
    doubling over the sequence axis (the JAX package's ``lru_scan_ref``
    is an associative scan with the same combine), cast to a's dtype.
    After the step of stride d, (A_t, H_t) is the composition of the
    steps t-2d+1 .. t: ``H_t = A_t * H_{t-d} + H_t``, ``A_t = A_t * A_{t-d}``."""
    A, H = a.float(), b.float()
    S, d = a.shape[1], 1
    while d < S:
        H = torch.cat([H[:, :d], A[:, d:] * H[:, :-d] + H[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], dim=1)
        d *= 2
    return H.to(a.dtype)


def lru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: (B, S, W) of one dtype (fp32 or bf16) -> h: (B, S, W) in a's
    dtype, h_t = a_t * h_{t-1} + b_t with h_0 = 0, the state in fp32."""
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"lru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} are not one (B, S, W) shape")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return lru_scan_plain(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("lru_scan: both operands must be on the same CUDA "
                         f"device (a on {a.device}, b on {b.device})")
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"lru_scan: unsupported dtypes a {a.dtype}, "
                        f"b {b.dtype}")
    Bn, S, W = a.shape
    ac, bc = a.contiguous(), b.contiguous()
    h = torch.empty_like(ac)
    code = _build.DTYPE_CODES[a.dtype]
    sched = _schedule(W, a.element_size(), all(
        t.data_ptr() % 16 == 0 for t in (ac, bc, h)))
    if sched == "chunked":
        steps, _, _ = scan_geometry(Bn, S, W, a.element_size(),
                                    _sm_count(a.device))
        _build.call("lru_scan_chunked", code, _build.ptr(ac), _build.ptr(bc),
                    _build.ptr(h), Bn, S, W, steps, _build.stream())
    else:
        _build.call("lru_scan", code, _build.ptr(ac), _build.ptr(bc),
                    _build.ptr(h), Bn, S, W, _build.stream())
    lru_scan.launches += 1
    lru_scan.schedules[sched] += 1
    key = (Bn, S, W, str(a.dtype).split(".")[-1])
    lru_scan.shapes[key] = lru_scan.shapes.get(key, 0) + 1
    return h


lru_scan.launches = 0
lru_scan.schedules = dict.fromkeys(SCHEDULES, 0)
lru_scan.shapes = {}


def lru_scan_fake(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`lru_scan`'s shape-only stand-in (the dry-run): h unfilled,
    and 2 operations an element (one multiply, one add)."""
    from repro_torch.kernels import _fake
    h = torch.empty_like(a)
    _fake.count("lru_scan", 2 * a.numel(), _fake.nbytes(a, b, h))
    return h
