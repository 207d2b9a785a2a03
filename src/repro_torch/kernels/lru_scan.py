"""lru_scan — the diagonal linear recurrence of the RG-LRU,
``h_t = a_t * h_{t-1} + b_t`` with ``h_0 = 0``, as a hand-written CUDA
kernel for Hopper (``csrc/lru_scan.cu``).

Replaces the Pallas kernel ``lru_scan`` of ``src/repro/kernels/lru_scan.py``
(the prefill scan of the ``rg_lru`` op): the state stays in fp32 and never
reaches device memory between steps; h is written in a's dtype.

What bounds it on the H100: the bytes.  It reads a and b once and writes h
once, two operations (one FMA) per element: at recurrentgemma-2b's prefill
shape (B=8, S=512, W=2560, fp32) that is 3 x 41.9 MB against 21 MFLOP, so
~0.038 ms at 3.35 TB/s.

The design: the TPU kernel keeps a (1, 512)-lane state in VMEM per grid
step (B, W/512) and walks S in order.  Here each thread owns one (b, w)
channel, 128 channels a block, so that a warp's loads of one time step
fall on 128 contiguous bytes; the dependent FMA chain over S runs in a
register, and the next 16 steps' a and b are loaded ahead (unrolled), so
their memory requests are in flight while the chain runs.  B x W threads
in all (20,480 at the chip shape, 160 blocks on 132 SMs): few, so the
latency of the loads, not the bandwidth, sets the pace; a chunked
two-pass scan (per-chunk products, then a carry) is the later speed work.

On a CPU tensor the wrapper runs :func:`lru_scan_plain`; on a CUDA tensor
it launches the kernel or raises.  ``lru_scan.launches`` counts the
launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
    _build.call("lru_scan", _build.DTYPE_CODES[a.dtype], _build.ptr(ac),
                _build.ptr(bc), _build.ptr(h), Bn, S, W, _build.stream())
    lru_scan.launches += 1
    return h


lru_scan.launches = 0
