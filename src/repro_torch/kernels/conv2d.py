"""conv2d_fused — direct 2-D convolution with the fused BN/activation
epilogue, as a hand-written CUDA kernel for Hopper (``csrc/conv2d_fused.cu``).

Replaces the Pallas kernel ``conv2d_fused`` of ``src/repro/kernels/conv2d.py``
(the paper's workhorse op): x (N, H, W, CI) NHWC times w (kh, kw, CI, CO)
HWIO, stride, SAME or VALID padding, fp32 accumulation, then the inference
batch-norm fold ``(y - mean) * rsqrt(var + 1e-5) * scale + bias`` and the
activation before the single write, in ``x.dtype``.  groups = 1 only: the
registry sends a grouped (depthwise) conv to the reference op.

What bounds it on the H100: at ResNet-34's shapes a conv does 100-300
operations per byte it must move, near or above the card's ridge (about 295
in bf16), so tensor-core FLOPs bound most layers and bytes bound the few with
little depth (the 7x7 stem has K = 147).  ``chip_smoke.py`` states the bound
of each shape.

The simple design: an implicit GEMM with M = N*Ho*Wo, K = kh*kw*CI, N = CO.
Each block of 256 threads owns a 64 x 64 output tile; per 16-deep K step it
gathers the input tile (the padding is a predicate in the gather, with
XLA's low/high split, so the input is never padded in memory) and the weight
tile into shared memory as fp32, and each thread accumulates a 4 x 4 patch
with fp32 FMAs on the CUDA cores.  That caps it at the 67 TFLOP/s of fp32
outside the tensor cores.  A later PR feeds bf16 tiles through a TMA ring to
``wgmma`` (the tensor cores' only route to their full rate) and pipelines
the loads; see ROADMAP.

The plan's TPU tile ``(block_h, block_c)`` (``plan.tiles["conv2d"]``) is
accepted and ignored: the kernel takes its own block sizes until the tiling
pass gains a Hopper target (ROADMAP Queue 1, item 6).

On a CPU tensor the wrapper runs :func:`conv2d_fused_plain`; on a CUDA
tensor it launches the kernel or raises.  ``conv2d_fused.launches`` counts
the launches.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (low, high), the odd extra
    row or column on the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_geometry(H: int, W: int, kh: int, kw: int, stride: int,
                  padding: str) -> Tuple[Tuple[int, int], Tuple[int, int],
                                         int, int]:
    """((pad_top, pad_bottom), (pad_left, pad_right), Ho, Wo)."""
    if padding == "SAME":
        ph, pw = same_pads(H, kh, stride), same_pads(W, kw, stride)
        return ph, pw, -(-H // stride), -(-W // stride)
    if padding == "VALID":
        return (0, 0), (0, 0), (H - kh) // stride + 1, (W - kw) // stride + 1
    raise ValueError(f"unknown padding {padding!r}; expected SAME | VALID")


def conv2d_fused_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                       padding: str = "SAME",
                       bn: Optional[Sequence[torch.Tensor]] = None,
                       act: Optional[str] = None) -> torch.Tensor:
    """The same function in plain PyTorch, tap by tap as the Pallas body
    computes it: every (dh, dw) tap is a strided slice of the padded input
    times w[dh, dw], summed in fp32."""
    from repro_torch.core.ops_impl import _act
    N, H, W, CI = x.shape
    kh, kw, _, CO = w.shape
    (pt, pb), (pl, pr), ho, wo = conv_geometry(H, W, kh, kw, stride, padding)
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    wf = w.float()
    acc = torch.zeros((N, ho, wo, CO), dtype=torch.float32, device=x.device)
    for dh in range(kh):
        for dw in range(kw):
            xs = xp[:, dh:dh + (ho - 1) * stride + 1:stride,
                    dw:dw + (wo - 1) * stride + 1:stride, :]
            acc += xs @ wf[dh, dw]
    if bn is not None:
        scale, bias, mean, var = (t.float() for t in bn)
        acc = (acc - mean) * (torch.rsqrt(var + 1e-5) * scale) + bias
    if act:
        acc = _act(acc, act)
    return acc.to(x.dtype)


def conv2d_fused(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                 padding: str = "SAME",
                 bn: Optional[Sequence[torch.Tensor]] = None,
                 act: Optional[str] = None, tile=None) -> torch.Tensor:
    """x: (N, H, W, CI) NHWC; w: (kh, kw, CI, CO) HWIO; bn: optional
    (scale, bias, mean, var), each (CO,).  Returns (N, Ho, Wo, CO) in
    ``x.dtype``.  ``tile`` is the plan's TPU tile, ignored (see module
    docstring)."""
    if x.device.type == "cpu":
        return conv2d_fused_plain(x, w, stride=stride, padding=padding,
                                  bn=bn, act=act)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"conv2d_fused: x on {x.device}, w on {w.device}; "
                         "both must be on the same CUDA device")
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt not in _build.DTYPE_CODES:
        raise TypeError(f"conv2d_fused: unsupported dtype {dt}")
    if act not in _build.ACT_CODES:
        raise ValueError(f"conv2d_fused: unknown activation {act!r}")
    if x.ndim != 4 or w.ndim != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_fused: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not NHWC x HWIO with groups=1")
    N, H, W, CI = x.shape
    kh, kw, _, CO = w.shape
    (pt, _), (pl, _), ho, wo = conv_geometry(H, W, kh, kw, stride, padding)
    if min(N, ho, wo, CO) <= 0 or max(x.numel(), N * ho * wo * CO) >= 2 ** 31:
        raise ValueError(f"conv2d_fused: unsupported size x {tuple(x.shape)}"
                         f" w {tuple(w.shape)}")
    xc = x.to(dt).contiguous()
    wc = w.to(dt).contiguous()
    bnc = [None] * 4
    if bn is not None:
        bnc = [t.to(device=x.device, dtype=torch.float32).contiguous()
               for t in bn]
        if any(t.shape != (CO,) for t in bnc):
            raise ValueError("conv2d_fused: batch-norm vectors must be (CO,)")
    out = torch.empty((N, ho, wo, CO), dtype=dt, device=x.device)
    _build.call("conv2d_fused", _build.DTYPE_CODES[dt], _build.ptr(xc),
                _build.ptr(wc), *[_build.ptr(t) for t in bnc],
                _build.ptr(out), N, H, W, CI, CO, kh, kw, stride, pt, pl,
                ho, wo, _build.ACT_CODES[act], _build.stream())
    conv2d_fused.launches += 1
    return out if dt == x.dtype else out.to(x.dtype)


conv2d_fused.launches = 0
