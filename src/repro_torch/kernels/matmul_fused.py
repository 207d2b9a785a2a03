"""matmul_fused — the fused tiled matmul, as a hand-written CUDA kernel for
Hopper (``csrc/matmul_fused.cu``).

Replaces the Pallas kernel ``matmul_fused`` of
``src/repro/kernels/matmul_fused.py``: ``y = epilogue(x @ w [, x @ w2])``
over (M, K) x (K, N), the leading dims of x flattened into M and restored
on the way out; fp32 accumulation, a second accumulator when ``w2`` is given
(the GLU form the LM slice uses); the epilogue in the JAX kernel's order —
GLU ``act(x@w) * (x@w2)`` (silu by default), then bias, then act — and one
write in ``out_dtype``.  Registered for ``matmul`` and ``glu_matmul``.  The
Pallas kernel's ``vmem_accum=False`` base variant (reached only by the
paper-table benchmark) is not ported yet (ROADMAP Queue 2).

What bounds it on the H100: on the CNN path it is the FC head, (8, 512) x
(512, 1000) for ResNet-34 at batch 8 — 8 rows, so about 8 operations per
weight byte, far below the ridge: the weight bytes bound it (about 1 MB in
bf16, a fraction of a microsecond at 3.35 TB/s), and in practice the launch.

The simple design: the same SIMT GEMM core as conv2d — 64 x 64 output tiles
per 256-thread block, 16-deep K steps staged in shared memory as fp32, 4 x 4
register patches of fp32 FMAs — with no im2col gather.  At M = 8 most of each
tile's rows are empty, which costs nothing the weight read does not already
pay.  A later PR for the LM slice, where M is large, moves to bf16
``wgmma`` with TMA loads; at small M the fix is a split-K or GEMV schedule
that spreads the weight read over all 132 SMs.

On a CPU tensor the wrapper runs :func:`matmul_fused_plain`; on a CUDA
tensor it launches the kernel or raises.  ``matmul_fused.launches`` counts
the launches.  It uses no ``torch.matmul`` and no cuBLAS on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build


def matmul_fused_plain(x: torch.Tensor, w: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       w2: Optional[torch.Tensor] = None,
                       act: Optional[str] = None,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products of the operands,
    then the epilogue in the kernel's order."""
    from repro_torch.core.ops_impl import _act
    xf = x.float()
    y = xf @ w.float()
    if w2 is not None:                    # GLU pair: act(x@w) * (x@w2)
        y = _act(y, act or "silu") * (xf @ w2.float())
        act = None
    if bias is not None:
        y = y + bias.float()
    if act:
        y = _act(y, act)
    return y.to(out_dtype or x.dtype)


def matmul_fused(x: torch.Tensor, w: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 w2: Optional[torch.Tensor] = None,
                 act: Optional[str] = None, tile=None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y = epilogue(x @ w [, x @ w2]); x (..., K), w and w2 (K, N), bias
    (N,).  Returns (..., N) in ``out_dtype`` (default ``x.dtype``).
    ``tile`` is the plan's TPU tile, ignored: the kernel takes its own."""
    if x.device.type == "cpu":
        return matmul_fused_plain(x, w, bias=bias, w2=w2, act=act,
                                  out_dtype=out_dtype)
    ops = [t for t in (w, w2, bias) if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in ops):
        raise ValueError("matmul_fused: all operands must be on the same "
                         f"CUDA device (x on {x.device})")
    dt = x.dtype
    for t in (w, w2):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    odt = out_dtype or x.dtype
    if dt not in _build.DTYPE_CODES or odt not in _build.DTYPE_CODES:
        raise TypeError(f"matmul_fused: unsupported dtypes in {dt}, "
                        f"out {odt}")
    if act not in _build.ACT_CODES:
        raise ValueError(f"matmul_fused: unknown activation {act!r}")
    K = x.shape[-1]
    if w.ndim != 2 or w.shape[0] != K or (w2 is not None
                                          and w2.shape != w.shape):
        raise ValueError(f"matmul_fused: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not form (M,K)x(K,N)")
    N = w.shape[1]
    if bias is not None and bias.shape != (N,):
        raise ValueError(f"matmul_fused: bias {tuple(bias.shape)} != ({N},)")
    lead = x.shape[:-1]
    M = math.prod(lead)
    if min(M, K, N) <= 0 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"matmul_fused: unsupported size M={M} K={K} N={N}")
    xc = x.reshape(M, K).to(dt).contiguous()
    wc = w.to(dt).contiguous()
    w2c = w2.to(dt).contiguous() if w2 is not None else None
    bc = bias.to(torch.float32).contiguous() if bias is not None else None
    glu_act = _build.ACT_CODES[act or "silu"] if w2 is not None else 0
    post_act = 0 if w2 is not None else _build.ACT_CODES[act]
    out = torch.empty((M, N), dtype=odt, device=x.device)
    _build.call("matmul_fused", _build.DTYPE_CODES[dt],
                _build.DTYPE_CODES[odt], _build.ptr(xc), _build.ptr(wc),
                _build.ptr(w2c), _build.ptr(bc), _build.ptr(out), M, K, N,
                post_act, glu_act, _build.stream())
    matmul_fused.launches += 1
    return out.reshape(*lead, N)


matmul_fused.launches = 0
