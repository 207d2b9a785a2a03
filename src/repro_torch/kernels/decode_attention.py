"""decode_attention — one query token per row over the rolling KV cache, as a
hand-written split-KV CUDA kernel for Hopper (``csrc/decode_attention.cu``).

Replaces the Pallas kernel ``decode_attention`` of
``src/repro/kernels/decode_attention.py``: the G query heads of each KV head
score the cache, masked by position (slot pos >= 0 and pos <= the query's
position, and inside the window), softcapped before the mask, with an
online softmax in fp32 and the sum divided by ``max(l, 1e-30)``.

What bounds it on the H100: the cache read.  At the LM decode shape (B=8,
C=1024, KV=8, D=64) K and V are ~17 MB in bf16 against at most ~67 MFLOP
of work, four operations per byte: the bytes bound it (~5 us at
3.35 TB/s).

The design (flash-decoding): the Pallas kernel walks the cache in order
with one VMEM accumulator per (b, kv head); with C = 1024 that is one
sequential pass per pair, 64 pairs, and 64 blocks would leave most of the
132 SMs idle.  Here the cache is cut into splits, so that (splits x B x KV)
blocks fill the card (about four per SM).  Each block of 128 threads serves
the G query heads of its KV head together over its split, 64 cache slots at
a time staged in shared memory as fp32, and writes its partial (m, l, acc)
to an fp32 workspace; a second kernel combines the splits of each head.
The split is the card's choice, made here from the SM count; the plan's
TPU tile (``plan.tiles["decode_attention"]``) is ignored.

On a CPU tensor the wrapper runs :func:`decode_attention_plain`; on a CUDA
tensor it launches the kernels or raises.  ``decode_attention.launches``
counts the calls that launch them.  It uses no
``scaled_dot_product_attention`` and no ``torch.matmul`` on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)      # the head widths the kernel is built for
SLOTS = 64                         # cache slots per tile in the kernel
BLOCKS_PER_SM = 4


def decode_attention_plain(q: torch.Tensor, kc: torch.Tensor,
                           vc: torch.Tensor, pos: torch.Tensor,
                           qpos: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """The same function in plain PyTorch, fp32 throughout (the JAX
    package's ``kernels/ref.py`` ``decode_attention_ref``)."""
    B, _, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    qg = q.float().reshape(B, KV, G, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (pos >= 0) & (pos <= qpos)
    if window:
        valid = valid & (pos > qpos - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, vc.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def splits(B: int, C: int, KV: int, n_sm: int):
    """(number of splits, slots per split) for a cache of C slots: enough
    splits that the blocks fill the card, each a whole number of tiles."""
    tiles = -(-C // SLOTS)
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * KV)))
    per = -(-tiles // min(want, tiles))
    chunk = per * SLOTS
    return -(-C // chunk), chunk


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     pos: torch.Tensor, qpos: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     tile=None) -> torch.Tensor:
    """q: (B, 1, H, D); kc, vc: (B, C, KV, D); pos: (B, C) absolute positions
    (-1 empty); qpos: (B, 1).  Returns (B, 1, H, D) in q's dtype.  ``tile``
    is the plan's TPU tile, ignored."""
    B, one, H, D = q.shape
    if one != 1 or kc.ndim != 4 or kc.shape != vc.shape \
            or kc.shape[0] != B or kc.shape[3] != D or H % kc.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, kc "
                         f"{tuple(kc.shape)}, vc {tuple(vc.shape)} do not "
                         "form (B,1,H,D) x (B,C,KV,D) with KV dividing H")
    C, KV = kc.shape[1], kc.shape[2]
    if tuple(pos.shape) != (B, C) or tuple(qpos.shape) != (B, 1):
        raise ValueError(f"decode_attention: pos {tuple(pos.shape)} / qpos "
                         f"{tuple(qpos.shape)} != ({B}, {C}) / ({B}, 1)")
    if q.device.type == "cpu":
        return decode_attention_plain(q, kc, vc, pos, qpos, window=window,
                                      softcap=softcap)
    ops = [kc, vc, pos, qpos]
    if q.device.type != "cuda" or any(t.device != q.device for t in ops):
        raise ValueError("decode_attention: all operands must be on the "
                         f"same CUDA device (q on {q.device})")
    if q.dtype not in _build.DTYPE_CODES or kc.dtype != q.dtype \
            or vc.dtype != q.dtype:
        raise TypeError(f"decode_attention: unsupported dtypes q {q.dtype}, "
                        f"cache {kc.dtype}/{vc.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D} not in {HEAD_DIMS}")
    if kc.numel() >= 2 ** 31:
        raise ValueError("decode_attention: a cache of 2**31 elements or more")
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit, chunk = splits(B, C, KV, n_sm)
    G = H // KV
    ws = torch.empty(B * KV * nsplit * G * (D + 2), dtype=torch.float32,
                     device=q.device)
    qq, kk, vv = q.contiguous(), kc.contiguous(), vc.contiguous()
    pp = pos.to(torch.int32).contiguous()
    qp = qpos.to(torch.int32).contiguous()
    out = torch.empty_like(qq)
    _build.call("decode_attention", _build.DTYPE_CODES[q.dtype],
                _build.ptr(qq), _build.ptr(kk), _build.ptr(vv), _build.ptr(pp),
                _build.ptr(qp), _build.ptr(out), _build.ptr(ws), B, C, H, KV,
                D, int(window or 0), float(softcap or 0.0), nsplit, chunk,
                _build.stream())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
