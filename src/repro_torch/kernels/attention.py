"""flash_attention — causal, windowed and softcapped GQA attention as a
hand-written CUDA kernel for Hopper (``csrc/flash_attention.cu``).

Replaces the Pallas kernel ``flash_attention`` of
``src/repro/kernels/attention.py``: online softmax in fp32 over K/V tiles, so
the (Sq, Skv) score matrix never reaches device memory; head h reads KV head
h // G; masking is positional (key pos >= 0, key pos <= query pos under
``causal``, key pos > query pos - ``window``), the softcap applied before
the mask, and the sum divided by ``max(l, 1e-30)`` at the end.

What bounds it on the H100: at the LM prefill shape (B=8, S=512, H=32,
D=64, causal) the work is ~8.6 GFLOP against ~42 MB of q, k, v and output
in bf16, about 200 operations per byte: below the bf16 ridge (~295), so the
bytes bound it (~13 us).  This first kernel computes on the SIMT units in
fp32 (67 TFLOP/s at most, ~130 us for the same work), so that rate, not the
bound, sets its pace; ``wgmma`` on bf16 tiles is later work.

The design: one block of 256 threads per (64 query rows, head, batch row),
the Pallas grid's sequential K axis becoming a loop inside the block.  Each
K/V tile of 64 keys is staged in shared memory as fp32; the 64 x 64 score
tile is a 16 x 16 thread grid of 4 x 4 register patches (the GEMM core of
the other kernels), the row max and sum are reduced across the 16 threads
of a row with warp shuffles, P goes through shared memory into the P @ V
product, and m, l and the output rows stay in registers.  Tiles dead in
index space (above the causal diagonal, or wholly outside the window) are
skipped, as the Pallas kernel skips them, which is exact under its
positions contract (per-row shifted aranges).  The plan's TPU tile
(``plan.tiles["attention"]``) is ignored: the kernel takes its own.

On a CPU tensor the wrapper runs :func:`flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.  ``flash_attention.launches``
counts the launches.  It uses no ``scaled_dot_product_attention`` and no
``torch.matmul`` on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)      # the head widths the kernel is built for


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, positions: Optional[torch.Tensor] = None,
                          causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """The same function in plain PyTorch, fp32 throughout (the JAX
    package's ``kernels/ref.py`` ``flash_attention_ref``)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = (q.float() * D ** -0.5).reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    if positions is None:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        valid = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            valid = valid & (kpos <= qpos)
        if window:
            valid = valid & (kpos > qpos - window)
        mask = valid[None, None, None]
    else:
        # pad keys (< 0) are masked everywhere; pad query rows yield
        # garbage the caller discards
        pos = positions.to(torch.int32)
        qpos, kpos = pos[:, :, None], pos[:, None, :]
        valid = kpos >= 0
        if causal:
            valid = valid & (kpos <= qpos)
        if window:
            valid = valid & (kpos > qpos - window)
        mask = valid[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _check(q, k, v):
    B, Sq, H, D = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not form "
                         "(B,Sq,H,D) x (B,Skv,KV,D) with KV dividing H")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    tile=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D) with H = KV * G.  Returns
    (B, Sq, H, D) in q's dtype.  ``q_offset`` is the absolute position of
    q[0].  ``positions`` — optional (B, Sq) per-row absolute positions used
    for both queries and keys (needs Skv == Sq and q_offset == 0); entries
    < 0 mark padding, and valid entries of a row form a shifted arange.
    ``tile`` is the plan's TPU tile, ignored."""
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if positions is not None:
        if tuple(positions.shape) != (B, Sq):
            raise ValueError(f"positions must be (B, Sq)=({B}, {Sq}); "
                             f"got {tuple(positions.shape)}")
        if Skv != Sq:
            raise ValueError("per-row positions require self-attention "
                             f"shapes (Skv == Sq); got Sq={Sq}, Skv={Skv}")
        if q_offset:
            raise ValueError("positions and q_offset are mutually exclusive "
                             "(positions are absolute)")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, positions=positions,
                                     causal=causal, window=window,
                                     softcap=softcap, q_offset=q_offset)
    ops = [k, v] + ([positions] if positions is not None else [])
    if q.device.type != "cuda" or any(t.device != q.device for t in ops):
        raise ValueError("flash_attention: all operands must be on the same "
                         f"CUDA device (q on {q.device})")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: unsupported dtypes q {q.dtype}, "
                        f"k {k.dtype}, v {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in {HEAD_DIMS}")
    if max(q.numel(), k.numel()) >= 2 ** 31:
        raise ValueError("flash_attention: operands of 2**31 elements or more")
    if positions is None:
        qp = (torch.arange(Sq, dtype=torch.int32, device=q.device)
              + q_offset).expand(B, Sq).contiguous()
        kp = torch.arange(Skv, dtype=torch.int32,
                          device=q.device).expand(B, Skv).contiguous()
    else:
        qp = kp = positions.to(torch.int32).contiguous()
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    _build.call("flash_attention", _build.DTYPE_CODES[q.dtype],
                _build.ptr(qc), _build.ptr(kc), _build.ptr(vc),
                _build.ptr(qp), _build.ptr(kp), _build.ptr(out),
                B, Sq, Skv, H, KV, D, int(causal), int(window or 0),
                float(softcap or 0.0), int(q_offset), _build.stream())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
