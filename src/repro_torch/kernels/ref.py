"""Plain-PyTorch oracles for every hand kernel: the JAX package's
``kernels/ref.py`` names and signatures.

Most are the wrappers' plain versions (what a wrapper runs on a CPU
tensor).  Two follow the JAX oracle where it differs from the kernel:
:func:`paged_decode_attention_ref` rounds q·scale, K, V and the
probabilities to ``compute_dtype`` as the JAX reference does (the kernels
and their plain versions stay in fp32), and :func:`copy_block_ref` returns
a new pool (the JAX oracle is functional; the wrapper writes in place).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import flash_attention_plain
from repro_torch.kernels.conv2d import conv2d_fused_plain
from repro_torch.kernels.decode_attention import (NEG, copy_block_plain,
                                                  decode_attention_plain)
from repro_torch.kernels.matmul_fused import matmul_fused_plain


def matmul_fused_ref(x, w, *, bias=None, w2=None, act=None, out_dtype=None):
    return matmul_fused_plain(x, w, bias=bias, w2=w2, act=act,
                              out_dtype=out_dtype)


def flash_attention_ref(q, k, v, *, positions=None, causal=True, window=None,
                        softcap=None, q_offset=0):
    return flash_attention_plain(q, k, v, positions=positions, causal=causal,
                                 window=window, softcap=softcap,
                                 q_offset=q_offset)


def decode_attention_ref(q, kc, vc, pos, qpos, *, window=None, softcap=None):
    return decode_attention_plain(q, kc, vc, pos, qpos, window=window,
                                  softcap=softcap)


def paged_decode_attention_ref(q, kp, vp, bt, lens, *, qpos=None,
                               window=None, softcap=None,
                               compute_dtype: Optional[torch.dtype] = None):
    """Paged decode attention as the JAX reference computes it: each row's
    blocks gathered through its table into a contiguous cache, q·scale,
    K and V rounded to ``compute_dtype`` (q's dtype by default), fp32
    scores, the positional mask (``qpos`` (B, Sq), default ``lens``; a row
    with qpos < 0 is padding, masked everywhere), the probabilities
    rounded to ``compute_dtype``, an fp32 product, the output in
    ``compute_dtype``."""
    B, Sq, H, D = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nblk = bt.shape[1]
    G = H // KV
    dt = compute_dtype if compute_dtype is not None else q.dtype
    C = nblk * bs
    idx = bt.long()
    kc = kp[idx].reshape(B, C, KV, D)
    vc = vp[idx].reshape(B, C, KV, D)
    kpos = torch.arange(C, dtype=torch.int32, device=q.device).expand(B, C)
    qp = (lens.reshape(B, 1) if qpos is None else qpos).to(torch.int32)
    qf = (q * D ** -0.5).to(dt)
    qg = qf.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bckgd,bskd->bkgcs", qg, kc.to(dt).float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kk, qq = kpos[:, None, None, None, :], qp[:, None, None, :, None]
    valid = (kk >= 0) & (qq >= 0) & (kk <= qq)
    if window:
        valid = valid & (kk > qq - window)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    pr = torch.softmax(s, dim=-1).to(dt).float()
    o = torch.einsum("bkgcs,bskd->bckgd", pr, vc.to(dt).float())
    return o.reshape(B, Sq, H, D).to(dt)


def copy_block_ref(pool, src, dst):
    """A new pool whose block ``dst`` (block axis -4) is block ``src``."""
    return copy_block_plain(pool.clone(), int(src), int(dst))


def conv2d_fused_ref(x, w, *, stride=1, padding="SAME", bn=None, act=None):
    return conv2d_fused_plain(x, w, stride=stride, padding=padding, bn=bn,
                              act=act)
