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

The module also holds the serving engine's two kernels over the paged KV
pool, ``paged_decode_attention`` (``csrc/paged_decode_attention.cu``) and
``copy_block`` (``csrc/copy_block.cu``); their notes are at their wrappers
below.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernels are built for
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


# ---------------------------------------------------------------------------
# Paged decode attention: the serving engine's lookup over the block pool
# ---------------------------------------------------------------------------
#
# Replaces the Pallas kernel ``paged_decode_attention`` of
# ``src/repro/kernels/decode_attention.py``: q (B, Sq, H, D) scores row b's
# logical tokens, token j*bs + i living in pool block bt[b, j] at offset i;
# the mask is purely positional (kpos <= qpos, qpos >= 0, inside the
# window), softcap before the mask, an fp32 online softmax, and the sum
# divided by max(l, 1e-30).  It serves the decode tick (Sq = 1, qpos =
# lens), the chunked catch-up cell (Sq = k) and the speculative verify cell
# (Sq = j + 1).
#
# What bounds it on the H100: the live K/V read.  At the serving shape
# (B = 8, ~520 live tokens a row, KV = 8, D = 64, bf16) that is ~17 MB
# against ~4 operations per byte: the bytes bound it (~5 us at 3.35 TB/s).
#
# The design: the Pallas grid walks all nblk table entries of a row in
# order into one VMEM accumulator per (row, KV head).  Here one block of
# 128 threads serves the R = Sq * G query rows of one (row, KV head) over
# one split of the row's live tokens, so that (splits x B x KV) blocks fill
# the card; query rows beyond 64 (32 at head_dim 256) go to further blocks.  The walk stops at
# the token max(qpos[b]) (the Pallas kernel visits every table entry and
# never reads ``lens``; only fully masked rows, whose output the engine
# discards, can differ).  Each block resolves its tile's 64 tokens through
# the block table into pool offsets, stages K and V in shared memory as
# fp32, and writes partial (m, l, acc) to an fp32 workspace; the combine
# kernel of ``decode_attention`` merges the splits.

def paged_rows(D: int) -> int:
    """Query rows per block in the paged kernel (``rows_per_block`` of
    ``csrc/paged_decode_attention.cu``): 64, or 32 at head_dim 256, where
    64 rows of q and acc would not fit in shared memory beside the tile."""
    return 32 if D > 128 else 64


def paged_decode_attention_plain(q: torch.Tensor, kp: torch.Tensor,
                                 vp: torch.Tensor, bt: torch.Tensor,
                                 lens: torch.Tensor, *,
                                 qpos: Optional[torch.Tensor] = None,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None
                                 ) -> torch.Tensor:
    """The same function in plain PyTorch, fp32 throughout as the Pallas
    kernel computes it: gather ``kp[bt]`` into a contiguous cache, score
    every table entry, mask by position."""
    B, Sq, H, D = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    nblk = bt.shape[1]
    G = H // KV
    C = nblk * bs
    if qpos is None:
        qpos = lens.reshape(B, 1)
    qpos = qpos.to(torch.int32)
    idx = bt.long()
    kc = kp[idx].reshape(B, C, KV, D).float()
    vc = vp[idx].reshape(B, C, KV, D).float()
    qg = q.float().reshape(B, Sq, KV, G, D) * D ** -0.5
    s = torch.einsum("bckgd,bskd->bkgcs", qg, kc)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(C, dtype=torch.int32, device=q.device)
    qp = qpos[:, None, None, :, None]
    valid = (qp >= 0) & (kpos <= qp)
    if window:
        valid = valid & (kpos > qp - window)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgcs,bskd->bckgd", p, vc)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def paged_splits(B: int, KV: int, n_row_tiles: int, capacity: int,
                 n_sm: int) -> int:
    """Splits of a row's live tokens: enough that the blocks fill the card
    (about four per SM), at most one per 64-token tile of the capacity."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * KV * n_row_tiles)))
    return max(1, min(want, -(-capacity // SLOTS)))


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, bt: torch.Tensor,
                           lens: torch.Tensor, *,
                           qpos: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); kp, vp: (NB, bs, KV, D) pools; bt: (B, nblk) int
    block table; lens: (B,) int decode positions; qpos: optional (B, Sq)
    absolute query positions (default ``lens[:, None]``; entries < 0 are
    padding rows).  Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    if kp.ndim != 4 or kp.shape != vp.shape or kp.shape[3] != D \
            or H % kp.shape[2] or bt.ndim != 2 or bt.shape[0] != B \
            or tuple(lens.shape) != (B,):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pools "
            f"{tuple(kp.shape)} / {tuple(vp.shape)}, bt {tuple(bt.shape)}, "
            f"lens {tuple(lens.shape)} do not form (B,Sq,H,D) over "
            "(NB,bs,KV,D) with a (B,nblk) table and (B,) lengths")
    if qpos is not None and tuple(qpos.shape) != (B, Sq):
        raise ValueError(f"paged_decode_attention: qpos {tuple(qpos.shape)}"
                         f" != ({B}, {Sq})")
    if qpos is None and Sq != 1:
        raise ValueError("paged_decode_attention: Sq > 1 needs qpos")
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, kp, vp, bt, lens, qpos=qpos,
                                            window=window, softcap=softcap)
    qp = lens.reshape(B, 1) if qpos is None else qpos
    ops = [kp, vp, bt, qp]
    if q.device.type != "cuda" or any(t.device != q.device for t in ops):
        raise ValueError("paged_decode_attention: all operands must be on "
                         f"the same CUDA device (q on {q.device})")
    if q.dtype not in _build.DTYPE_CODES or kp.dtype != q.dtype \
            or vp.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention: unsupported dtypes q "
                        f"{q.dtype}, pools {kp.dtype}/{vp.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if not (kp.is_contiguous() and vp.is_contiguous()):
        raise ValueError("paged_decode_attention: the pools must be "
                         "contiguous (they are written in place)")
    if kp.numel() >= 2 ** 31:
        raise ValueError("paged_decode_attention: a pool of 2**31 elements "
                         "or more")
    NB, bs, KV = kp.shape[0], kp.shape[1], kp.shape[2]
    nblk = bt.shape[1]
    G = H // KV
    R = Sq * G
    n_rt = -(-R // paged_rows(D))
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = paged_splits(B, KV, n_rt, nblk * bs, n_sm)
    ws = torch.empty(B * KV * nsplit * R * (D + 2), dtype=torch.float32,
                     device=q.device)
    qq = q.contiguous()
    bb = bt.to(torch.int32).contiguous()
    pp = qp.to(torch.int32).contiguous()
    out = torch.empty_like(qq)
    _build.call("paged_decode_attention", _build.DTYPE_CODES[q.dtype],
                _build.ptr(qq), _build.ptr(kp), _build.ptr(vp), _build.ptr(bb),
                _build.ptr(pp), _build.ptr(out), _build.ptr(ws), B, Sq, H, KV,
                D, NB, bs, nblk, int(window or 0), float(softcap or 0.0),
                nsplit, _build.stream())
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# copy_block: the copy-on-write fork of one pool block
# ---------------------------------------------------------------------------
#
# Replaces the Pallas kernel ``copy_block`` of
# ``src/repro/kernels/decode_attention.py`` (a scalar-prefetched block copy
# with the pool aliased to the output): pool block ``dst`` := block
# ``src``, in place, for every rep of a folded (R, NB, bs, KV, D) pool, and
# for a paged entry's K and V pools together, in one launch.  A llama3.2-1b
# fork moves 2 x 2 x 16 x 16 x 8 x 64 bf16 elements (1 MB read and written),
# ~0.3 us at 3.35 TB/s, so the launch and the host's path to it are what a
# fork costs: one launch a pair, 16 bytes a thread over a (chunk, rep,
# pool) grid of at least one block an SM.


def copy_block_plain(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """The same function in plain PyTorch (the JAX package's
    ``copy_block_ref``): block ``dst`` of the block axis (-4) := block
    ``src``, in place; returns the pool."""
    pool[..., dst, :, :, :] = pool[..., src, :, :, :]
    return pool


def copy_block(pool, src: int, dst: int):
    """pool: (NB, bs, KV, D) or folded (R, NB, bs, KV, D), or a tuple of one
    or two such pools of one shape, dtype and device (a paged entry's K and
    V pools); src, dst: block ids (host ints).  Copies block ``src`` over
    block ``dst`` in place in each pool, one launch for all of them, and
    returns ``pool``."""
    pools = pool if isinstance(pool, tuple) else (pool,)
    if not 1 <= len(pools) <= 2 or any(
            p.shape != pools[0].shape or p.dtype != pools[0].dtype
            or p.device != pools[0].device for p in pools):
        raise ValueError("copy_block: one pool or a pair of one shape, "
                         "dtype and device")
    p0 = pools[0]
    if p0.ndim not in (4, 5):
        raise ValueError(f"copy_block: pool {tuple(p0.shape)} is not "
                         "(NB,bs,KV,D) or (R,NB,bs,KV,D)")
    NB = p0.shape[-4]
    src, dst = int(src), int(dst)
    if not (0 <= src < NB and 0 <= dst < NB):
        raise ValueError(f"copy_block: blocks {src} -> {dst} outside "
                         f"[0, {NB})")
    if p0.device.type == "cpu":
        for p in pools:
            copy_block_plain(p, src, dst)
        return pool
    if p0.device.type != "cuda":
        raise ValueError(f"copy_block: pool on {p0.device}")
    if not all(p.is_contiguous() for p in pools):
        raise ValueError("copy_block: the pool must be contiguous")
    R = p0.shape[0] if p0.ndim == 5 else 1
    _, bs, KV, D = p0.shape[-4:]
    _build.call("copy_block", p0.data_ptr(),
                pools[1].data_ptr() if len(pools) == 2 else None, R, NB,
                bs * KV * D * p0.element_size(), src, dst, _build.stream())
    copy_block.launches += 1
    return pool


copy_block.launches = 0
