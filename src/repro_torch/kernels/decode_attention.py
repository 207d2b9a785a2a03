"""decode_attention — one query token per row over the rolling KV cache, as
hand-written split-KV CUDA kernels for Hopper: three schedules of the same
function.

Replaces the Pallas kernel ``decode_attention`` of
``src/repro/kernels/decode_attention.py``: the G query heads of each KV head
score the cache, masked by position (slot pos >= 0 and pos <= the query's
position, and inside the window), softcapped before the mask, with an
online softmax in fp32 and the sum divided by ``max(l, 1e-30)``.

What bounds it on the H100: the cache read.  At the LM decode shape (B=8,
C=1024, KV=8, D=64) K and V are ~17 MB in bf16 against at most ~67 MFLOP
of work, four operations per byte: the bytes bound it (~5 us at
3.35 TB/s).  At such sizes a call is a few microseconds, so the grid's fill,
the loads in flight and the launches a call matter as much as the bytes.

The wrapper picks a schedule with :func:`_schedule`, a pure function of the
dtype and the head width (a dispatch between hand-written kernels, not a
fallback: a build or launch failure raises):

- ``mma`` (``csrc/decode_core.cuh`` in ``csrc/decode_attention.cu``): bf16
  at head widths 64, 128 and 256.  One block per (split, KV head x 16 query
  rows, batch row); its warps take the split's 16-slot tiles in turn, each
  streaming K and V in their own dtype through its own ring of three
  16-byte ``cp.async`` stages, and multiply Q·Kᵀ and P·V with ``mma.sync``
  m16n8k16 (fp32 sums; P as bf16 hi + lo, ~16 bits as the Pallas kernel's
  fp32 p); the scale multiplies the fp32 scores.  A tile none of whose
  slots is valid loads nothing.  The block merges its warps' online
  softmax states in warp order; the last block of a (row, KV head) to
  finish, by an atomic ticket, combines the splits in split order: one
  launch a call, bits that repeat.
- ``ffma`` (the same core): fp32 at head widths 64, 128 and 256, both
  products as full fp32 FMAs on the same ring (no TF32, so the fp32 parity
  of 1e-5 and the fp32 greedy tokens hold).
- ``simt`` (``csrc/decode_attention.cu``'s first kernels): fp32 and bf16 at
  head widths 16 and 32.  One block of 128 threads per (64-slot split
  tile, KV head, batch row), K/V staged in shared memory as fp32, scalar
  FMAs, and a second kernel that combines the splits.

The split (:func:`splits`) is the card's choice, made from the SM count
and the shapes: these kernels take no tile.  The plan's
``plan.tiles["decode_attention"]`` is the TPU table's entry (the tiling
pass's Hopper target leaves it so) and is ignored; the paged kernel's
KV block is the pool block, and ``copy_block`` copies whole blocks:
neither has a tile either.  One difference from the plain version: a row none of whose
slots is valid gets zeros from ``mma`` and ``ffma`` (its tiles are never
read), where the plain version and the Pallas kernel give the mean of V.
The main path never has such a row: the query's own slot is valid.

On a CPU tensor the wrapper runs :func:`decode_attention_plain`; on a CUDA
tensor it launches a kernel or raises.  ``decode_attention.launches``
counts the calls that launch a kernel and ``decode_attention.schedules``
splits them by schedule.  It uses no ``scaled_dot_product_attention`` and
no ``torch.matmul`` on the card.

The module also holds the serving engine's two kernels over the paged KV
pool, ``paged_decode_attention`` (``csrc/paged_decode_attention.cu``, the
same core) and ``copy_block`` (``csrc/copy_block.cu``); their notes are at
their wrappers below.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import _aligned

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernels are built for
TILED_HEAD_DIMS = (64, 128, 256)    # those of the mma and ffma schedules
SCHEDULES = ("mma", "ffma", "simt")
# the mma and ffma schedules (csrc/decode_core.cuh): query rows a block,
# the split granularity in slots, the most splits and slots a split
ROWS = 16
TILE = 16
MAX_SPLITS = 128
MAX_CHUNK = 2048
# their tiles (Cfg): (warps a block, slots a warp tile, ring stages) by
# dtype and head width
CORE_TILES = {(torch.bfloat16, 64): (4, 16, 3),
              (torch.bfloat16, 128): (4, 16, 3),
              (torch.bfloat16, 256): (4, 16, 3),
              (torch.float32, 64): (4, 16, 3),
              (torch.float32, 128): (2, 16, 3),
              (torch.float32, 256): (4, 8, 3)}
SM_SHARED = 233472     # shared bytes an H100 SM holds; 1024 more a block
TABLE_WHOLE = 1024     # a paged row's table of up to this many entries is
                       # loaded whole
BLOCKS_PER_SM = 4      # the simt kernels' aim
SLOTS = 64             # cache slots per tile in the simt kernels


def _schedule(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs a call: at the head widths of
    :data:`TILED_HEAD_DIMS` ``mma`` for bf16 and ``ffma`` for fp32, ``simt``
    for the rest."""
    if D not in TILED_HEAD_DIMS:
        return "simt"
    return "mma" if dtype == torch.bfloat16 else "ffma"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _core_smem(dtype: torch.dtype, D: int, extra: int) -> int:
    """Shared bytes of one block of the mma or ffma schedule with ``extra``
    ints of slot-map data (``Layout::bytes`` of ``csrc/decode_core.cuh``):
    the warps' rings of K and V tiles with rows padded by 16 bytes, the Q
    tile, the fp32 schedule's P scratch and the warps' load offsets."""
    W, NS, ST = CORE_TILES[(dtype, D)]
    elem = dtype.itemsize
    ld = D + 16 // elem
    ring = W * ST * 2 * NS * ld * elem
    pscr = W * ROWS * NS * 4 if dtype == torch.float32 else 0
    return ring + ROWS * ld * elem + pscr + W * NS * 4 + 4 * extra


def _fit(dtype: torch.dtype, D: int, extra: int) -> int:
    """Blocks of the mma or ffma schedule an SM holds at once: shared
    memory binds before registers and threads at every width."""
    W = CORE_TILES[(dtype, D)][0]
    return max(1, min(SM_SHARED // (_core_smem(dtype, D, extra) + 1024),
                      2048 // (32 * W)))


def min_chunk(rows: int, D: int, elem: int) -> int:
    """The fewest slots (a multiple of :data:`TILE`) a split of the mma and
    ffma schedules may hold: its fp32 partial, rows x (D + 2) x 4 bytes,
    stays within a quarter of the K and V bytes it reads (2 x D x ``elem``
    a slot)."""
    need = -(-8 * rows * (D + 2) // (D * elem))
    return _round_up(max(need, TILE), TILE)


def _cfac(rows: int, D: int, elem: int) -> float:
    """A split of n slots in all holds at least sqrt(n x this) of them:
    then the last block's combine, nsplit x rows x (D + 2) x 4 bytes, reads
    no more than one split's K and V."""
    return rows * (D + 2) * 2 / (D * elem)


def combine_chunk(n: int, rows: int, D: int, elem: int) -> int:
    """The fewest slots (a multiple of :data:`TILE`) a split of ``n`` slots
    may hold under :func:`_cfac`'s rule."""
    return _round_up(max(1, math.ceil(math.sqrt(n * _cfac(rows, D, elem)))),
                     TILE)


@functools.lru_cache(maxsize=256)
def splits(B: int, C: int, KV: int, G: int, D: int, dtype: torch.dtype,
           n_sm: int):
    """(number of splits, slots per split) of the rolling cache for the mma
    and ffma schedules, a pure function of the shapes (the host never reads
    the cache's positions).  The rules: a split is a whole number of
    16-slot tiles, at most :data:`MAX_CHUNK` slots, and there are at most
    :data:`MAX_SPLITS`; a split holds at least :func:`min_chunk` slots (the
    workspace stays under a quarter of the K/V bytes each block reads) and
    at least :func:`combine_chunk` (the last block's combine reads no more
    than a block's K and V); within those, as many splits as fill one wave
    of the card (:func:`_fit` blocks an SM), no more."""
    elem = dtype.itemsize
    n_rt, rows = -(-G // ROWS), min(G, ROWS)
    least = max(min_chunk(rows, D, elem), combine_chunk(C, rows, D, elem),
                _round_up(-(-C // MAX_SPLITS), TILE))
    if least > MAX_CHUNK:
        raise ValueError(f"decode_attention: a cache of {C} slots needs "
                         f"more than {MAX_SPLITS} splits of {MAX_CHUNK}")
    fit = _fit(dtype, D, 0)
    while True:
        want = max(1, fit * n_sm // (B * KV * n_rt))
        chunk = max(least, min(_round_up(-(-C // want), TILE), MAX_CHUNK))
        if fit == 1 or _fit(dtype, D, chunk) >= fit:
            return -(-C // chunk), chunk
        fit -= 1


def _simt_splits(B: int, C: int, KV: int, n_sm: int):
    """(number of splits, slots per split) of the simt kernels: enough
    splits that the blocks fill the card, each a whole number of 64-slot
    tiles."""
    tiles = -(-C // SLOTS)
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * KV)))
    per = -(-tiles // min(want, tiles))
    chunk = per * SLOTS
    return -(-C // chunk), chunk


# per device: the tickets of the one-launch combine (``_tickets``), and
# the smaller buffers they replaced
_TICKETS = {}
_RETIRED_TICKETS = []


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The per-device int32 tickets of the one-launch combine: zeros that
    each call leaves zero (the last block of a group resets its own), so
    one buffer serves every call on the device's stream and no memset
    launch is needed (calls on one stream run one after another; two
    streams must not run these kernels at once).  Grown to at least ``n``,
    never during a CUDA-graph capture, whose warm-up call allocates it.  A
    buffer that is outgrown stays alive: a graph captured before the
    growth replays against it."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _workspace(device: torch.device, groups: int, nsplit: int, rows: int,
               D: int):
    """(workspace, tickets) of one call of the mma or ffma schedule: per
    (group, split) the acc rows (rows x D fp32), then its (m, l) pairs for
    an even number of rows; none with one split."""
    if nsplit == 1:
        return None, None
    ws = torch.empty(groups * nsplit * (rows * D + 2 * (rows + rows % 2)),
                     dtype=torch.float32, device=device)
    return ws, _tickets(device, groups)


@functools.lru_cache(maxsize=16)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    G = H // KV
    sched = _schedule(q.dtype, D)
    pp = pos.to(torch.int32).contiguous()
    qp = qpos.to(torch.int32).contiguous()
    if sched == "simt":
        nsplit, chunk = _simt_splits(B, C, KV, _n_sm(q.device))
        ws = torch.empty(B * KV * nsplit * G * (D + 2), dtype=torch.float32,
                         device=q.device)
        qq, kk, vv = q.contiguous(), kc.contiguous(), vc.contiguous()
        out = torch.empty_like(qq)
        _build.call("decode_attention", _build.DTYPE_CODES[q.dtype],
                    _build.ptr(qq), _build.ptr(kk), _build.ptr(vv),
                    _build.ptr(pp), _build.ptr(qp), _build.ptr(out),
                    _build.ptr(ws), B, C, H, KV, D, int(window or 0),
                    float(softcap or 0.0), nsplit, chunk, _build.stream())
    else:
        nsplit, chunk = splits(B, C, KV, G, D, q.dtype, _n_sm(q.device))
        ws, tk = _workspace(q.device, B * KV * -(-G // ROWS), nsplit,
                            min(G, ROWS), D)
        qq, kk, vv = (_aligned(t) for t in (q, kc, vc))
        out = torch.empty_like(qq)
        _build.call(f"decode_attention_{sched}", _build.ptr(qq),
                    _build.ptr(kk), _build.ptr(vv), _build.ptr(pp),
                    _build.ptr(qp), _build.ptr(out), _build.ptr(ws),
                    _build.ptr(tk), B, C, H, KV, D, int(window or 0),
                    float(softcap or 0.0), nsplit, chunk, _build.stream())
    decode_attention.launches += 1
    decode_attention.schedules[sched] += 1
    return out


decode_attention.launches = 0
decode_attention.schedules = dict.fromkeys(SCHEDULES, 0)


def decode_attention_fake(q: torch.Tensor, kc: torch.Tensor,
                          vc: torch.Tensor, pos: torch.Tensor,
                          qpos: torch.Tensor, *,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          tile=None) -> torch.Tensor:
    """:func:`decode_attention`'s shape-only stand-in (the dry-run): the
    output, unfilled, and 4 D operations a query head and cache slot (the
    slots' positions are not known, so every slot counts)."""
    from repro_torch.kernels import _fake
    B, _, H, D = q.shape
    out = torch.empty_like(q)
    _fake.count("decode_attention", 4 * B * H * D * kc.shape[1],
                _fake.nbytes(q, kc, vc, pos, qpos, out))
    return out


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
# The schedules are decode_attention's (``_schedule``): ``mma`` (bf16) and
# ``ffma`` (fp32) at head widths 64, 128 and 256 run the split-KV core of
# ``csrc/decode_core.cuh`` with the pool's slot map: one block per (split,
# KV head x 16 of the R = Sq * G query rows, batch row) over its share of
# the row's live tokens, tokens lo .. max(qpos[b]) (with a window, none
# older than the youngest row's window), cut inside the kernel, so the host
# never reads ``lens``; the block loads the table entries that cover its
# split into shared memory once, so each tile's pool offsets are known
# before its loads go out; one launch a call.  ``simt``
# (``csrc/paged_decode_attention.cu``'s first kernels) keeps head widths 16
# and 32: 128 threads per (split, row tile of 64 rows (32 at D 256), batch
# row), K/V staged as fp32, a second kernel combining the splits.  The
# Pallas kernel visits every table entry and never reads ``lens``; only
# fully masked rows (padding, qpos < 0), whose output the engine discards,
# can differ: the Pallas kernel and the plain version give them the mean of
# V, ``mma`` and ``ffma`` zeros, ``simt`` the mean of the tokens it read.

def paged_rows(D: int) -> int:
    """Query rows per block in the simt kernel (``rows_per_block`` of
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


def _table_entries(nblk: int, bs: int) -> int:
    """Table entries a block of the mma or ffma schedule loads: the whole
    row up to :data:`TABLE_WHOLE` entries (at once with the query
    positions), else the slice that covers one split."""
    return nblk if nblk <= TABLE_WHOLE else min(nblk, MAX_CHUNK // bs + 2)


def _paged_tmax(nblk: int, bs: int, Sq: int) -> int:
    """The ``tmax`` argument of the mma and ffma schedules: the table
    entries a block loads and the row's Sq query positions."""
    return _table_entries(nblk, bs) + Sq


@functools.lru_cache(maxsize=256)
def paged_splits(B: int, KV: int, R: int, nblk: int, bs: int, D: int,
                 dtype: torch.dtype, n_sm: int) -> int:
    """The most splits of a row's live tokens for the mma and ffma
    schedules, a pure function of the shapes: the kernel cuts the live
    range it finds into at most this many splits, each at least
    :func:`min_chunk` tokens and at least sqrt(live x :func:`_cfac`).  The
    rules are :func:`splits`', with the capacity nblk x bs in place of the
    cache: at most :data:`MAX_SPLITS`, none over :data:`MAX_CHUNK` tokens
    even when every token is live, and as many as fill one wave of the
    card, no more."""
    elem = dtype.itemsize
    n_rt, rows, cap = -(-R // ROWS), min(R, ROWS), nblk * bs
    least = max(min_chunk(rows, D, elem), combine_chunk(cap, rows, D, elem))
    fit = _fit(dtype, D, _table_entries(nblk, bs) + R)   # Sq <= R
    want = max(1, fit * n_sm // (B * KV * n_rt))
    n = max(1, min(want, -(-cap // least), MAX_SPLITS))
    n = max(n, -(-cap // MAX_CHUNK))
    if n > MAX_SPLITS:
        raise ValueError(f"paged_decode_attention: a capacity of {cap} "
                         f"tokens needs more than {MAX_SPLITS} splits")
    return n


def _simt_paged_splits(B: int, KV: int, n_row_tiles: int, capacity: int,
                       n_sm: int) -> int:
    """Splits of a row's live tokens in the simt kernels: enough that the
    blocks fill the card (about four per SM), at most one per 64-token tile
    of the capacity."""
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
    sched = _schedule(q.dtype, D)
    bb = bt.to(torch.int32).contiguous()
    pp = qp.to(torch.int32).contiguous()
    window, softcap = int(window or 0), float(softcap or 0.0)
    if sched == "simt":
        n_rt = -(-R // paged_rows(D))
        nsplit = _simt_paged_splits(B, KV, n_rt, nblk * bs, _n_sm(q.device))
        ws = torch.empty(B * KV * nsplit * R * (D + 2), dtype=torch.float32,
                         device=q.device)
        qq = q.contiguous()
        out = torch.empty_like(qq)
        _build.call("paged_decode_attention", _build.DTYPE_CODES[q.dtype],
                    _build.ptr(qq), _build.ptr(kp), _build.ptr(vp),
                    _build.ptr(bb), _build.ptr(pp), _build.ptr(out),
                    _build.ptr(ws), B, Sq, H, KV, D, NB, bs, nblk, window,
                    softcap, nsplit, _build.stream())
    else:
        if kp.data_ptr() % 16 or vp.data_ptr() % 16:
            raise ValueError("paged_decode_attention: the pools must start "
                             "at 16-byte aligned addresses")
        elem, rows = q.element_size(), min(R, ROWS)
        nsplit = paged_splits(B, KV, R, nblk, bs, D, q.dtype,
                              _n_sm(q.device))
        ws, tk = _workspace(q.device, B * KV * -(-R // ROWS), nsplit, rows,
                            D)
        qq = _aligned(q)
        out = torch.empty_like(qq)
        _build.call(f"paged_decode_attention_{sched}", _build.ptr(qq),
                    _build.ptr(kp), _build.ptr(vp), _build.ptr(bb),
                    _build.ptr(pp), _build.ptr(out), _build.ptr(ws),
                    _build.ptr(tk), B, Sq, H, KV, D, NB, bs, nblk, window,
                    softcap, nsplit, min_chunk(rows, D, elem),
                    _cfac(rows, D, elem), _paged_tmax(nblk, bs, Sq),
                    _build.stream())
    paged_decode_attention.launches += 1
    paged_decode_attention.schedules[sched] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.schedules = dict.fromkeys(SCHEDULES, 0)


def paged_decode_attention_fake(q: torch.Tensor, kp: torch.Tensor,
                                vp: torch.Tensor, bt: torch.Tensor,
                                lens: torch.Tensor, *,
                                qpos: Optional[torch.Tensor] = None,
                                window: Optional[int] = None,
                                softcap: Optional[float] = None
                                ) -> torch.Tensor:
    """:func:`paged_decode_attention`'s shape-only stand-in (the dry-run):
    the output, unfilled; every slot of a row's table counts (4 D
    operations a query head and slot), the K/V of those slots read."""
    from repro_torch.kernels import _fake
    B, Sq, H, D = q.shape
    slots = bt.shape[1] * kp.shape[1]
    KV = kp.shape[2]
    out = torch.empty_like(q)
    _fake.count("paged_decode_attention", 4 * B * Sq * H * D * slots,
                _fake.nbytes(q, bt, lens, qpos, out)
                + 2 * B * slots * KV * D * kp.element_size())
    return out


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


def copy_block_fake(pool, src: int, dst: int):
    """:func:`copy_block`'s stand-in (the dry-run): nothing is copied; one
    block of each pool read and written is counted."""
    from repro_torch.kernels import _fake
    pools = pool if isinstance(pool, tuple) else (pool,)
    p0 = pools[0]
    reps = p0.shape[0] if p0.ndim == 5 else 1
    block = p0[0, 0] if p0.ndim == 5 else p0[0]
    _fake.count("copy_block", 0,
                2 * len(pools) * reps * _fake.nbytes(block))
    return pool
