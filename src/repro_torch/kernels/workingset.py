"""Shared bytes of one block of each hand kernel, by schedule.

The static verifier's K202 check holds a kernel's working set against the
shared memory a block of the H100 may opt in to (:data:`BLOCK_SHARED`,
232,448 bytes) or the flow's ``vmem_budget_bytes`` if that is smaller.  On
the TPU the working set was a tile's VMEM; here it is the shared memory the
schedule that ``_schedule`` picks at a call's shapes asks for: its dynamic
bytes (``cudaFuncAttributeMaxDynamicSharedMemorySize``) or, for the
``simt`` kernels of matmul and conv, their static ``__shared__`` arrays.

The verifier runs with no card, so each function mirrors its source's
``smem_bytes`` in Python and reuses the wrappers' own arithmetic where it
exists (``attention._ffma_smem_bytes``, ``decode_attention._core_smem``
and ``splits``, ``lru_scan.scan_geometry``).  Given ``lib``, the loaded
kernel library (``_build.LIBRARY.get()``, on the card), the same function
reads the bytes from the library instead: each source exports one
``*_smem`` query built on the expression its launch uses, so
``chip_smoke.py`` holds the mirror to the bytes the real launches ask for
at every card plan's calls.  Every function returns ``(schedule, bytes)``.
The functions of the four kernels that take a Hopper tile (matmul, conv2d,
flash_attention, decode_attention) count their bytes at ``tile`` (the
plan's; None: the kernel's default), as the launch would run it; a tile
no kernel takes raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

BLOCK_SHARED = 232448      # shared bytes a block of an H100 may opt in to
H100_SMS = 132             # the SMs of an H100 SXM: the decode split rule's

# csrc/common.cuh: the simt kernels' 64 x 64 tiles, 16-deep K steps
_SIMT_BM, _SIMT_BN, _SIMT_BK = 64, 64, 16

# the C interface's dtype codes (csrc/common.cuh rt::DType)
_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pick(schedule: str, mirror: int, lib: Any, query: str,
          *args: int) -> Tuple[str, int]:
    """``(schedule, mirror)``, or with ``lib`` the library's ``query`` at
    ``args`` in place of the mirror; a query the kernel refuses raises."""
    if lib is None:
        return schedule, mirror
    nb = getattr(lib, query)(*args)
    if nb < 0:
        raise ValueError(f"{query}{args}: the kernel takes no such shape")
    return schedule, int(nb)


def _simt_tile(nacc: int) -> int:
    """Static shared bytes of the simt matmul / conv kernels:
    ``float As[BK][BM + 4]`` and ``float Bs[NACC][BK][BN]``."""
    return 4 * (_SIMT_BK * (_SIMT_BM + 4) + nacc * _SIMT_BK * _SIMT_BN)


def _ffma_tile(bn: int, nacc: int) -> int:
    """``fp32tile::Tile<BN, NACC>::SMEM_BYTES`` (``csrc/ffma_tile.cuh``):
    4 stages of a 128 x 16 A tile (rows padded by 4) and NACC 16 x BN
    weight tiles."""
    return 4 * (128 * (16 + 4) + nacc * 16 * bn) * 4


def matmul(M: int, K: int, N: int, dtype: torch.dtype, glu: bool,
           aligned: bool = True, lib: Any = None,
           tile=None) -> Tuple[str, int]:
    """matmul_fused's schedule and shared bytes for an (M, K) x (K, N)
    product (``glu``: the w / w2 pair) at the Hopper ``tile``."""
    from repro_torch.kernels.matmul_fused import _schedule, block_of
    s = _schedule(M, K, N, dtype, glu, aligned)
    nw = 2 if glu else 1
    block = block_of(s, glu, tile)
    if s == "wgmma":
        # csrc/matmul_wgmma.cu smem_bytes<BN, NACC, STAGES>: 3 stages of a
        # 128 x 64 A box and NACC * BN / 64 64 x 64 w boxes (BN the
        # block's, 64 for the pair), 1024 of alignment, two mbarriers a
        # stage
        bn = block[2]
        return _pick(s, 3 * (128 * 64 * 2 + nw * (bn // 64) * 64 * 64 * 2)
                     + 1024 + 2 * 3 * 8, lib, "matmul_wgmma_smem", nw - 1,
                     bn)
    if s == "small_m":
        # csrc/matmul_small_m.cu partial_smem<MT, NW>: MT = ceil(M / 16)
        mt = (M + 15) // 16
        return _pick(s, 4 * (nw * 32 * (128 + 8) + 16 * mt * (32 + 8)) * 2,
                     lib, "matmul_small_m_smem", M, nw - 1)
    if s == "ffma":
        return _pick(s, _ffma_tile(block[2], nw), lib, "matmul_ffma_smem",
                     nw - 1, block[2])
    if s == "ffma_small_m":
        # csrc/matmul_small_m.cu FSmall<MT, NW>: MT 1, 2, 4 or 8 (M <= 8 MT)
        mt = next(m for m in (1, 2, 4, 8) if M <= 8 * m)
        rows, wk = 8 * mt, 8 // mt
        stage = nw * 32 * 128 + rows * (32 + 4)
        red = wk * nw * rows * 128
        return _pick(s, 4 * max(3 * stage, red), lib,
                     "matmul_ffma_small_m_smem", M, nw - 1)
    return _pick(s, _simt_tile(nw), lib, "matmul_simt_smem", nw - 1)


def conv2d(kh: int, kw: int, CI: int, CO: int, stride: int,
           dtype: torch.dtype, aligned: bool = True,
           lib: Any = None, tile=None) -> Tuple[str, int]:
    """conv2d_fused's schedule and shared bytes for a (kh, kw, CI, CO)
    filter at ``stride`` and the Hopper ``tile``."""
    from repro_torch.kernels.conv2d import _schedule, block_of
    s = _schedule(CI, CO, dtype, aligned, kernel=(kh, kw, stride))
    block = block_of(s, CO, tile)
    K = kh * kw * CI
    if s == "wgmma":
        # csrc/conv2d_wgmma.cu smem_bytes<BN>: 3 stages of a 128 x 64 A box
        # and BN / 64 w boxes (BN the block's), + 1024
        bn = block[1]
        return _pick(s, 3 * (128 * 64 * 2 + (bn // 64) * 64 * 64 * 2) + 1024,
                     lib, "conv2d_wgmma_smem", bn)
    if s == "ffma":
        return _pick(s, _ffma_tile(block[1], 1), lib, "conv2d_ffma_smem",
                     block[1])
    cols = 3 * 64 * 4                  # rt::EpilogueCols<64>: f, mean, bias
    if s == "mid_ci":
        # csrc/conv2d_mid_ci.cu smem_bytes(KP): the w strip, the 3-slot
        # ring of 128-pixel chunk rows, the staging tile, the chunk map
        kp = -(-K // 32) * 32
        wld, ald = 64 + 8, 32 + 8
        return _pick(s, (kp * wld * 2 + 3 * 128 * ald * 2 + 128 * wld * 2
                         + (kp // 8) * 16 + cols),
                     lib, "conv2d_mid_ci_smem", CI, kh, kw)
    if s == "small_ci":
        # csrc/conv2d_small_ci.cu smem_bytes(p, bf16): HE the halo's
        # elements, ((8 - 1) s + kh) rows of ((16 - 1) s + kw) CI
        he = ((8 - 1) * stride + kh) * ((16 - 1) * stride + kw) * CI
        wld = 64 + 8
        if dtype == torch.bfloat16:
            kp = -(-K // 16) * 16
            nb = kp * wld * 2 + 128 * wld * 2 + kp * 4 + cols + he * 2
        else:
            nb = (K * 64 * 4 + ((K + 3) & ~3) * 4 + cols
                  + 2 * ((he + 3) & ~3) * 4)
        return _pick(s, nb, lib, "conv2d_small_ci_smem", _CODE[dtype], CI,
                     kh, kw, stride)
    return _pick(s, _simt_tile(1), lib, "conv2d_simt_smem")


def flash_attention(D: int, dtype: torch.dtype,
                    lib: Any = None, tile=None) -> Tuple[str, int]:
    """flash_attention's schedule and shared bytes at head width D and the
    Hopper ``tile`` (bq, bk).  The mirror counts a tile the ``ffma`` kernel
    does not take for its size (the static verifier's K202 refuses it); the
    library refuses it."""
    from repro_torch.kernels.attention import (_ffma_smem_bytes, _schedule,
                                               check_tile, default_tile)
    s = _schedule(dtype, D)
    bq = (default_tile(dtype, D) if tile is None else check_tile(tile))[0]
    if s == "wgmma":
        # csrc/flash_attention_wgmma.cu smem_bytes<D, BQ>: 1024 of
        # alignment, Q's D / 64 boxes of BQ x 64, STAGES of K and V boxes
        # (64 keys) and their key positions, the mbarriers and pad flags
        stages = {64: 4, 128: 3, 256: 2}[D]
        q = (D // 64) * bq * 128
        stage = 2 * (D // 64) * 64 * 128
        return _pick(s, (1024 + q + stages * (stage + 64 * 4)
                         + (1 + 2 * stages) * 8 + stages * 4),
                     lib, "flash_attention_wgmma_smem", D, bq)
    if s == "ffma":
        if lib is None:
            return s, _ffma_smem_bytes(D, bq)
        # csrc/flash_attention_ffma.cu: the tiles' fifth entry
        tiles = (ctypes.c_int * 5)()
        if lib.flash_attention_ffma_tiles(D, bq, tiles) != 0:
            raise ValueError(f"flash_attention_ffma_tiles({D}, {bq}): no "
                             "such shape")
        return s, int(tiles[4])
    # csrc/flash_attention.cu smem_bytes<D>: Qs, Ks, Vs, Ps and key positions
    return _pick(s, (D * 68 + D * 68 + 64 * D + 64 * 68) * 4 + 64 * 4, lib,
                 "flash_attention_simt_smem", D)


def decode_attention(D: int, G: int, dtype: torch.dtype, B: int, C: int,
                     KV: int, n_sm: int = H100_SMS, lib: Any = None,
                     tile=None) -> Tuple[str, int]:
    """decode_attention's schedule and shared bytes at head width D with G
    query heads a KV head, B rows of a rolling cache of C slots over KV
    heads: the mma and ffma schedules keep a split's ``chunk`` slots of
    slot map (``decode_attention.splits`` on ``n_sm`` SMs, at the chunk
    ``tile`` pins; None or ``"auto"`` the auto split)."""
    from repro_torch.kernels.decode_attention import (_core_smem, _schedule,
                                                      check_tile, pinned,
                                                      splits)
    s = _schedule(dtype, D)
    if pinned(tile) is not None:
        check_tile(pinned(tile), B, C, KV, G, D, dtype)
    if s in ("mma", "ffma"):
        chunk = splits(B, C, KV, G, D, dtype, n_sm, pinned(tile))[1]
        return _pick(s, _core_smem(dtype, D, chunk), lib, "decode_core_smem",
                     _CODE[dtype], D, chunk)
    # csrc/decode_attention.cu smem_bytes<D>(G)
    return _pick(s, (G * D + 64 * (D + 1) + 64 * D + G * 64 + G * D
                     + 3 * G) * 4 + 64 * 4,
                 lib, "decode_attention_simt_smem", D, G)


def paged_decode_attention(D: int, dtype: torch.dtype, Sq: int, G: int,
                           nblk: int, bs: int,
                           lib: Any = None) -> Tuple[str, int]:
    """paged_decode_attention's schedule and shared bytes at head width D,
    ``Sq`` queries a row, G query heads a KV head and a block table of
    ``nblk`` blocks of ``bs`` tokens a row."""
    from repro_torch.kernels.decode_attention import (_core_smem, _paged_tmax,
                                                      _schedule, paged_rows)
    s = _schedule(dtype, D)
    if s in ("mma", "ffma"):
        # csrc/paged_decode_attention.cu: the core keeps core_extra(tmax,
        # Sq) = tmax + Sq ints of slot map, tmax the wrapper's argument
        tmax = _paged_tmax(nblk, bs, Sq)
        return _pick(s, _core_smem(dtype, D, tmax + Sq), lib,
                     "paged_decode_core_smem", _CODE[dtype], D, Sq, tmax)
    # csrc/paged_decode_attention.cu block_smem<D>(R): RT = min(R, ROWS)
    R = Sq * G
    rt = min(R, paged_rows(D))
    return _pick(s, (64 * 8 + (rt * D + 64 * (D + 1) + 64 * D + rt * 64
                               + rt * D + 3 * rt) * 4 + rt * 4),
                 lib, "paged_decode_attention_simt_smem", D, R)


def lru_scan(B: int, S: int, W: int, dtype: torch.dtype,
             aligned: bool = True, lib: Any = None) -> Tuple[str, int]:
    """lru_scan's schedule and shared bytes for (B, S, W) in ``dtype``."""
    from repro_torch.kernels.lru_scan import (NSTAGE, ROW_BYTES,
                                              STEPS_A_WARP, scan_geometry)
    elem = dtype.itemsize
    if not aligned or (W * elem) % 16:
        return _pick("seq", 0, lib, "lru_scan_smem", _CODE[dtype], 0)
    ts = scan_geometry(B, S, W, elem)[0]
    # csrc/lru_scan.cu chunked_smem<TS, T>: the window ring of a and b, and
    # the warps' carries (two floats a lane value)
    lanes = 1 if dtype == torch.float32 else 2
    return _pick("chunked", (NSTAGE * 2 * ts * ROW_BYTES
                             + 2 * (ts // STEPS_A_WARP) * 32 * lanes * 4),
                 lib, "lru_scan_smem", _CODE[dtype], ts)
