"""conv2d_fused — direct 2-D convolution with the fused BN/activation
epilogue, as hand-written CUDA kernels for Hopper: five schedules of the
same function.

Replaces the Pallas kernel ``conv2d_fused`` of ``src/repro/kernels/conv2d.py``
(the paper's workhorse op): x (N, H, W, CI) NHWC times w (kh, kw, CI, CO)
HWIO, stride, SAME or VALID padding, fp32 accumulation, then the inference
batch-norm fold ``(y - mean) * rsqrt(var + 1e-5) * scale + bias`` and the
activation before the single write, in ``x.dtype``.  groups = 1 only: the
registry sends a grouped (depthwise) conv to the reference op.

Every schedule is an implicit GEMM with M = N*Ho*Wo output pixels, K =
kh*kw*CI ordered (dh, dw, ci) and N = CO, B being w viewed as (K, CO); the
padding is a predicate in the gather with XLA's low/high split, so the input
is never padded in memory.  What bounds it on the H100: at ResNet-34's
shapes a conv does 100-300 operations per byte it must move, near or above
the card's bf16 ridge (about 295) and far above fp32's (about 20), so the
FLOPs bound most layers; the bf16 stem (CI 3) is bound by its output
bytes.  ``chip_smoke.py`` states the bound of each shape.  The wrapper
picks the schedule with :func:`_schedule`, a pure function of the
channels, the dtype, the taps and the pointers' alignment (a dispatch between
hand-written kernels, not a fallback: a build or launch failure raises):

- ``wgmma`` (``csrc/conv2d_wgmma.cu``): bf16 with CI a multiple of 64 and
  CO of 8 — every ResNet-34 conv but the 7x7 stem, MobileNetV1's pointwise
  convs from 64 channels up.  A 64-deep K stage is one tap x 64 channels,
  128 contiguous bytes of x a pixel, gathered with ``cp.async`` into the
  128-byte swizzle the ``wgmma`` descriptors read; two warpgroups on
  m64nBNk16 (BN the tile's, below), a 3-slot ring, two blocks an SM.
- ``ffma`` (``csrc/conv2d_fused.cu`` ``conv2d_ffma`` on
  ``csrc/ffma_tile.cuh``): fp32 with CI and CO multiples of 4 — the base
  flow's ResNet-34 convs but the stem.  Full fp32 FMAs (no TF32), 128 x
  BN tiles of 8 x BN / 16 a thread (BN the tile's, below), the im2col
  gather one float4 of channels a chunk through a 4-slot ``cp.async``
  ring.
- ``mid_ci`` (``csrc/conv2d_mid_ci.cu``): bf16 with 8 <= CI < 64, CI and
  CO multiples of 8, K = kh kw CI at most :data:`MID_CI_K_MAX` (576, so
  that a block's 64-channel w strip stays resident in shared memory: at
  most 81 KB), 16-byte aligned — MobileNetV1's 32-channel pointwise conv.
  Bound by its bytes (about 21 flops a byte at the path's shape).  A
  persistent grid (:func:`mid_ci_grid`) of blocks that each keep one
  64-channel strip and walk 128-pixel tiles (:func:`mid_ci_walk`); a
  32-deep K stage is four 16-byte chunks a pixel, 8 channels of one tap
  each (:func:`mid_ci_chunks`), gathered by ``cp.async`` into a 3-slot ring
  that runs across tiles; ``mma.sync`` m16n8k16; the output through shared
  memory as whole 128-byte rows.
- ``small_ci`` (``csrc/conv2d_small_ci.cu``): convs with few input
  channels (CI < 8, K = kh kw CI <= 256, the tile's halo within
  :data:`SMALL_CI_HALO_MAX` elements; fp32 with CI a multiple of 4 stays on
  ``ffma``) — ResNet-34's 7x7 stride-2 stem, MobileNetV1's first conv,
  LeNet-5's two convs, in both dtypes, at any alignment.  A block walks 8 x
  16-pixel output tiles by 64 channels (a persistent grid); a tile's input
  halo (:func:`small_ci_halo`) comes into shared memory once and the
  product gathers from it through the K map (:func:`small_ci_kmap`), so the
  inner loop has no division and reads no pixel from memory twice.  bf16
  runs ``mma.sync`` m16n8k16 (8 warps, one output row of 16 pixels each),
  fp32 full FP32 FMAs (8 x 8 outputs a thread).
- ``simt`` (``csrc/conv2d_fused.cu`` ``conv2d_fused``): the rest —
  unaligned views of 8 or more channels, bf16 with CI of 8 or more not a
  multiple of 8 (or 64 up); no conv of the three CNNs.  64 x 64 output
  tiles of a 256-thread block, 16-deep K steps staged as fp32, fp32 FMAs.

``wgmma`` and ``ffma`` split K when their grid is under half a wave
(:func:`_conv_split`: ResNet-34's 28 x 28, 14 x 14 and 7 x 7 layers at batch
8 have 49, 26 and 16 blocks); each block writes fp32 partials that a second
kernel sums in a fixed order (no float atomics: the bits repeat) before the
fold and act.

The tile: ``wgmma`` and ``ffma`` take their block from the plan's Hopper
tile ``plan.tiles["conv2d"]`` = ``(bm, bn)``, one of :data:`TILES`: 128
output pixels by bn output channels.  By default (``tile=None``, and the
tiling pass's selection) :data:`DEFAULT_TILE` (128, 128); the base flow's
minimal tile is (128, 64).  A conv of 64 output channels runs bn 64 under
either tile (its 64 channels are the whole tile).  ``mid_ci``,
``small_ci`` and ``simt`` take no tile: their blocks are fixed by their
own rules (above).  A tile none of the kernels takes raises; it is never
replaced by another.

On a CPU tensor the wrapper runs :func:`conv2d_fused_plain` (which no tile
changes); on a CUDA tensor it launches a kernel or raises.
``conv2d_fused.launches`` counts the launches,
``conv2d_fused.schedule_launches`` splits them by schedule,
``conv2d_fused.tiles`` by (schedule, block run) (None for the schedules
that take no tile), and ``conv2d_fused.retiled`` counts those at a block
other than the default tile's.  No ``F.conv2d``, no cuDNN and no TF32 on
the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.matmul_fused import _sm_count, _wave_split

SCHEDULES = ("wgmma", "ffma", "mid_ci", "small_ci", "simt")
CONV_BM = 128                         # rows (output pixels) a block
MID_CI_BN = 64                        # mid_ci's channel strip
MID_CI_KS = 32                        # its K stage: four 8-channel chunks
MID_CI_K_MAX = 576                    # its taps kh kw CI at most
SMALL_CI_TILE = (8, 16)               # small_ci's output tile (rows, cols)
SMALL_CI_HALO_MAX = 3072              # its halo's elements at most
SMALL_CI_K_MAX = 256                  # its taps kh kw CI at most
TILES = ((CONV_BM, 64), (CONV_BM, 128))   # the (bm, bn) tiles wgmma and
DEFAULT_TILE = (CONV_BM, 128)             # ffma take; the default


def check_tile(tile) -> tuple:
    """``tile`` as a tuple of ints, one of :data:`TILES`; raises
    ``ValueError`` for any other."""
    t = tuple(int(v) for v in tile)
    if t not in TILES:
        raise ValueError(f"conv2d_fused: no kernel takes the tile {t}; the "
                         f"tiles are {TILES}")
    return t


def block_of(sched: str, CO: int, tile=None):
    """The (bm, bn) block a conv of CO output channels runs on ``sched``:
    the tile given (:func:`check_tile`) or :data:`DEFAULT_TILE`, bn 64 when
    CO is 64; None for the schedules that take no tile."""
    t = DEFAULT_TILE if tile is None else check_tile(tile)
    if sched not in ("wgmma", "ffma"):
        return None
    return (t[0], 64) if CO == 64 else t


def small_ci_halo(kh: int, kw: int, CI: int, stride: int) -> Tuple[int, int,
                                                                   int]:
    """(rows, row elements, elements) of a ``small_ci`` tile's input halo:
    the input pixels an 8 x 16-pixel output tile reads, ((8 - 1) s + kh)
    rows of ((16 - 1) s + kw) pixels of CI channels (21 x 111 = 2331 at the
    7x7 stride-2 stem)."""
    th, tw = SMALL_CI_TILE
    rows, cols = (th - 1) * stride + kh, (tw - 1) * stride + kw
    return rows, cols * CI, rows * cols * CI


def small_ci_kmap(kh: int, kw: int, CI: int, stride: int) -> list:
    """The K map of ``small_ci``: for tap k = (dh, dw, ci) (HWIO order, as
    w viewed as (K, CO)), its offset from an output pixel's corner in the
    halo, ``dh * row + dw * CI + ci``.  Output pixel (r, c) of the tile
    reads tap k at ``r * stride * row + c * stride * CI + kmap[k]``."""
    row = small_ci_halo(kh, kw, CI, stride)[1]
    return [dh * row + dw * CI + ci for dh in range(kh) for dw in range(kw)
            for ci in range(CI)]


def mid_ci_chunks(kh: int, kw: int, CI: int, W: int) -> list:
    """The chunk map of ``mid_ci``: for each 8-channel chunk j of K (ordered
    (dh, dw, ci), padded to the 32-deep stage), ``(dh, dw, off)`` with
    ``off = (dh * W + dw) * CI + ci`` the chunk's element offset from its
    pixel's corner tap in x (W the input width); None for a padding chunk.
    CI % 8 == 0, so a chunk never straddles two taps."""
    K = kh * kw * CI
    out = []
    for j in range(-(-K // MID_CI_KS) * MID_CI_KS // 8):
        k = 8 * j
        if k >= K:
            out.append(None)
            continue
        tap, ci = divmod(k, CI)
        dh, dw = divmod(tap, kw)
        out.append((dh, dw, (dh * W + dw) * CI + ci))
    return out


def mid_ci_grid(M: int, CO: int, blocks: int) -> int:
    """``mid_ci``'s persistent grid: ``blocks`` (three an SM, or as many as
    fit if fewer, times the SMs: 396 on the H100), at most one a tile,
    rounded down to a multiple of the 64-channel strips (at least one block
    a strip) so that a block keeps one strip."""
    strips, mtiles = -(-CO // MID_CI_BN), -(-M // CONV_BM)
    grid = min(blocks, mtiles * strips)
    return max(strips, grid // strips * strips)


def mid_ci_walk(M: int, CO: int, grid: int) -> list:
    """The tiles of each block of ``mid_ci``'s grid, in the order it runs
    them: block b keeps strip ``b % strips`` (channels ``64 strip ..``) and
    walks M tiles ``b // strips``, ``+ grid // strips``, ... (pixels ``128
    mt ..``); one list of (strip, mt) a block."""
    strips, mtiles = -(-CO // MID_CI_BN), -(-M // CONV_BM)
    groups = grid // strips
    return [[(b % strips, mt) for mt in range(b // strips, mtiles, groups)]
            for b in range(grid)]


def _schedule(CI: int, CO: int, dtype: torch.dtype, aligned: bool,
              kernel: Optional[Tuple[int, int, int]] = None) -> str:
    """The kernel that runs a conv: ``wgmma`` for bf16 with CI a multiple
    of 64 (a 64-deep K stage is one tap) and CO of 8, ``ffma`` for fp32
    with CI and CO multiples of 4 (16-byte ``cp.async`` chunks), when x, w
    and out are 16-byte aligned; ``mid_ci`` for aligned bf16 with 8 <= CI <
    64, CI and CO multiples of 8 and K = kh kw CI at most
    :data:`MID_CI_K_MAX` (``kernel`` = (kh, kw, stride); a 1x1 conv when it
    is not given); then ``small_ci`` for CI < 8 in either dtype when
    ``kernel`` is given, K is at most 256 and the tile's halo fits (any
    alignment); ``simt`` for the rest."""
    if aligned and dtype == torch.bfloat16 and CI % 64 == 0 and CO % 8 == 0:
        return "wgmma"
    if aligned and dtype == torch.float32 and CI % 4 == 0 and CO % 4 == 0:
        return "ffma"
    if aligned and dtype == torch.bfloat16 and 8 <= CI < 64 and \
            CI % 8 == 0 and CO % 8 == 0:
        kh, kw, _ = kernel or (1, 1, 1)
        if kh * kw * CI <= MID_CI_K_MAX:
            return "mid_ci"
    if kernel is not None and dtype in (torch.bfloat16, torch.float32) \
            and CI < 8:
        kh, kw, stride = kernel
        if kh * kw * CI <= SMALL_CI_K_MAX and \
                small_ci_halo(kh, kw, CI, stride)[2] <= SMALL_CI_HALO_MAX:
            return "small_ci"
    return "simt"


def _conv_split(M: int, K: int, CO: int, sms: int = 132, tile=None):
    """(nsplit, kc) of the ``wgmma`` and ``ffma`` schedules: their grid of
    128-pixel x bn-channel blocks (:func:`block_of` at ``tile``: bn 64 when
    CO is 64, else the tile's, by default 128) split along K in whole
    64-deep stages by :func:`_wave_split` when it is under half a wave."""
    bn = block_of("wgmma", CO, tile)[1]
    return _wave_split(-(-M // CONV_BM) * -(-CO // bn), K, sms)


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
    ``x.dtype``.  ``tile`` is the plan's Hopper tile (bm, bn) (module
    docstring); None takes :data:`DEFAULT_TILE`."""
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
    geom = (N, H, W, CI, CO, kh, kw, stride, pt, pl, ho, wo,
            _build.ACT_CODES[act])
    aligned = all(t.data_ptr() % 16 == 0 for t in (xc, wc, out))
    sched = _schedule(CI, CO, dt, aligned, (kh, kw, stride))
    block = block_of(sched, CO, tile)
    if sched in ("simt", "small_ci"):
        _build.call("conv2d_fused" if sched == "simt" else "conv2d_small_ci",
                    _build.DTYPE_CODES[dt], _build.ptr(xc), _build.ptr(wc),
                    *[_build.ptr(t) for t in bnc], _build.ptr(out), *geom,
                    _build.stream())
    elif sched == "mid_ci":
        _build.call("conv2d_mid_ci", _build.ptr(xc), _build.ptr(wc),
                    *[_build.ptr(t) for t in bnc], _build.ptr(out), *geom,
                    _build.stream())
    else:
        M = N * ho * wo
        nsplit, kc = _conv_split(M, kh * kw * CI, CO, _sm_count(x.device),
                                 block)
        ws = (torch.empty(nsplit * M * CO, dtype=torch.float32,
                          device=x.device) if nsplit > 1 else None)
        _build.call(f"conv2d_{sched}", _build.ptr(xc), _build.ptr(wc),
                    *[_build.ptr(t) for t in bnc], _build.ptr(ws),
                    _build.ptr(out), *geom, kc, nsplit, block[1],
                    _build.stream())
    conv2d_fused.launches += 1
    conv2d_fused.schedule_launches[sched] += 1
    key = (sched, block)
    conv2d_fused.tiles[key] = conv2d_fused.tiles.get(key, 0) + 1
    if block is not None and block != block_of(sched, CO):
        conv2d_fused.retiled += 1
    return out if dt == x.dtype else out.to(x.dtype)


conv2d_fused.launches = 0
conv2d_fused.schedule_launches = dict.fromkeys(SCHEDULES, 0)
conv2d_fused.tiles = {}
conv2d_fused.retiled = 0


def conv2d_fused_fake(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                      padding: str = "SAME",
                      bn: Optional[Sequence[torch.Tensor]] = None,
                      act: Optional[str] = None, tile=None) -> torch.Tensor:
    """:func:`conv2d_fused`'s shape-only stand-in (the dry-run): the
    (N, Ho, Wo, CO) output, unfilled, and 2 kh kw CI operations an output
    element.  A tile none of the kernels takes raises, as in the wrapper."""
    from repro_torch.kernels import _fake
    if tile is not None:
        check_tile(tile)
    N, H, W, CI = x.shape
    kh, kw, _, CO = w.shape
    _, _, ho, wo = conv_geometry(H, W, kh, kw, stride, padding)
    out = x.new_empty((N, ho, wo, CO))
    _fake.count("conv2d_fused", 2 * N * ho * wo * CO * kh * kw * CI,
                _fake.nbytes(x, w, out, *(bn or ())))
    return out
