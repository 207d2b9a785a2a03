"""matmul_fused — the fused tiled matmul, as hand-written CUDA kernels for
Hopper: five schedules of the same function and the base variant.

Replaces the Pallas kernel ``matmul_fused`` of
``src/repro/kernels/matmul_fused.py``: ``y = epilogue(x @ w [, x @ w2])``
over (M, K) x (K, N), the leading dims of x flattened into M and restored
on the way out; fp32 accumulation, a second accumulator when ``w2`` is given
(the GLU form the LM slices use); the epilogue in the JAX kernel's order —
GLU ``act(x@w) * (x@w2)`` (silu by default), then bias, then act — and one
write in ``out_dtype``.  Registered for ``matmul`` and ``glu_matmul``.

The wrapper picks a schedule with :func:`_schedule`, a pure function of the
shape, the operand dtype and the pointers' alignment (a dispatch between
hand-written kernels, not a fallback: a build or launch failure raises):

- ``wgmma`` (``csrc/matmul_wgmma.cu``): bf16 operands, M above
  :data:`SMALL_M_MAX` (64 rows, 32 for the GLU pair), K and N multiples
  of 8, 16-byte aligned operands (the TMA rules) — the LM prefills, serving
  prefill batches and chunked catch-up.  Bound by the operations (a
  4096-row projection does some 1,000-3,000 flops a byte against the
  H100's ridge of ~295): TMA loads of 128 x 64 x tiles and 64 x bn w
  tiles (bn the tile's, below) into a 3-stage ring, one producer warp, two
  consumer warpgroups on ``wgmma`` m64nBNk16 (m64n64k16 twice in the GLU
  form), fp32 accumulators and the epilogue in registers, two blocks an
  SM.
- ``small_m`` (``csrc/matmul_small_m.cu``): the same operands with M at or
  below :data:`SMALL_M_MAX` — decode steps and serving ticks (8 rows),
  speculative verify of the plain projections (40), the CNN heads at batch
  8.  Bound by the weight
  bytes (K * N * 2: 2.5 us for a 2048 x 2048 projection at 3.35 TB/s):
  split K over 4 blocks an SM or more (:func:`_split_k`), 16-byte
  ``cp.async`` streams of w, ``mma.sync`` m16n8k16; fp32 partials to a
  workspace that a second kernel sums in a fixed order (no float atomics:
  the output repeats bit for bit) before the epilogue.
- ``ffma`` (``csrc/matmul_fused.cu`` ``matmul_ffma`` on
  ``csrc/ffma_tile.cuh``): fp32 operands, M above :data:`SMALL_M_MAX`, K
  and N multiples of 4, 16-byte aligned — the fp32 (base flow) prefills.
  Full fp32 FMAs (no TF32: the fp32 checks and the fp32 greedy identity
  need it), bound by the operations at 67 TFLOP/s: 128 x bn output tiles
  (bn the tile's; 128 x 64 in the GLU form) of 8 x bn / 16 a thread,
  16-deep K stages through a 4-slot ``cp.async`` ring; a grid under half a wave splits K
  (:func:`_wave_split`), the partials summed in a fixed order.
- ``ffma_small_m`` (``csrc/matmul_small_m.cu`` ``matmul_ffma_small_m``):
  the same fp32 operands at or below :data:`SMALL_M_MAX` rows — the fp32
  decode steps and serving ticks.  Bound by the weight bytes (K * N * 4):
  ``small_m``'s split (:func:`_split_k`) and fixed-order reduction, w
  streamed by ``cp.async``, fp32 FMAs with x's rows as broadcasts.
- ``simt`` (``csrc/matmul_fused.cu`` ``matmul_fused``): everything else —
  K or N not a multiple of 8 in bf16 or of 4 in fp32 (LeNet-5's 120 -> 84
  and 84 -> 10 heads), unaligned views.  64 x 64 output tiles of a
  256-thread block, 16-deep K steps staged in shared memory as fp32, fp32
  FMAs.

The tile: ``wgmma`` and ``ffma`` take their block from the plan's Hopper
tile ``plan.tiles["matmul"]`` = ``(bm, bk, bn)``, one of :data:`TILES`:
128 rows by bn columns in 64-deep (``wgmma``) K stages.  By default
(``tile=None``, and the tiling pass's selection) :data:`HOPPER_TILE`
(128, 64, 128); the base flow's minimal tile is (128, 64, 64).  The GLU
form runs 128 x 64 per accumulator under either tile (its two
accumulators fill the registers of the plain form's one).  ``small_m``,
``ffma_small_m`` and ``simt`` take no tile: their blocks follow the rows
and the K split.  A tile none of the kernels takes raises; it is never
replaced by another.

``vmem_accum=False`` is the Pallas kernel's base branch (the paper's base
kernel, ``matmul_fused.py:70-80``): the sum goes through the output dtype
one ``bk``-deep K slab at a time, ``bk = min(tile[1], rup(K, 128))`` as in
JAX — ``sum = round(sum + round(slab))`` — and has no GLU form; nothing on
the op layer passes it, in either package.  Its ``tile`` is the TPU tile
of the JAX package's tile table (the kernel facade's ``tile``, by default
:data:`DEFAULT_TILE`), never the Hopper tile: its slabs are a rounding
rule of the function, which a Hopper block (bk 64) must not change, and
its cores run their default blocks.  It runs on the CW schedules'
cores, chosen by :func:`_base_schedule` (the CW rule at the plain form's
crossover, and a slab that is a whole number of the core's K stages):

- ``wgmma`` (``matmul_base_wgmma``): bf16 above 64 rows.  The CW mainloop;
  in bf16 out, at a slab's last 64-deep stage the consumers fold the fp32
  accumulator into a bf16 running sum in registers.
- ``small_m``, ``ffma_small_m`` (``matmul_base_small_m``) and ``ffma``
  (``matmul_base_ffma``): the CW K split cut at slab boundaries
  (:func:`_base_split`); ``rt::splitk_reduce_slabs`` walks the fp32
  partials in K order, sums a slab's in fp32 and rounds between slabs,
  then bias and act.  In fp32 out, where rounding to fp32 changes nothing,
  an unsplit ``ffma`` grid stays unsplit (the CW kernel as it is).
- ``simt`` (``matmul_base`` in ``csrc/matmul_fused.cu``): the SIMT core,
  two round-to-nearest-even steps a slab, for the rest (K or N off the 8 /
  4 grid, unaligned views, slabs off the cores' stages).

On a CPU tensor the wrapper runs the plain versions; on a CUDA tensor it
launches a kernel or raises.  ``matmul_fused.launches`` counts the CW
launches, ``matmul_fused.schedule_launches`` splits them by schedule,
``matmul_fused.base_launches`` counts the base variant's and
``matmul_fused.base_schedule_launches`` splits those,
``matmul_fused.tiles`` splits the CW launches by (schedule, block run)
(None for the schedules that take no tile) and ``matmul_fused.retiled``
counts those at a block other than the default tile's.  No
``torch.matmul``, no cuBLAS and no TF32 on the card.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build

SCHEDULES = ("wgmma", "small_m", "ffma", "ffma_small_m", "simt")
# the largest M on the small-M schedules, plain and GLU form; above it
# wgmma (ffma in fp32).
# Set from the crossover measured on the H100 (chip_smoke.py times both
# schedules at llama's q and GLU shapes between 32 and 128 rows; PERF.md):
# at 40-64 rows small_m takes under half of wgmma's time on a 2048 x 2048
# projection, whose wgmma grid has only N / 128 = 16 blocks, while the GLU
# pair's wide N fills the card and wgmma wins above 32 rows.
SMALL_M_MAX = {False: 64, True: 32}
DEFAULT_TILE = (256, 512, 256)        # repro/kernels/ops.py's default
# the (bm, bk, bn) tiles wgmma and ffma take, and the default
TILES = ((128, 64, 64), (128, 64, 128))
HOPPER_TILE = (128, 64, 128)
GLU_BN = 64                           # the GLU form's bn under either tile
SMALL_M_BK = 32                       # K a stage of the small_m kernel
SMALL_M_BN = 128                      # columns a block of the small_m kernel
FFMA_BM = 128                         # rows a block of the ffma kernel
WAVE_STAGE = 64                       # K unit of a split of _wave_split


def _rup(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _slab_depth(K: int, tile) -> int:
    """The base variant's K slab: the tile's K extent cut to rup(K, 128)
    (JAX's ``bk``), the tile (256, 512, 256) when none is given."""
    return min((tile or DEFAULT_TILE)[1], _rup(K, 128))


def check_tile(tile) -> tuple:
    """``tile`` as a tuple of ints, one of :data:`TILES`; raises
    ``ValueError`` for any other."""
    t = tuple(int(v) for v in tile)
    if t not in TILES:
        raise ValueError(f"matmul_fused: no kernel takes the tile {t}; the "
                         f"tiles are {TILES}")
    return t


def block_of(sched: str, glu: bool, tile=None):
    """The (bm, bk, bn) block a CW product runs on ``sched``: the tile
    given (:func:`check_tile`) or :data:`HOPPER_TILE`, bn :data:`GLU_BN`
    in the GLU form; None for the schedules that take no tile."""
    t = HOPPER_TILE if tile is None else check_tile(tile)
    if sched not in ("wgmma", "ffma"):
        return None
    return (t[0], t[1], GLU_BN) if glu else t


def _schedule(M: int, K: int, N: int, in_dtype: torch.dtype, glu: bool,
              aligned: bool) -> str:
    """The kernel that runs a CW product: ``wgmma`` or ``small_m`` for bf16
    operands that meet the TMA rules (K and N multiples of 8, every operand
    16-byte aligned), ``ffma`` or ``ffma_small_m`` for fp32 operands with K
    and N multiples of 4, 16-byte aligned (the 16-byte ``cp.async`` rows),
    split at :data:`SMALL_M_MAX` rows of the form (the GLU pair's crossover
    is lower); ``simt`` for the rest."""
    small = M <= SMALL_M_MAX[glu]
    if in_dtype == torch.bfloat16 and aligned and not (K % 8 or N % 8):
        return "small_m" if small else "wgmma"
    if in_dtype == torch.float32 and aligned and not (K % 4 or N % 4):
        return "ffma_small_m" if small else "ffma"
    return "simt"


@functools.lru_cache(maxsize=None)
def _split_k(M: int, K: int, N: int, sms: int = 132):
    """(nsplit, kc) of the small_m schedule: K rows per split kc, a multiple
    of the 32-deep stage, enough splits for 4 blocks an SM over the
    128-column strips, but not so many that the fp32 partials (written and
    read back: 8 * nsplit * M * N bytes) outweigh the weight read
    (2 * K * N bytes).  Memoised: a decode step asks for the same few
    shapes a hundred times."""
    strips = -(-N // SMALL_M_BN)
    want = -(-4 * sms // strips)
    cap = max(1, K // (4 * M))
    nsplit = max(1, min(want, cap, -(-K // SMALL_M_BK)))
    kc = _rup(-(-K // nsplit), SMALL_M_BK)
    return -(-K // kc), kc


# the K stage of each core (a base-variant slab is a whole number of them)
BASE_STAGE = {"wgmma": 64, "small_m": SMALL_M_BK, "ffma": WAVE_STAGE,
              "ffma_small_m": SMALL_M_BK}


def _base_schedule(M: int, K: int, N: int, in_dtype: torch.dtype,
                   aligned: bool, bk: int) -> str:
    """The kernel that runs the base variant: the plain CW form's schedule
    (:func:`_schedule`) when the slab depth ``bk`` is a whole number of its
    core's K stages (:data:`BASE_STAGE`), else ``simt``."""
    sched = _schedule(M, K, N, in_dtype, False, aligned)
    if sched == "simt" or bk % BASE_STAGE[sched]:
        return "simt"
    return sched


def _base_split(cw, K: int, bk: int, stage: int, exact: bool):
    """(nsplit, kc) of the base variant on a split-K core: the core's CW
    split ``cw`` = (nsplit, kc) cut so that every split lies inside one
    ``bk``-deep slab — kc divides bk and is a multiple of ``stage`` — and
    is no coarser than ``cw``'s (bk // kc splits a slab; the K tail's slab
    may have fewer).  ``exact`` (a bf16 output, rounded between slabs): the
    slabs must meet in the reduction, so even one split goes through it.
    Without (fp32 out: rounding to fp32 changes nothing) an unsplit ``cw``
    stays as it is."""
    nsplit, kc = cw
    if nsplit == 1 and not exact:
        return cw
    d = -(-bk // min(kc, bk))
    while bk % d or (bk // d) % stage:
        d += 1
    return -(-K // (bk // d)), bk // d


def _base_plan(M: int, K: int, N: int, in_dtype: torch.dtype,
               out_dtype: torch.dtype, aligned: bool, bk: int,
               sms: int = 132):
    """(schedule, nsplit, kc) of one base-variant call: the K rows [s kc,
    (s + 1) kc) of split s are summed in fp32, the splits of a slab in K
    order, and each slab's sum is rounded to ``out_dtype`` and added into
    the running sum in that dtype.  ``wgmma`` and ``simt`` fold each slab
    in registers (one split a slab); the split-K cores cut their CW split
    at the slabs (:func:`_base_split`); an unsplit fp32 ``ffma`` grid in
    fp32 out is one split over all of K."""
    sched = _base_schedule(M, K, N, in_dtype, aligned, bk)
    if sched in ("wgmma", "simt"):
        return sched, -(-K // bk), bk
    if sched == "ffma":
        cw = _wave_split(-(-M // FFMA_BM) * -(-N // 128), K, sms)
    else:
        cw = _split_k(M, K, N, sms)
    return (sched, *_base_split(cw, K, bk, BASE_STAGE[sched],
                                out_dtype != torch.float32))


def _wave_split(blocks: int, K: int, sms: int = 132):
    """(nsplit, kc) of a tile grid of ``blocks`` blocks over a K-deep sum,
    kc rows a split in whole :data:`WAVE_STAGE`-deep stages.  A grid of
    half a wave or more is not split (a split buys at most the idle rest of
    the wave and costs a reduction pass); a smaller one takes the most
    splits that keep it within one wave of one block an SM (as many as K
    has stages, at most): a second wave of the 1-block-an-SM ffma kernel
    doubles its time."""
    stages = -(-K // WAVE_STAGE)
    if 2 * blocks >= sms:
        return 1, stages * WAVE_STAGE
    per = -(-stages // max(1, min(stages, sms // blocks)))
    return -(-stages // per), per * WAVE_STAGE


def matmul_fused_plain(x: torch.Tensor, w: torch.Tensor, *,
                       bias: Optional[torch.Tensor] = None,
                       w2: Optional[torch.Tensor] = None,
                       act: Optional[str] = None,
                       out_dtype: Optional[torch.dtype] = None,
                       vmem_accum: bool = True, tile=None) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products of the operands,
    then the epilogue in the kernel's order.  With ``vmem_accum=False`` the
    base branch: per ``bk``-deep K slab (zero-padded at the tail) the fp32
    product is cast to the output dtype and added into the output-dtype
    sum; the epilogue works on that sum widened to fp32."""
    from repro_torch.core.ops_impl import _act
    odt = out_dtype or x.dtype
    if not vmem_accum:
        if w2 is not None:
            raise ValueError("base (non-CW) kernel does not support the GLU "
                             "epilogue")
        K = x.shape[-1]
        bk = _slab_depth(K, tile)
        xf, wf = x.float(), w.float()
        acc = torch.zeros((*x.shape[:-1], w.shape[1]), dtype=odt,
                          device=x.device)
        for k0 in range(0, K, bk):
            part = xf[..., k0:k0 + bk] @ wf[k0:k0 + bk]
            acc = (acc.float() + part.to(odt).float()).to(odt)
        y = acc.float()
    else:
        xf = x.float()
        y = xf @ w.float()
        if w2 is not None:                # GLU pair: act(x@w) * (x@w2)
            y = _act(y, act or "silu") * (xf @ w2.float())
            act = None
    if bias is not None:
        y = y + bias.float()
    if act:
        y = _act(y, act)
    return y.to(odt)


class _Call(NamedTuple):
    """The checked, contiguous operands of one CUDA call."""
    x: torch.Tensor                   # (M, K)
    w: torch.Tensor
    w2: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]      # fp32
    out: torch.Tensor                 # (M, N), out dtype
    M: int
    K: int
    N: int
    act: int                          # code of the post-epilogue act
    glu_act: int                      # code of the GLU act (0 without w2)


def _prepare(x, w, *, bias=None, w2=None, act=None,
             out_dtype=None) -> _Call:
    """Check the CUDA operands and make them contiguous in the promoted
    dtype; allocate the output."""
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
    M = math.prod(x.shape[:-1])
    if min(M, K, N) <= 0 or max(M * K, K * N, M * N) >= 2 ** 31:
        raise ValueError(f"matmul_fused: unsupported size M={M} K={K} N={N}")
    return _Call(
        x.reshape(M, K).to(dt).contiguous(), w.to(dt).contiguous(),
        w2.to(dt).contiguous() if w2 is not None else None,
        bias.to(torch.float32).contiguous() if bias is not None else None,
        torch.empty((M, N), dtype=odt, device=x.device), M, K, N,
        0 if w2 is not None else _build.ACT_CODES[act],
        _build.ACT_CODES[act or "silu"] if w2 is not None else 0)


def _aligned(c: _Call) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in (c.x, c.w, c.w2, c.out)
               if t is not None)


def _codes(c: _Call):
    return _build.DTYPE_CODES[c.x.dtype], _build.DTYPE_CODES[c.out.dtype]


def _launch_simt(c: _Call) -> None:
    ind, outd = _codes(c)
    _build.call("matmul_fused", ind, outd, _build.ptr(c.x), _build.ptr(c.w),
                _build.ptr(c.w2), _build.ptr(c.bias), _build.ptr(c.out),
                c.M, c.K, c.N, c.act, c.glu_act, _build.stream())


def _launch_wgmma(c: _Call, bn: Optional[int] = None) -> None:
    bn = bn or block_of("wgmma", c.w2 is not None)[2]
    _build.call("matmul_wgmma", _codes(c)[1], _build.ptr(c.x),
                _build.ptr(c.w), _build.ptr(c.w2), _build.ptr(c.bias),
                _build.ptr(c.out), c.M, c.K, c.N, c.act, c.glu_act, bn,
                _build.stream())


_SMS: dict = {}                       # device index -> SM count


def _sm_count(dev: torch.device) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


def _launch_small_m(c: _Call) -> None:
    nsplit, kc = _split_k(c.M, c.K, c.N, _sm_count(c.x.device))
    nw = 2 if c.w2 is not None else 1
    ws = torch.empty(nw * nsplit * c.M * c.N, dtype=torch.float32,
                     device=c.x.device)
    _build.call("matmul_small_m", _codes(c)[1], _build.ptr(c.x),
                _build.ptr(c.w), _build.ptr(c.w2), _build.ptr(c.bias),
                _build.ptr(ws), _build.ptr(c.out), c.M, c.K, c.N, kc, nsplit,
                c.act, c.glu_act, _build.stream())


def _launch_ffma(c: _Call, bn: Optional[int] = None) -> None:
    bn = bn or block_of("ffma", c.w2 is not None)[2]
    blocks = -(-c.M // FFMA_BM) * -(-c.N // bn)
    nsplit, kc = _wave_split(blocks, c.K, _sm_count(c.x.device))
    nw = 2 if c.w2 is not None else 1
    ws = (torch.empty(nw * nsplit * c.M * c.N, dtype=torch.float32,
                      device=c.x.device) if nsplit > 1 else None)
    _build.call("matmul_ffma", _codes(c)[1], _build.ptr(c.x),
                _build.ptr(c.w), _build.ptr(c.w2), _build.ptr(c.bias),
                _build.ptr(ws), _build.ptr(c.out), c.M, c.K, c.N, kc, nsplit,
                c.act, c.glu_act, bn, _build.stream())


def _launch_ffma_small_m(c: _Call) -> None:
    nsplit, kc = _split_k(c.M, c.K, c.N, _sm_count(c.x.device))
    nw = 2 if c.w2 is not None else 1
    ws = torch.empty(nw * nsplit * c.M * c.N, dtype=torch.float32,
                     device=c.x.device)
    _build.call("matmul_ffma_small_m", _codes(c)[1], _build.ptr(c.x),
                _build.ptr(c.w), _build.ptr(c.w2), _build.ptr(c.bias),
                _build.ptr(ws), _build.ptr(c.out), c.M, c.K, c.N, kc, nsplit,
                c.act, c.glu_act, _build.stream())


_LAUNCH = {"wgmma": _launch_wgmma, "small_m": _launch_small_m,
           "ffma": _launch_ffma, "ffma_small_m": _launch_ffma_small_m,
           "simt": _launch_simt}


def _launch_base(c: _Call, bk: int) -> str:
    """The base variant, slabs of ``bk``, on the core :func:`_base_plan`
    picks; returns the schedule."""
    ind, outd = _codes(c)
    sched, nsplit, kc = _base_plan(c.M, c.K, c.N, c.x.dtype, c.out.dtype,
                                   _aligned(c), bk, _sm_count(c.x.device))
    if sched == "simt":
        _build.call("matmul_base", ind, outd, _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(c.out),
                    c.M, c.K, c.N, bk, c.act, _build.stream())
        return sched
    if sched == "wgmma":
        _build.call("matmul_base_wgmma", outd, _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(c.out),
                    c.M, c.K, c.N, bk // BASE_STAGE["wgmma"], c.act,
                    _build.stream())
        return sched
    per_slab = max(1, bk // kc)
    direct = sched == "ffma" and nsplit == 1 and c.out.dtype == torch.float32
    ws = None if direct else torch.empty(nsplit * c.M * c.N,
                                         dtype=torch.float32,
                                         device=c.x.device)
    if sched == "ffma":
        _build.call("matmul_base_ffma", outd, _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(ws),
                    _build.ptr(c.out), c.M, c.K, c.N, kc, nsplit,
                    0 if direct else per_slab, c.act, _build.stream())
    else:
        _build.call("matmul_base_small_m", ind, outd, _build.ptr(c.x),
                    _build.ptr(c.w), _build.ptr(c.bias), _build.ptr(ws),
                    _build.ptr(c.out), c.M, c.K, c.N, kc, nsplit, per_slab,
                    c.act, _build.stream())
    return sched


def matmul_fused(x: torch.Tensor, w: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 w2: Optional[torch.Tensor] = None,
                 act: Optional[str] = None, tile=None,
                 out_dtype: Optional[torch.dtype] = None,
                 vmem_accum: bool = True) -> torch.Tensor:
    """y = epilogue(x @ w [, x @ w2]); x (..., K), w and w2 (K, N), bias
    (N,).  Returns (..., N) in ``out_dtype`` (default ``x.dtype``).
    ``tile`` is the plan's Hopper tile (bm, bk, bn) of the CW schedules
    (module docstring; None takes :data:`HOPPER_TILE`); with
    ``vmem_accum=False`` it is the TPU tile whose K extent sets the base
    variant's slabs, as in JAX."""
    if not vmem_accum and w2 is not None:
        raise ValueError("base (non-CW) kernel does not support the GLU "
                         "epilogue")
    if x.device.type == "cpu":
        return matmul_fused_plain(x, w, bias=bias, w2=w2, act=act,
                                  out_dtype=out_dtype, vmem_accum=vmem_accum,
                                  tile=tile)
    c = _prepare(x, w, bias=bias, w2=w2, act=act, out_dtype=out_dtype)
    lead = x.shape[:-1]
    if not vmem_accum:
        sched = _launch_base(c, _slab_depth(c.K, tile))
        matmul_fused.base_launches += 1
        matmul_fused.base_schedule_launches[sched] += 1
        return c.out.reshape(*lead, c.N)
    glu = w2 is not None
    sched = _schedule(c.M, c.K, c.N, c.x.dtype, glu, _aligned(c))
    block = block_of(sched, glu, tile)
    _LAUNCH[sched](c, *(() if block is None else (block[2],)))
    matmul_fused.launches += 1
    matmul_fused.schedule_launches[sched] += 1
    key = (sched, block)
    matmul_fused.tiles[key] = matmul_fused.tiles.get(key, 0) + 1
    if block is not None and block != block_of(sched, glu):
        matmul_fused.retiled += 1
    return c.out.reshape(*lead, c.N)


matmul_fused.launches = 0
matmul_fused.schedule_launches = dict.fromkeys(SCHEDULES, 0)
matmul_fused.tiles = {}
matmul_fused.retiled = 0
matmul_fused.base_launches = 0
matmul_fused.base_schedule_launches = dict.fromkeys(SCHEDULES, 0)


def matmul_fused_fake(x: torch.Tensor, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      w2: Optional[torch.Tensor] = None,
                      act: Optional[str] = None, tile=None,
                      out_dtype: Optional[torch.dtype] = None,
                      vmem_accum: bool = True) -> torch.Tensor:
    """:func:`matmul_fused`'s shape-only stand-in (the dry-run): the
    (..., N) output, unfilled, and its work counted in
    :data:`repro_torch.kernels._fake.COST`: 2 M K N operations a product
    (two for the GLU pair).  A CW tile none of the kernels takes raises,
    as in the wrapper."""
    from repro_torch.kernels import _fake
    if tile is not None and vmem_accum:
        check_tile(tile)
    K, N = w.shape
    M = x.numel() // K
    out = x.new_empty(tuple(x.shape[:-1]) + (N,),
                      dtype=out_dtype or x.dtype)
    _fake.count("matmul_fused", 2 * M * K * N * (1 if w2 is None else 2),
                _fake.nbytes(x, w, w2, bias, out))
    return out
