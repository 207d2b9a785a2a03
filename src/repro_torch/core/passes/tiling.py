"""LU/LT — unroll / strip-mine / tile selection (paper §IV-A/B/J).

On the FPGA the unroll factor widened LSUs and replicated DSPs, bounded by
(1) the memory-bandwidth roof, (2) even division of loop counts, and (3) the
resource budget.  On the TPU the same three rules pick Pallas ``BlockSpec``
block shapes:

1. *MXU alignment* — matmul tile dims are multiples of 128 (the systolic
   array edge), elementwise tiles multiples of (8, 128) (VPU lanes).
2. *even division* — block dims divide the (padded) problem dims, so no
   prologue/epilogue grid steps are generated.
3. *VMEM budget* — the working set (x-tile + w-tile + fp32 accumulator +
   epilogue operands) must fit the per-core VMEM allowance.

The selector maximizes arithmetic intensity (prefer large N,M tiles; deep K
streaming) subject to those constraints — the analogue of "unroll as wide as
the bandwidth roof allows".

A plan for the CPU (``platform == "cpu"``) keeps that table exactly (the
JAX package's, key for key).  A plan for the card (``"cuda"``) takes the
Hopper target (:func:`hopper_tiles`) for the three keys whose hand kernels
take a block, the rest as the TPU table writes them:

=========  ===============  ===================  =======================
key        Hopper tile      selected (default)   base flow (tile_select
                                                 off: minimal)
=========  ===============  ===================  =======================
matmul     (128, 64, bn)    bn 128               bn 64
attention  (bq, 64)         bf16: bq 128; fp32:  (64, 64)
                            64 / 128 / 64 at
                            head width 64 / 128
                            / 256
conv2d     (128, bn)        bn 128               bn 64
=========  ===============  ===================  =======================

Read by: matmul the ``wgmma`` and ``ffma`` schedules of ``matmul_fused``
(128 rows x bn columns in 64-deep stages; the GLU form runs bn 64 under
either tile); attention ``flash_attention``'s ``wgmma`` (bq / 64 consumer
warpgroups) and ``ffma`` (bq query rows a block) over 64-key K/V tiles;
conv2d ``conv2d_fused``'s ``wgmma`` and ``ffma`` (128 pixels x bn
channels; a conv of 64 channels runs bn 64 under either tile).  The
selected table is the block each kernel took before it took a tile, so a
default flow launches what it launched then; only the base flow, an
override or tuning changes a block.  The same three rules hold on the
card: 1. the blocks are multiples of 64 (a ``wgmma`` row group, a
128-byte swizzle row of bf16); 2. no even division is needed (the kernels
mask their edges); 3. a kernel's shared-memory allowance is
``min(227 KiB, vmem_budget_bytes // 4)`` (the same ``// 4`` as the TPU's)
and the selector shrinks a tile until its working set (the shared bytes a
block asks for, :mod:`repro_torch.kernels.workingset`) fits it: at the
flow's 96 / 48 MiB candidates the allowance never binds.  ``decode_attention``
is the TPU table's entry: the decode kernels split the cache by the card's
SM count and take no tile (nor do the paged kernel, ``copy_block`` and
``lru_scan``); ``wkv_chunk`` and ``ce_chunk`` are read by the op layer
as on the TPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.passmanager import Pass, PlanContext


def _fit(n: int, target: int, align: int) -> int:
    """Largest multiple of ``align`` that divides n and is <= target; when no
    aligned divisor exists, the largest divisor of n <= target (rule 2: even
    division — no prologue/epilogue grid steps).  n itself is returned when
    n < align (kernel pads internally)."""
    if n <= align:
        return n
    t = min(target, n)
    for cand in range(t - t % align, 0, -align):
        if n % cand == 0:
            return cand
    for cand in range(t, 0, -1):
        if n % cand == 0:
            return cand
    return n


def select_matmul_tile(m: int, k: int, n: int, *, vmem: int,
                       bytes_in: int = 2) -> Tuple[int, int, int]:
    """(bm, bk, bn) for the fused-matmul kernel."""
    bm = _fit(m, 512, 128) if m >= 128 else m
    bn = _fit(n, 512, 128)
    bk = _fit(k, 2048, 128)
    # shrink until x(bm,bk) + w(bk,bn) + acc(bm,bn)*4 + out fits
    def ws(bm, bk, bn):
        return (bm * bk + bk * bn) * bytes_in + bm * bn * (4 + bytes_in)
    order = ["bk", "bn", "bm"]
    vals = {"bm": bm, "bk": bk, "bn": bn}
    oi = 0
    while ws(vals["bm"], vals["bk"], vals["bn"]) > vmem and oi < 64:
        dim = order[oi % 3]
        if vals[dim] > 128:
            vals[dim] = _fit(vals[dim] // 2 * 2, vals[dim] // 2, 128)
        oi += 1
    return vals["bm"], vals["bk"], vals["bn"]


def select_attention_tile(seq_q: int, seq_k: int, head_dim: int, *,
                          vmem: int) -> Tuple[int, int]:
    """(block_q, block_k) for the flash-attention kernel."""
    bq = _fit(seq_q, 512, 128) if seq_q >= 128 else seq_q
    bk = _fit(seq_k, 1024, 128) if seq_k >= 128 else seq_k
    def ws(bq, bk):
        # q, k, v tiles + fp32 scores + fp32 acc
        return (bq + 2 * bk) * head_dim * 2 + bq * bk * 4 + bq * head_dim * 4
    while ws(bq, bk) > vmem and (bq > 128 or bk > 128):
        if bk >= bq and bk > 128:
            bk = _fit(seq_k, bk // 2, 128)
        elif bq > 128:
            bq = _fit(seq_q, bq // 2, 128)
        else:
            break
    return bq, bk


#: Every key the tile table may carry — the valid targets of
#: ``FlowConfig.tile_overrides`` (the flow-knob screen rejects others).
TILE_KEYS = ("matmul", "attention", "decode_attention", "conv2d",
             "wkv_chunk", "ce_chunk")


def apply_overrides(tiles: Dict[str, object], flow) -> Dict[str, str]:
    """Apply ``flow.tile_overrides`` on top of the selector's tile table
    (in place).  Overrides are the per-kernel tunables the tunedb records
    and the serving autotune's tile microbench pins; an override for a key
    this cell does not produce (e.g. ``attention`` on a pure CNN) is
    ignored rather than invented — the kernel it targets never runs here.
    Returns the applied subset for the pass stats."""
    applied: Dict[str, str] = {}
    for key, tile in (flow.tile_overrides or ()):
        if key in tiles:
            tiles[key] = tuple(tile) if isinstance(tile, (list, tuple)) \
                else tile
            applied[key] = str(tiles[key])
    return applied


#: the shared bytes a block of an H100 may opt in to (227 KiB)
BLOCK_SHARED = 232448


def hopper_allowance(flow) -> int:
    """A hand kernel's shared-memory allowance: ``min(227 KiB,
    vmem_budget_bytes // 4)``, the TPU's per-kernel share of the budget."""
    return min(BLOCK_SHARED, flow.vmem_budget_bytes // 4)


def compute_dtype(flow):
    """The kernels' operand dtype under ``flow``: fp32 when its precision
    is fp32, bf16 otherwise (and without a flow)."""
    import torch
    return torch.float32 if flow is not None and flow.precision == "fp32" \
        else torch.bfloat16


def hopper_workingset(key: str, tile, cfg, flow) -> int:
    """The shared bytes a block of ``key``'s tiled schedule asks for at
    ``tile`` in the flow's precision (``wgmma`` in bf16, ``ffma`` in fp32):
    the plain product's form for matmul, a conv of 128 output channels,
    flash at the model's head width (0 for a model without one)."""
    import torch
    from repro_torch.kernels import workingset as ws
    dt = compute_dtype(flow)
    if key == "matmul":
        return ws.matmul(4096, 4096, 4096, dt, False, tile=tile)[1]
    if key == "conv2d":
        return ws.conv2d(3, 3, 64 if dt == torch.bfloat16 else 4, 128, 1,
                         dt, tile=tile)[1]
    if cfg.attention is None:
        return 0
    return ws.flash_attention(cfg.attention.head_dim, dt, tile=tile)[1]


def hopper_tiles(cfg, flow) -> Dict[str, Tuple[int, ...]]:
    """The Hopper target's matmul, attention and conv2d tiles (module
    docstring): with ``tile_select`` the blocks the kernels take by
    default, each shrunk to its minimal tile when its working set exceeds
    :func:`hopper_allowance`; without, the minimal tiles."""
    from repro_torch.kernels import attention, conv2d, matmul_fused
    dt = compute_dtype(flow)
    hd = cfg.attention.head_dim if cfg.attention is not None else 0
    minimal = {"matmul": matmul_fused.TILES[0], "attention": attention.TILES[0],
               "conv2d": conv2d.TILES[0]}
    if not flow.tile_select:
        return minimal
    out = {"matmul": matmul_fused.HOPPER_TILE,
           "attention": attention.default_tile(dt, hd),
           "conv2d": conv2d.DEFAULT_TILE}
    allowance = hopper_allowance(flow)
    for key, tile in out.items():
        if hopper_workingset(key, tile, cfg, flow) > allowance:
            out[key] = minimal[key]
    return out


def run(cfg, shape, flow, platform: str = "cpu") -> Dict[str, object]:
    """Produce the plan's tile table.  With ``tile_select`` off (the paper's
    base configuration) everything falls back to minimal 128 tiles — the
    analogue of the unparallelized base kernels.  On ``platform`` "cuda"
    the matmul, attention and conv2d entries are the Hopper target's
    (:func:`hopper_tiles`).  ``flow.tile_overrides`` (tuned per-kernel
    schedules) are applied on top in both modes."""
    tiles = _tpu_table(cfg, shape, flow)
    if platform == "cuda":
        for key, tile in hopper_tiles(cfg, flow).items():
            if key in tiles:
                tiles[key] = tile
    apply_overrides(tiles, flow)
    return tiles


def _tpu_table(cfg, shape, flow) -> Dict[str, object]:
    """The JAX package's tile table, before the overrides."""
    vmem = flow.vmem_budget_bytes // 4   # conservative per-kernel allowance
    tiles: Dict[str, object] = {}
    if not flow.tile_select:
        tiles["matmul"] = (128, 128, 128)
        tiles["attention"] = (128, 128)
        tiles["decode_attention"] = 512
        tiles["conv2d"] = (8, 128)
        tiles["wkv_chunk"] = 16
        tiles["ce_chunk"] = flow.ce_chunk
        return tiles
    d, f = cfg.d_model, cfg.d_ff
    seq = shape.seq_len if shape.kind != "decode" else 1
    m = max(seq, 8)
    tiles["matmul"] = select_matmul_tile(m, d, f, vmem=vmem)
    if cfg.attention is not None:
        skv = shape.seq_len
        tiles["attention"] = select_attention_tile(
            max(seq, 8), skv, cfg.attention.head_dim, vmem=vmem)
        tiles["decode_attention"] = max(512, _fit(skv, 2048, 512))
    tiles["conv2d"] = (8, 128)
    tiles["wkv_chunk"] = 32
    tiles["ce_chunk"] = flow.ce_chunk
    return tiles


class TilingPass(Pass):
    name = "tiling"
    paper = "LU/LT §IV-A/B/J"
    reads = ("graph",)
    writes = ("tiles",)

    def run(self, ctx: PlanContext) -> None:
        tiles = run(ctx.cfg, ctx.shape, ctx.flow, ctx.platform)
        ctx.artifacts["tiles"] = tiles
        stats = {"applied": True, "selected": ctx.flow.tile_select,
                 "tiles": dict(tiles)}
        if ctx.platform == "cuda":
            # the shared bytes a block of the product's kernel asks for
            # (None for a tile no kernel takes: the verifier's X002)
            try:
                stats["matmul_workingset_bytes"] = hopper_workingset(
                    "matmul", tiles["matmul"], ctx.cfg, ctx.flow)
            except ValueError:
                stats["matmul_workingset_bytes"] = None
        else:
            bm, bk, bn = tiles["matmul"]
            stats["matmul_workingset_bytes"] = \
                (bm * bk + bk * bn) * 2 + bm * bn * 6
        ctx.stats[self.name] = stats

    def tunable_space(self, cfg, flow, shape):
        space = {"tile_select": (True, False),
                 "vmem_budget_bytes": flow.tuning.vmem_candidates}
        if shape.kind == "train":
            space["ce_chunk"] = flow.tuning.ce_chunk_candidates
        return space
