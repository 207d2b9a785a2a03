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


def run(cfg, shape, flow) -> Dict[str, object]:
    """Produce the plan's tile table.  With ``tile_select`` off (the paper's
    base configuration) everything falls back to minimal 128 tiles — the
    analogue of the unparallelized base kernels.  ``flow.tile_overrides``
    (tuned per-kernel schedules) are applied on top in both modes."""
    vmem = flow.vmem_budget_bytes // 4   # conservative per-kernel allowance
    tiles: Dict[str, object] = {}
    if not flow.tile_select:
        tiles["matmul"] = (128, 128, 128)
        tiles["attention"] = (128, 128)
        tiles["decode_attention"] = 512
        tiles["conv2d"] = (8, 128)
        tiles["wkv_chunk"] = 16
        tiles["ce_chunk"] = flow.ce_chunk
        apply_overrides(tiles, flow)
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
    apply_overrides(tiles, flow)
    return tiles


class TilingPass(Pass):
    name = "tiling"
    paper = "LU/LT §IV-A/B/J"
    reads = ("graph",)
    writes = ("tiles",)

    def run(self, ctx: PlanContext) -> None:
        tiles = run(ctx.cfg, ctx.shape, ctx.flow)
        ctx.artifacts["tiles"] = tiles
        stats = {"applied": True, "selected": ctx.flow.tile_select,
                 "tiles": dict(tiles)}
        bm, bk, bn = tiles["matmul"]
        stats["matmul_workingset_bytes"] = (bm * bk + bk * bn) * 2 + bm * bn * 6
        ctx.stats[self.name] = stats

    def tunable_space(self, cfg, flow, shape):
        space = {"tile_select": (True, False),
                 "vmem_budget_bytes": flow.tuning.vmem_candidates}
        if shape.kind == "train":
            space["ce_chunk"] = flow.tuning.ce_chunk_candidates
        return space
