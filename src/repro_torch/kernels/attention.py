"""flash_attention — causal, windowed and softcapped GQA attention as
hand-written CUDA kernels for Hopper: three schedules of the same function.

Replaces the Pallas kernel ``flash_attention`` of
``src/repro/kernels/attention.py``: online softmax in fp32 over K/V tiles, so
the (Sq, Skv) score matrix never reaches device memory; head h reads KV head
h // G; masking is positional (key pos >= 0, key pos <= query pos under
``causal``, key pos > query pos - ``window``), the softcap applied before
the mask, and the sum divided by ``max(l, 1e-30)`` at the end.

What bounds it on the H100: at the LM prefill shape (B=8, S=512, H=32,
D=64, causal) the work is ~8.6 GFLOP against ~42 MB of q, k, v and output
in bf16, about 200 operations per byte: below the bf16 ridge (~295), so the
bytes bound it (~13 us).  In fp32 (~84 MB, ~100 operations a byte) the
operations bound it: 67 TFLOP/s outside the tensor cores, ~0.13 ms.

The wrapper picks a schedule with :func:`_schedule`, a pure function of the
dtype and the head width (a dispatch between hand-written kernels, not a
fallback: a build or launch failure raises):

- ``wgmma`` (``csrc/flash_attention_wgmma.cu``): bf16 at head widths 64,
  128 and 256 — every LM prefill and serving prefill batch in bf16.  One
  block per (bq query rows, head, batch row): a producer warp brings the Q
  tile and a ring of 64-key K/V tiles in by TMA; bq / 64 consumer
  warpgroups (two at the default bq of 128) run Q·Kᵀ and P·V on
  ``wgmma`` with fp32 accumulators and keep the online softmax in
  registers.  P is rounded to bf16 before P·V (the Pallas kernel
  keeps it in fp32): about 2⁻⁹ relative on each probability, far inside
  the bf16 tolerance of 2e-2.
- ``ffma`` (``csrc/flash_attention_ffma.cu``): fp32 at head widths 64,
  128 and 256 — every fp32 LM prefill and serving prefill batch.  fp32
  stays off the tensor cores: they would need TF32, which breaks the fp32
  parity of 1e-5 that keeps the fp32 greedy tokens identical to the
  ``reference`` backend's.  Both products are register-tiled FFMA GEMMs:
  one block of 256 threads per (bq query rows, head, batch row), by
  default 64 at D 64 (two blocks an SM) and 256, 128 at D 128
  (:data:`FFMA_TILES`; the other tiles in :data:`FFMA_RING`); Q once and
  64-key
  K and V tiles through a ring of 16-byte ``cp.async`` slots, the next
  tiles in flight while this one's products run; Q·Kᵀ read as float4s
  along D, P through a padded shared tile into P·V; the mask only on the
  tiles that straddle the diagonal, the window's edge or padding; the
  query tiles with the most keys launched first.
- ``simt`` (``csrc/flash_attention.cu``): fp32 and bf16 at head widths 16
  and 32.  It takes no tile: one block of 256 threads per (64 query rows,
  head, batch row);
  each K/V tile staged in shared memory as fp32, the score tile a 16 x 16
  thread grid of 4 x 4 register patches, the row max and sum reduced with
  warp shuffles, P through shared memory into P·V, fp32 FMAs.

Both skip tiles dead in index space (above the causal diagonal, or wholly
outside the window), as the Pallas kernel does, which is exact under its
positions contract (per-row shifted aranges).

The tile: ``wgmma`` and ``ffma`` take their block from the plan's Hopper
tile ``plan.tiles["attention"]`` = ``(bq, bk)``, one of :data:`TILES`
(bk is the 64-key K/V tile; the tiling pass's Hopper target selects it).
By default (``tile=None``, and the tiling pass's selection)
:func:`default_tile`: bq 128 for ``wgmma``, ``FFMA_TILES[D][0]`` for
``ffma``; the base flow's minimal tile is (64, 64).  ``ffma`` takes a tile
only where its working set fits the 227 KiB a block may opt in to
(:data:`FFMA_RING`: not (128, 64) at D 256).  A tile a schedule does not
take raises; it is never replaced by another.

On a CPU tensor the wrapper runs :func:`flash_attention_plain` (which no
tile changes); on a CUDA tensor it launches a kernel or raises.
``flash_attention.launches`` counts the launches,
``flash_attention.schedules`` splits them by schedule,
``flash_attention.tiles`` by (schedule, tile) (None for ``simt``), and
``flash_attention.retiled`` counts those at a tile other than
:func:`default_tile`'s.  It uses no ``scaled_dot_product_attention`` and
no ``torch.matmul`` on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head widths the kernels are built for
TILED_HEAD_DIMS = (64, 128, 256)    # those of the wgmma and ffma schedules
SCHEDULES = ("wgmma", "ffma", "simt")
BK = 64                             # keys a K/V tile, every schedule
TILES = ((64, BK), (128, BK))       # the (bq, bk) tiles wgmma and ffma take
# every (head width, query rows) the ffma kernel takes, as
# csrc/flash_attention_ffma.cu's Cfg: (ring slots, blocks an SM); D 256 at
# 128 rows would need 301,568 shared bytes
FFMA_RING = {(64, 64): (4, 2), (64, 128): (3, 1), (128, 64): (3, 1),
             (128, 128): (3, 1), (256, 64): (2, 1)}
# the ffma schedule's default tile by head width: (query rows a block, keys
# a K/V tile, ring slots, blocks an SM)
FFMA_TILES = {D: (bq, BK, *FFMA_RING[(D, bq)])
              for D, bq in ((64, 64), (128, 128), (256, 64))}


def _schedule(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs a call: at the head widths of
    :data:`TILED_HEAD_DIMS` ``wgmma`` for bf16 and ``ffma`` for fp32 (full
    fp32), ``simt`` for the rest."""
    if D not in TILED_HEAD_DIMS:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "ffma"


def default_tile(dtype: torch.dtype, D: int):
    """The (bq, bk) tile a call takes without one, and the tiling pass's
    selection: bq 128 in bf16 (``wgmma``'s two consumer warpgroups),
    ``FFMA_TILES[D][0]`` in fp32; (64, 64) at the ``simt`` widths (its
    fixed block, which it takes without a tile)."""
    if D not in TILED_HEAD_DIMS:
        return (64, BK)
    return (128 if dtype == torch.bfloat16 else FFMA_TILES[D][0], BK)


def check_tile(tile) -> tuple:
    """``tile`` as a tuple of ints, one of :data:`TILES`; raises
    ``ValueError`` for any other."""
    t = tuple(int(v) for v in tile)
    if t not in TILES:
        raise ValueError(f"flash_attention: no kernel takes the tile {t}; "
                         f"the tiles are {TILES}")
    return t


def block_of(sched: str, D: int, dtype: torch.dtype, tile=None):
    """The (bq, bk) block a call on ``sched`` runs at head width D: the
    tile given (:func:`check_tile`), or :func:`default_tile`'s; None for
    ``simt``, which takes no tile.  Raises ``ValueError`` for a tile the
    schedule does not take (``ffma`` at a (D, bq) outside
    :data:`FFMA_RING`)."""
    t = default_tile(dtype, D) if tile is None else check_tile(tile)
    if sched == "simt":
        return None
    if sched == "ffma" and (D, t[0]) not in FFMA_RING:
        raise ValueError(f"flash_attention: the ffma kernel takes no tile "
                         f"{t} at head width {D} (its working set exceeds "
                         "the 232,448 shared bytes a block may opt in to)")
    return t


def _ffma_smem_bytes(D: int, bq: Optional[int] = None) -> int:
    """The ffma kernel's dynamic shared bytes at head width D and ``bq``
    query rows a block (by default ``FFMA_TILES[D][0]``): the Q tile, the
    ring's slots (a K or V tile and the K tile's key positions) and the P
    tile, rows padded by 4 floats.  A (D, bq) outside :data:`FFMA_RING`
    counts its ring at 2 slots, the fewest the kernel could run."""
    bq = FFMA_TILES[D][0] if bq is None else bq
    slots = FFMA_RING.get((D, bq), (2, 1))[0]
    ld = D + 4
    return 4 * (bq * ld + slots * (BK * ld + BK) + bq * (BK + 4))


def _ffma_blocks(B: int, Sq: int, H: int, D: int,
                 bq: Optional[int] = None):
    """The ffma kernel's blocks in launch order at ``bq`` query rows a block
    (by default ``FFMA_TILES[D][0]``), (query tile, head, batch row) for
    block i = 0, 1, ...: the query tile varies slowest and runs from the
    last (under causal the tiles with the most keys go first), the heads of
    a KV head side by side."""
    bq = FFMA_TILES[D][0] if bq is None else bq
    nq, per = -(-Sq // bq), H * B
    return [(nq - 1 - i // per, (i % per) % H, (i % per) // H)
            for i in range(nq * per)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the rule of TMA and
    of 16-byte ``cp.async``): a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
    ``tile`` is the plan's Hopper tile (bq, bk) (module docstring); None
    takes :func:`default_tile`'s."""
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
    sched = _schedule(q.dtype, D)
    block = block_of(sched, D, q.dtype, tile)
    if positions is not None:
        qp = kp = positions.to(torch.int32).contiguous()
    elif sched != "simt":
        qp = kp = None                  # the kernel takes the indices
    else:
        qp = (torch.arange(Sq, dtype=torch.int32, device=q.device)
              + q_offset).expand(B, Sq).contiguous()
        kp = torch.arange(Skv, dtype=torch.int32,
                          device=q.device).expand(B, Skv).contiguous()
    qc, kc, vc = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(qc)
    ptrs = [_build.ptr(t) for t in (qc, kc, vc, qp, kp, out)]
    rest = [B, Sq, Skv, H, KV, D, int(causal), int(window or 0),
            float(softcap or 0.0), int(q_offset), _build.stream()]
    if sched == "simt":
        _build.call("flash_attention", _build.DTYPE_CODES[q.dtype], *ptrs,
                    *rest)
    else:
        _build.call(f"flash_attention_{sched}", *ptrs, *rest[:-1], block[0],
                    rest[-1])
    flash_attention.launches += 1
    flash_attention.schedules[sched] += 1
    key = (sched, block)
    flash_attention.tiles[key] = flash_attention.tiles.get(key, 0) + 1
    if block is not None and block != default_tile(q.dtype, D):
        flash_attention.retiled += 1
    return out


flash_attention.launches = 0
flash_attention.schedules = dict.fromkeys(SCHEDULES, 0)
flash_attention.tiles = {}
flash_attention.retiled = 0


def flash_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, positions: Optional[torch.Tensor] = None,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, q_offset: int = 0,
                         tile=None) -> torch.Tensor:
    """:func:`flash_attention`'s shape-only stand-in (the dry-run): the
    output, unfilled, and 4 D operations a (query head, key) pair it
    scores (Q·Kᵀ and P·V), the pairs the causal mask and the window leave
    (``positions`` are taken as each row's arange: their values are not
    known).  A tile none of the kernels takes raises, as in the wrapper."""
    from repro_torch.kernels import _fake
    if tile is not None:
        check_tile(tile)
    B, Sq, H, D = q.shape
    pairs = _fake.attended(Sq, k.shape[1], causal, window, q_offset)
    out = torch.empty_like(q)
    _fake.count("flash_attention", 4 * B * H * D * pairs,
                _fake.nbytes(q, k, v, positions, out))
    return out
