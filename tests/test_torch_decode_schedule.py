"""The split-KV decode core's policies and numerics, on the CPU.

``decode_attention`` and ``paged_decode_attention`` run on the card as the
``mma`` (bf16) or ``ffma`` (fp32) schedule of ``csrc/decode_core.cuh`` at
head widths 64, 128 and 256, and as ``simt`` at 16 and 32.  Here, with no
card:

* ``_schedule`` at every main-path shape;
* the split policies (``splits``, ``paged_splits`` and the kernel's cut of
  the live range) at every shape ``chip_smoke.py`` runs, against their
  rules: whole 16-slot tiles, a workspace under a quarter of the K/V bytes
  a block reads, a combine that reads no more than a block's K/V, one wave
  of the card and no more;
* a plain-torch model of the kernels' arithmetic (the scale after Q·Kᵀ, P
  as bf16 hi + lo in P·V, 16-slot tiles taken by the warps in turn, each
  warp's online softmax, the warps merged in warp order, the splits
  combined in split order) against the JAX package's Pallas kernels in
  interpret mode, on seeded numpy inputs, fp32 within 1e-5 (the same
  arithmetic in another order; the hi + lo split keeps ~16 bits of p);
* the one difference the kernels keep: a row none of whose slots is valid
  gets zeros, where the plain versions give the mean of V and the Pallas
  kernel sum(V[:C]) / rup(C, bk).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as tdec

N_SM = 132
NEG = -1e30
BF16, FP32 = torch.bfloat16, torch.float32

# ---------------------------------------------------------------------------
# _schedule
# ---------------------------------------------------------------------------

# (name, D, G, Sq): the main path's heads, and the smoke widths
SHAPES = [("llama", 64, 4, 1), ("llama_verify", 64, 4, 5),
          ("recurrentgemma", 256, 10, 1), ("qwen_kernel_case", 128, 1, 1),
          ("phi4", 128, 3, 1), ("stablelm", 64, 1, 1),
          ("smoke16", 16, 2, 1), ("smoke32", 32, 4, 5)]


@pytest.mark.parametrize("name,D,G,Sq", SHAPES)
def test_schedule_at_main_path_shapes(name, D, G, Sq):
    """mma in bf16, ffma in fp32 at head widths 64-256, simt at 16 and 32;
    the query rows (G, Sq) do not enter the choice."""
    want = ("mma", "ffma") if D >= 64 else ("simt", "simt")
    assert (tdec._schedule(BF16, D), tdec._schedule(FP32, D)) == want
    assert set(tdec.SCHEDULES) == {"mma", "ffma", "simt"}


def test_fit_follows_shared_memory():
    """Blocks an SM holds at each width (the one-wave rule's unit): the
    mma schedule 3 / 2 / 1 at D 64 / 128 / 256, the ffma one 2 / 2 / 1."""
    got = {(dt, D): tdec._fit(dt, D, 0) for dt in (BF16, FP32)
           for D in (64, 128, 256)}
    assert got == {(BF16, 64): 3, (BF16, 128): 2, (BF16, 256): 1,
                   (FP32, 64): 2, (FP32, 128): 2, (FP32, 256): 1}
    for dt, D in got:
        assert tdec._core_smem(dt, D, 0) + 1024 <= tdec.SM_SHARED


# ---------------------------------------------------------------------------
# split policies
# ---------------------------------------------------------------------------

def _rules(C, chunk, nsplit, pairs, rows, D, dt, fit):
    """The rules of item 5 for a split of ``chunk`` slots of ``C``."""
    elem = dt.itemsize
    kv = chunk * 2 * D * elem                    # K/V bytes a block reads
    assert chunk % tdec.TILE == 0 and chunk <= tdec.MAX_CHUNK
    assert 1 <= nsplit <= tdec.MAX_SPLITS
    assert (nsplit - 1) * chunk < C <= nsplit * chunk
    # the workspace stays under a quarter of the K/V bytes a block reads
    assert rows * (D + 2) * 4 <= kv / 4
    # the last block's combine reads no more than a block's K/V (up to the
    # rounding of a split to whole tiles)
    assert nsplit * rows * (D + 2) * 4 <= kv * (1 + tdec.TILE / chunk)
    # one wave of the card, no more
    assert nsplit == 1 or nsplit * pairs <= fit * N_SM


# (name, B, C, KV, G, D): the rolling caches chip_smoke.py runs (the
# qwen1.5-4b generate's is qwen_kernel_case; phi4-mini-3.8b's a group of 3,
# stablelm-1.6b's a group of 1 at head width 64 over 32 KV heads,
# whisper-small's over 12 KV heads in its 448-slot cache)
ROLLING = [("llama_generate", 8, 1024, 8, 4, 64),
           ("whisper_generate", 8, 448, 12, 1, 64),
           ("rg_generate", 8, 1024, 1, 10, 256),
           ("rg_window", 1, 2048, 1, 10, 256),
           ("qwen_kernel_case", 8, 1024, 20, 1, 128),
           ("phi4_generate", 8, 1024, 8, 3, 128),
           ("stablelm_generate", 8, 1024, 32, 1, 64)]


@pytest.mark.parametrize("dt", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,B,C,KV,G,D", ROLLING)
def test_rolling_splits_at_smoke_shapes(name, B, C, KV, G, D, dt):
    nsplit, chunk = tdec.splits(B, C, KV, G, D, dt, N_SM)
    rows, pairs = min(G, tdec.ROWS), B * KV * -(-G // tdec.ROWS)
    fit = tdec._fit(dt, D, chunk)
    _rules(C, chunk, nsplit, pairs, rows, D, dt, fit)
    # the most splits the rules allow: a tile less breaks one of them
    elem = dt.itemsize
    least = max(tdec.min_chunk(rows, D, elem),
                tdec.combine_chunk(C, rows, D, elem))
    smaller = chunk - tdec.TILE
    assert smaller < least or -(-C // smaller) * pairs > fit * N_SM
    # every SM gets a block unless the workspace or combine rule binds
    assert nsplit * pairs >= N_SM or chunk == least or nsplit == 1 \
        or -(-C // (chunk - tdec.TILE)) * pairs > fit * N_SM


def _live_splits(live, nsplit, mc, cfac):
    """The kernel's cut of a row's ``live`` tokens (``PagedMap::finish`` of
    csrc/decode_core.cuh): (tokens a split, splits that hold any)."""
    per = max(-(-live // nsplit), math.ceil(math.sqrt(live * cfac)))
    per = max(mc, -(-per // tdec.TILE) * tdec.TILE)
    return per, -(-live // per)


# (name, B, Sq, KV, G, D, nblk, bs, live tokens a row): the pools
# chip_smoke.py runs (serving A-D's tick and verify rows, workload R, the
# ticks of qwen1.5-4b's, phi4-mini-3.8b's and stablelm-1.6b's workload A)
PAGED = [("serving_tick", 8, 1, 8, 4, 64, 64, 16, 534),
         ("serving_verify", 8, 5, 8, 4, 64, 64, 16, 538),
         ("rg_workload_r", 8, 1, 1, 10, 256, 64, 16, 296),
         ("qwen_kernel_case", 8, 1, 20, 1, 128, 64, 16, 534),
         ("phi4_tick", 8, 1, 8, 3, 128, 64, 16, 543),
         ("stablelm_tick", 8, 1, 32, 1, 64, 64, 16, 543)]


@pytest.mark.parametrize("dt", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,B,Sq,KV,G,D,nblk,bs,live", PAGED)
def test_paged_splits_at_smoke_shapes(name, B, Sq, KV, G, D, nblk, bs, live,
                                      dt):
    R = Sq * G
    rows, pairs = min(R, tdec.ROWS), B * KV * -(-R // tdec.ROWS)
    elem = dt.itemsize
    nsplit = tdec.paged_splits(B, KV, R, nblk, bs, D, dt, N_SM)
    extra = tdec._table_entries(nblk, bs) + Sq
    fit = tdec._fit(dt, D, extra)
    assert tdec._table_entries(nblk, bs) == nblk        # loaded whole
    # the rules at full capacity, then at this run's live tokens
    cap = nblk * bs
    mc, cfac = tdec.min_chunk(rows, D, elem), tdec._cfac(rows, D, elem)
    per, used = _live_splits(cap, nsplit, mc, cfac)
    _rules(cap, per, used, pairs, rows, D, dt, fit)
    per, used = _live_splits(live, nsplit, mc, cfac)
    assert used <= nsplit and per % tdec.TILE == 0
    _rules(live, per, used, pairs, rows, D, dt, fit)


@pytest.mark.parametrize("nblk,bs,want", [
    (64, 16, 64),           # the serving pool: the whole row, at once
    (1024, 16, 1024),
    (1100, 4, 514),         # a longer row: the slice one split covers
    (4096, 16, 130),
])
def test_table_entries(nblk, bs, want):
    """The table entries a paged block loads: the whole row up to
    TABLE_WHOLE entries, else enough for one split of MAX_CHUNK tokens."""
    assert tdec._table_entries(nblk, bs) == want


def test_splits_refuse_what_the_kernels_cannot_cut():
    with pytest.raises(ValueError, match="splits"):
        tdec.splits(1, tdec.MAX_SPLITS * tdec.MAX_CHUNK + 16, 1, 4, 64, BF16,
                    N_SM)
    with pytest.raises(ValueError, match="splits"):
        tdec.paged_splits(1, 1, 4, tdec.MAX_SPLITS * tdec.MAX_CHUNK // 8 + 8,
                          8, 64, BF16, N_SM)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, modelled in plain torch
# ---------------------------------------------------------------------------

def _valid(key, qv, window):
    ok = (key[None, :] >= 0) & (key[None, :] <= qv[:, None])
    if window:
        ok &= key[None, :] > qv[:, None] - window
    return ok


def core_model(q, k, v, key, qv, *, window, softcap, chunk, NS=16, W=4,
               split_p=True):
    """One (batch row, KV head, row tile) as the core computes it.

    q (R, D) fp32; k, v (n, D) fp32: the slots in order; key (n,) int: each
    slot's key (its position, or its token; -1 none); qv (R,) int: the
    rows' query positions.  Splits of ``chunk`` slots; in each, 16-slot
    tiles taken by W warps in turn, each warp an online softmax (scale
    after Q·Kᵀ; P·V with P as bf16 hi + lo when ``split_p``); the warps
    merged in warp order, the splits in split order.  Returns (R, D)."""
    R, D = q.shape
    n = k.shape[0]
    scale = D ** -0.5
    parts = []
    for s0 in range(0, n, chunk):
        warps = []
        tiles = list(range(s0, min(n, s0 + chunk), NS))
        for w in range(W):
            m = torch.full((R,), NEG)
            l = torch.zeros(R)
            acc = torch.zeros(R, D)
            for t0 in tiles[w::W]:
                sl = slice(t0, min(t0 + NS, s0 + chunk, n))
                s = (q @ k[sl].T) * scale
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                ok = _valid(key[sl], qv, window)
                s = torch.where(ok, s, torch.full_like(s, NEG))
                mn = torch.maximum(m, s.max(1).values)
                alpha = torch.exp(m - mn)
                p = torch.where(ok, torch.exp(s - mn[:, None]),
                                torch.zeros_like(s))
                if split_p:
                    hi = p.to(BF16).float()
                    p_pv = hi + (p - hi).to(BF16).float()
                else:
                    p_pv = p
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + p_pv @ v[sl]
                m = mn
            warps.append((m, l, acc))
        M = torch.stack([w[0] for w in warps]).max(0).values
        e = [torch.exp(w[0] - M) for w in warps]
        parts.append((M, sum(w[1] * x for w, x in zip(warps, e)),
                      sum(w[2] * x[:, None] for w, x in zip(warps, e))))
    M = torch.stack([p[0] for p in parts]).max(0).values
    e = [torch.exp(p[0] - M) for p in parts]
    L = sum(p[1] * x for p, x in zip(parts, e))
    A = sum(p[2] * x[:, None] for p, x in zip(parts, e))
    return A / torch.clamp(L, min=1e-30)[:, None]


def _bf16_values(rng, *shape):
    """Seeded normals rounded to bf16 (the mma schedule's inputs), kept in
    fp32 so both sides compute from the same numbers."""
    a = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return a.to(BF16).float().numpy()


def rolling_model(q, kc, vc, pos, qpos, *, window, softcap, chunk, **kw):
    B, _, H, D = q.shape
    KV = kc.shape[2]
    G = H // KV
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        for h in range(KV):
            out[b, 0, h * G:(h + 1) * G] = core_model(
                q[b, 0, h * G:(h + 1) * G], kc[b, :, h], vc[b, :, h], pos[b],
                qpos[b].expand(G), window=window, softcap=softcap,
                chunk=chunk, **kw)
    return out


# (name, B, C, H, KV, D, filled, qpos, window, softcap): a half-filled
# cache, a wrapped cache with a window that cuts, empty slots at both ends
ROLL_CASES = {
    "half_gqa": (2, 96, 8, 2, 64, 48, 47, None, None),
    "wrapped_window_softcap": (1, 64, 4, 1, 32, 64, 100, 40, 30.0),
    "empty_ends": (2, 80, 4, 2, 16, 80, 79, None, None),
    "group3": (2, 64, 6, 2, 64, 64, 63, None, None),
}


def _roll_inputs(name, seed):
    B, C, H, KV, D, filled, qp, win, cap = ROLL_CASES[name]
    rng = np.random.RandomState(seed)
    q = _bf16_values(rng, B, 1, H, D)
    kc, vc = _bf16_values(rng, B, C, KV, D), _bf16_values(rng, B, C, KV, D)
    lo = max(0, qp - C + 1)
    slot = lo + (np.arange(C) - lo) % C              # position in slot c
    pos = np.where((slot <= qp) & (np.arange(C) < filled), slot, -1)
    if name == "empty_ends":
        pos[:20] = -1
        pos[-20:] = -1
    pos = np.broadcast_to(pos, (B, C)).astype(np.int32).copy()
    qpos = np.full((B, 1), qp, np.int32)
    return (q, kc, vc, pos, qpos), dict(window=win, softcap=cap)


@pytest.mark.parametrize("split_p", [True, False], ids=["mma", "ffma"])
@pytest.mark.parametrize("chunk", [16, 48])
@pytest.mark.parametrize("name", sorted(ROLL_CASES))
def test_model_matches_pallas_decode(name, chunk, split_p):
    """The core's arithmetic against the Pallas kernel in interpret mode,
    fp32 within 1e-5, at one split and at several."""
    arrs, kw = _roll_inputs(name, seed=7)
    pal = jops.decode_attention(*(jnp.asarray(a) for a in arrs), tile=32,
                                interpret=True, **kw)
    y = rolling_model(*(torch.from_numpy(a) for a in arrs), chunk=chunk,
                      split_p=split_p, **kw)
    assert relerr(y.numpy(), pal) < 1e-5


def _paged_inputs(seed, B, Sq, H, KV, D, bs, nblk, lens, pad):
    rng = np.random.RandomState(seed)
    NB = 1 + B * nblk
    q = _bf16_values(rng, B, Sq, H, D)
    kp, vp = _bf16_values(rng, NB, bs, KV, D), _bf16_values(rng, NB, bs, KV,
                                                            D)
    bt = (1 + rng.permutation(B * nblk).reshape(B, nblk)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    qpos = (lens[:, None] + np.arange(Sq, dtype=np.int32)[None]).astype(
        np.int32)
    if pad:
        qpos[-1, Sq // 2:] = -1
    return q, kp, vp, bt, lens, qpos


def paged_model(q, kp, vp, bt, qpos, *, window, softcap, nsplit, mc, cfac,
                **kw):
    """The pool through the core: each row's live tokens (lo .. max(qpos),
    none older than the youngest row's window) cut as the kernel cuts them,
    the rows of a KV head in (token, head) order."""
    B, Sq, H, D = q.shape
    bs, KV = kp.shape[1], kp.shape[2]
    G = H // KV
    out = torch.zeros(B, Sq, H, D)
    for b in range(B):
        qb = qpos[b]
        hi = min(int(qb.max()) + 1, bt.shape[1] * bs)
        valid = qb[qb >= 0]
        lo = max(0, int(valid.min()) - window + 1) if window and hi > 0 \
            else 0
        live = max(0, hi - lo)
        per, _ = _live_splits(live, nsplit, mc, cfac) if live else (16, 0)
        t = torch.arange(lo, hi)
        blk = bt[b, (t // bs).long()].long()
        for h in range(KV):
            k = kp[blk, t % bs, h]
            v = vp[blk, t % bs, h]
            rows = q[b, :, h * G:(h + 1) * G].reshape(Sq * G, D)
            qv = qb.repeat_interleave(G)
            o = core_model(rows, k, v, t.int(), qv, window=window,
                           softcap=softcap, chunk=per, **kw)
            out[b, :, h * G:(h + 1) * G] = o.reshape(Sq, G, D)
    return out


# (name, B, Sq, H, KV, D, bs, nblk, lens, window, softcap, padded rows)
PAGED_CASES = {
    "tick_bs16": (2, 1, 8, 2, 64, 16, 6, [37, 90], None, None, False),
    "verify_bs8_window": (2, 5, 4, 1, 32, 8, 8, [20, 50], 24, 30.0, True),
    "tick_group3": (2, 1, 6, 2, 64, 16, 6, [37, 90], None, None, False),
}


@pytest.mark.parametrize("split_p", [True, False], ids=["mma", "ffma"])
@pytest.mark.parametrize("nsplit", [1, 3])
@pytest.mark.parametrize("name", sorted(PAGED_CASES))
def test_model_matches_pallas_paged(name, nsplit, split_p):
    B, Sq, H, KV, D, bs, nblk, lens, win, cap, pad = PAGED_CASES[name]
    q, kp, vp, bt, lens_a, qpos = _paged_inputs(11, B, Sq, H, KV, D, bs,
                                                nblk, lens, pad)
    pal = jops.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, lens_a)),
        qpos=jnp.asarray(qpos) if Sq > 1 else None, window=win, softcap=cap,
        interpret=True)
    rows = min(Sq * (H // KV), tdec.ROWS)
    y = paged_model(*(torch.from_numpy(a) for a in (q, kp, vp, bt, qpos)),
                    window=win, softcap=cap, nsplit=nsplit,
                    mc=tdec.min_chunk(rows, D, 2), cfac=tdec._cfac(rows, D, 2),
                    split_p=split_p)
    live = qpos >= 0
    assert relerr(y.numpy()[live], np.asarray(pal)[live]) < 1e-5


def test_a_row_with_no_valid_slot_gets_zeros():
    """The kernels never read a dead tile, so a row with no valid slot at
    all gets zeros; the plain version gives the mean of V there and the
    Pallas kernel sum(V[:C]) / rup(C, bk) (its padded slots score like the
    rest).  The main path has no such row: the query's own slot is
    valid."""
    arrs, kw = _roll_inputs("half_gqa", seed=3)
    q, kc, vc, pos, qpos = arrs
    pos[0] = -1                                       # row 0: all empty
    pal = np.asarray(jops.decode_attention(*(jnp.asarray(a) for a in arrs),
                                           tile=32, interpret=True, **kw))
    t = [torch.from_numpy(a) for a in arrs]
    y = rolling_model(*t, chunk=48, **kw).numpy()
    plain = tdec.decode_attention_plain(*t, **kw).numpy()
    assert (y[0] == 0).all()
    G = q.shape[2] // kc.shape[2]
    mean_v = np.repeat(vc[0].mean(0), G, axis=0)      # (H, D)
    np.testing.assert_allclose(plain[0, 0], mean_v, rtol=1e-5, atol=1e-6)
    assert relerr(pal[0, 0], mean_v) < 1e-2           # Pallas pads to 128
    assert relerr(y[1:], pal[1:]) < 1e-5              # the other row agrees


def test_padding_rows_get_zeros_in_the_model():
    """Paged padding rows (qpos < 0): zeros from the core, the mean of V
    from the Pallas kernel; the engine discards them."""
    B, Sq, H, KV, D, bs, nblk, lens, win, cap, pad = \
        PAGED_CASES["verify_bs8_window"]
    q, kp, vp, bt, lens_a, qpos = _paged_inputs(5, B, Sq, H, KV, D, bs, nblk,
                                                lens, pad)
    rows = min(Sq * (H // KV), tdec.ROWS)
    y = paged_model(*(torch.from_numpy(a) for a in (q, kp, vp, bt, qpos)),
                    window=win, softcap=cap, nsplit=2,
                    mc=tdec.min_chunk(rows, D, 2),
                    cfac=tdec._cfac(rows, D, 2)).numpy()
    assert (y[qpos < 0] == 0).all() and (qpos < 0).any()
