"""conv2d_fused's ``mid_ci`` schedule on the CPU: its chunk map and tile walk.

The kernel (``csrc/conv2d_mid_ci.cu``) runs only on the card.  A block of
its persistent grid (``conv2d.mid_ci_grid``) keeps one 64-channel strip of w
and walks 128-pixel M tiles (``conv2d.mid_ci_walk``); a pixel row of a tile
is gathered as 16-byte chunks of 8 channels of one tap through the chunk
map (``conv2d.mid_ci_chunks``: (dh, dw, offset from the pixel's corner tap),
zeros for a tap in the padding, a pixel past M and the K padding).
:func:`chunk_model` does exactly that, block by block and tile by tile in
the kernel's order, on numpy arrays, and is held against the port's plain
version and the JAX package's Pallas ``conv2d_fused`` in interpret mode on
the same numpy inputs (fp32 within 1e-5, ``tests/test_kernels.py``'s
tolerance: the same sums in another order), at CI 8, 16, 32 and 48, 1x1
and 3x3, strides 1 and 2, SAME and VALID.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels.conv2d import conv2d_fused as jconv2d_fused
from repro_torch.kernels import conv2d as kc

BF = torch.bfloat16


def chunk_model(x, w, stride, padding, bn=None, act=None, blocks=3):
    """The mid_ci kernel on fp32 numpy arrays: x (N, H, W, CI), w (kh, kw,
    CI, CO); bn (scale, bias, mean, var) or None; act None or "relu";
    ``blocks`` the blocks the card would hold at once.  Every output
    element is written by exactly one (block, tile)."""
    N, H, W, CI = x.shape
    kh, kw, _, CO = w.shape
    (pt, _), (pl, _), ho, wo = kc.conv_geometry(H, W, kh, kw, stride,
                                                padding)
    M, K = N * ho * wo, kh * kw * CI
    chunks = kc.mid_ci_chunks(kh, kw, CI, W)
    KP = len(chunks) * 8
    strips = -(-CO // kc.MID_CI_BN)
    wk = np.zeros((KP, strips * kc.MID_CI_BN), np.float64)
    wk[:K, :CO] = w.reshape(K, CO)
    xf = x.reshape(-1).astype(np.float64)
    out = np.full((M, CO), np.nan)
    grid = kc.mid_ci_grid(M, CO, blocks)
    for tiles in kc.mid_ci_walk(M, CO, grid):
        for strip, mt in tiles:
            m = mt * kc.CONV_BM + np.arange(kc.CONV_BM)
            ok = m < M
            mm = np.where(ok, m, 0)
            n, rem = np.divmod(mm, ho * wo)
            oh, ow = np.divmod(rem, wo)
            ih0, iw0 = oh * stride - pt, ow * stride - pl
            base = ((n * H + ih0) * W + iw0) * CI
            a = np.zeros((kc.CONV_BM, KP))
            for j, ch in enumerate(chunks):
                if ch is None:
                    continue
                dh, dw, off = ch
                ih, iw = ih0 + dh, iw0 + dw
                tap = ok & (ih >= 0) & (ih < H) & (iw >= 0) & (iw < W)
                idx = np.where(tap, base + off, 0)[:, None] + np.arange(8)
                a[:, 8 * j:8 * j + 8] = np.where(tap[:, None], xf[idx], 0.0)
            n0 = strip * kc.MID_CI_BN
            n1 = min(CO, n0 + kc.MID_CI_BN)
            y = a @ wk[:, n0:n1]
            assert np.isnan(out[m[ok], n0:n1]).all()      # written once
            out[m[ok], n0:n1] = y[ok]
    assert not np.isnan(out).any()
    y = out.reshape(N, ho, wo, CO).astype(np.float32)
    if bn is not None:
        scale, bias, mean, var = bn
        y = (y - mean) * (1.0 / np.sqrt(var + 1e-5) * scale) + bias
    if act == "relu":
        y = np.maximum(y, 0.0)
    return y


def _inputs(N, H, W, k, CI, CO, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, CI).astype(np.float32)
    w = (rng.randn(k, k, CI, CO) * (k * k * CI) ** -0.5).astype(np.float32)
    bn = tuple((rng.rand(CO) + 0.5).astype(np.float32) for _ in range(4))
    return x, w, bn


# CI x (1x1, 3x3) x (stride 1, 2) x (SAME, VALID); CO 72 (a second, ragged
# strip) at CI 16 and 48, 64 else; an odd image so SAME's high pad shows
CASES = [(ci, k, s, p) for ci in (8, 16, 32, 48) for k in (1, 3)
         for s in (1, 2) for p in ("SAME", "VALID")]


@pytest.mark.parametrize("ci,k,stride,padding", CASES,
                         ids=[f"ci{c}-k{k}-s{s}-{p}" for c, k, s, p in CASES])
def test_chunk_model_matches_plain_and_jax(ci, k, stride, padding):
    co = 72 if ci in (16, 48) else 64
    x, w, bn = _inputs(2, 11, 9, k, ci, co, seed=ci + k + stride)
    assert kc._schedule(ci, co, BF, True, kernel=(k, k, stride)) == "mid_ci"
    got = chunk_model(x, w, stride, padding, bn, "relu")
    plain = kc.conv2d_fused_plain(
        torch.from_numpy(x), torch.from_numpy(w), stride=stride,
        padding=padding, bn=[torch.from_numpy(t) for t in bn],
        act="relu").numpy()
    assert got.shape == plain.shape
    assert relerr(got, plain) < 1e-5
    jy = jconv2d_fused(jnp.asarray(x), jnp.asarray(w), stride=stride,
                       padding=padding, bn=[jnp.asarray(t) for t in bn],
                       act="relu", interpret=True)
    assert relerr(got, np.asarray(jy)) < 1e-5


@pytest.mark.parametrize("blocks", [1, 2, 5, 64])
def test_chunk_model_bare_any_grid(blocks):
    """No BN, no act, 3x3 stride 2 SAME at CI 24 and CO 136 (three strips):
    the same output whatever the grid the card's occupancy gives."""
    x, w, _ = _inputs(3, 13, 10, 3, 24, 136, seed=blocks)
    got = chunk_model(x, w, 2, "SAME", blocks=blocks)
    plain = kc.conv2d_fused_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  stride=2).numpy()
    assert relerr(got, plain) < 1e-5


def test_chunks_of_the_pointwise_conv():
    """MobileNetV1's 32 -> 64 1x1 conv: K = 32 is one stage of four chunks,
    one tap, offsets 0, 8, 16, 24: no padding chunk."""
    assert kc.mid_ci_chunks(1, 1, 32, 112) == [(0, 0, 0), (0, 0, 8),
                                               (0, 0, 16), (0, 0, 24)]


def test_chunks_of_a_3x3_conv():
    """3x3 at CI 16 on a 10-wide input: K = 144 padded to 160, two chunks a
    tap in (dh, dw) order, offset (dh * 10 + dw) * 16 + ci, two padding
    chunks at the end; no chunk straddles two taps."""
    ch = kc.mid_ci_chunks(3, 3, 16, 10)
    assert len(ch) == 20 and ch[18:] == [None, None]
    assert ch[:4] == [(0, 0, 0), (0, 0, 8), (0, 1, 16), (0, 1, 24)]
    assert ch[6] == (1, 0, 160) and ch[17] == (2, 2, (2 * 10 + 2) * 16 + 8)
    for dh, dw, off in ch[:18]:
        assert (off - (dh * 10 + dw) * 16) in (0, 8)


# (M, CO, blocks the card holds) -> grid: the path's 100,352 pixels by 64
# channels at 3 blocks an SM of 132 (784 tiles: about two a block); a grid
# over the tiles cut to them; strips rounding the grid down; a grid smaller
# than the strips raised to one block a strip
GRIDS = [((100352, 64, 396), 396), ((1000, 64, 396), 8),
         ((100352, 192, 396), 396), ((100352, 128, 395), 394),
         ((5000, 1024, 8), 16)]


@pytest.mark.parametrize("args,want", GRIDS, ids=[str(a) for a, _ in GRIDS])
def test_grid_and_walk_cover_every_tile_once(args, want):
    M, CO, blocks = args
    grid = kc.mid_ci_grid(M, CO, blocks)
    assert grid == want
    strips, mtiles = -(-CO // 64), -(-M // 128)
    walk = kc.mid_ci_walk(M, CO, grid)
    seen = [t for tiles in walk for t in tiles]
    assert sorted(seen) == [(s, m) for s in range(strips)
                            for m in range(mtiles)]
    for b, tiles in enumerate(walk):             # one strip a block
        assert {s for s, _ in tiles} <= {b % strips}
    per = [len(t) for t in walk]
    assert max(per) - min(per) <= 1              # balanced to one tile
