"""conv2d_fused's ``small_ci`` schedule on the CPU: its halo geometry and K
map.

The kernel (``csrc/conv2d_small_ci.cu``) runs only on the card.  It brings
an 8 x 16-pixel output tile's input halo into shared memory
(``conv2d.small_ci_halo``) and gathers tap k of output pixel (r, c) at
``r * stride * row + c * stride * CI + kmap[k]`` (``conv2d.small_ci_kmap``).
:func:`halo_model` does exactly that from a zero-padded numpy input, tile by
tile, and is held against the port's plain version and the JAX package's
Pallas ``conv2d_fused`` in interpret mode on the same numpy inputs (fp32
within 1e-5: the same sums in another order), at the geometries the schedule
takes on the paths: ResNet-34's 7x7 stem, MobileNetV1's first 3x3 conv and
LeNet-5's second conv, on small images, SAME and VALID, strides 1 and 2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels.conv2d import conv2d_fused as jconv2d_fused
from repro_torch.kernels import conv2d as kc


def halo_model(x, w, stride, padding, bn=None, act=None):
    """The small_ci kernel's gather on fp32 numpy arrays: x (N, H, W, CI),
    w (kh, kw, CI, CO); bn (scale, bias, mean, var) or None; act None or
    "relu"."""
    N, H, W, CI = x.shape
    kh, kw, _, CO = w.shape
    (pt, _), (pl, _), ho, wo = kc.conv_geometry(H, W, kh, kw, stride,
                                                padding)
    TH, TW = kc.SMALL_CI_TILE
    rows, row, elems = kc.small_ci_halo(kh, kw, CI, stride)
    cols = row // CI
    kmap = np.asarray(kc.small_ci_kmap(kh, kw, CI, stride))
    th, tw = -(-ho // TH), -(-wo // TW)
    # the input as the halo loader sees it: zeros outside the image, far
    # enough on the high side for the last tile's halo
    hp = max(pt + H, (th * TH - 1) * stride + kh)
    wp = max(pl + W, (tw * TW - 1) * stride + kw)
    xp = np.zeros((N, hp, wp, CI), np.float32)
    xp[:, pt:pt + H, pl:pl + W] = x
    r, c = np.meshgrid(np.arange(TH), np.arange(TW), indexing="ij")
    pbase = (r * stride * row + c * stride * CI).reshape(-1)
    assert pbase.max() + kmap.max() < elems          # every tap in the halo
    wk = w.reshape(kh * kw * CI, CO).astype(np.float64)
    out = np.zeros((N, th * TH, tw * TW, CO), np.float64)
    for n in range(N):
        for i in range(th):
            for j in range(tw):
                h0, w0 = i * TH * stride, j * TW * stride
                halo = xp[n, h0:h0 + rows, w0:w0 + cols].reshape(-1)
                assert halo.size == elems
                a = halo[pbase[:, None] + kmap[None, :]].astype(np.float64)
                out[n, i * TH:(i + 1) * TH, j * TW:(j + 1) * TW] = \
                    (a @ wk).reshape(TH, TW, CO)
    y = out[:, :ho, :wo].astype(np.float32)
    if bn is not None:
        scale, bias, mean, var = bn
        y = (y - mean) * (1.0 / np.sqrt(var + 1e-5) * scale) + bias
    if act == "relu":
        y = np.maximum(y, 0.0)
    return y


# (N, H, W, kh, CI, CO): the stem, MobileNetV1's first conv, LeNet-5's
# second, on small images (an odd width for SAME's high extra column)
GEOMS = {"stem7x7": (2, 32, 32, 7, 3, 64), "mbv1_3x3": (2, 32, 31, 3, 3, 32),
         "lenet_5x5": (1, 14, 14, 5, 6, 16)}


def _inputs(N, H, W, k, CI, CO, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H, W, CI).astype(np.float32)
    w = (rng.randn(k, k, CI, CO) * (k * k * CI) ** -0.5).astype(np.float32)
    bn = tuple((rng.rand(CO) + 0.5).astype(np.float32) for _ in range(4))
    return x, w, bn


# every geometry at SAME and VALID, strides 1 and 2; LeNet-5's CI 6 at
# stride 2 would need a 19 x 35 x 6 halo, over SMALL_CI_HALO_MAX (simt)
GATHER = [(g, p, s) for g in sorted(GEOMS) for p in ("SAME", "VALID")
          for s in (1, 2) if (g, s) != ("lenet_5x5", 2)]


@pytest.mark.parametrize("geom,padding,stride", GATHER,
                         ids=[f"{g}-{p}-s{s}" for g, p, s in GATHER])
def test_halo_gather_matches_plain_and_jax(geom, padding, stride):
    N, H, W, k, CI, CO = GEOMS[geom]
    x, w, bn = _inputs(N, H, W, k, CI, CO)
    assert kc._schedule(CI, CO, torch.float32, True,
                        kernel=(k, k, stride)) == "small_ci"
    got = halo_model(x, w, stride, padding, bn, "relu")
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


def test_halo_gather_bare_conv_at_the_stem():
    """The base flow's bare stem (no BN, no act) on a 224-wide row band."""
    x, w, _ = _inputs(1, 20, 224, 7, 3, 64, seed=1)
    got = halo_model(x, w, 2, "SAME")
    plain = kc.conv2d_fused_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  stride=2).numpy()
    assert relerr(got, plain) < 1e-5


# the halo of each path geometry: (rows, row elements, elements)
HALOS = {(7, 7, 3, 2): (21, 111, 2331), (3, 3, 3, 2): (17, 99, 1683),
         (5, 5, 1, 1): (12, 20, 240), (5, 5, 6, 1): (12, 120, 1440)}


@pytest.mark.parametrize("geom", sorted(HALOS), ids=str)
def test_halo_extents_at_the_path_convs(geom):
    assert kc.small_ci_halo(*geom) == HALOS[geom]
    assert HALOS[geom][2] <= kc.SMALL_CI_HALO_MAX


def test_kmap_of_the_stem():
    """(dh, dw, ci) -> dh * 111 + dw * 3 + ci, in HWIO order, no division
    left for the kernel."""
    km = kc.small_ci_kmap(7, 7, 3, 2)
    assert len(km) == 147
    assert km[:7] == [0, 1, 2, 3, 4, 5, 6]
    assert km[21] == 111 and km[-1] == 6 * 111 + 6 * 3 + 2
    assert len(set(km)) == 147
