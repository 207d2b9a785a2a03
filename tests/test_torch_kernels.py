"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers run their plain versions, so these hold the plain
versions against the Pallas kernels in interpret mode and against
``repro.kernels.ref``.  The same inputs, made with numpy, go to both.
Tolerances are those of ``tests/test_kernels.py``: fp32 relerr < 1e-5 (the
sums run in another order), bf16 < 2e-2 (one bf16 rounding of the output
may land on the other side).  ``tests/test_torch_gpu.py`` holds the CUDA
kernels themselves against these plain versions on the card.
"""
import jax  # noqa: F401  (JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import relerr
from repro.kernels import ops, ref
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import matmul_fused as tmm

R = np.random.RandomState(11)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bf16" else 1e-5


def _both(a, name):
    jdt, tdt = DTYPES[name]
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# matmul_fused (cases of tests/test_kernels.py:17-56)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 64, 32), (100, 130, 70),
                                   (256, 256, 256), (8, 512, 128)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_matmul_bias_gelu(shape, dt):
    M, K, N = shape
    jx, tx = _both(R.randn(M, K), dt)
    jw, tw = _both(R.randn(K, N), dt)
    jb, tb = _both(R.randn(N), dt)
    y = tmm.matmul_fused(tx, tw, bias=tb, act="gelu")
    assert y.dtype == DTYPES[dt][1] and y.shape == (M, N)
    pal = ops.matmul_fused(jx, jw, bias=jb, act="gelu", tile=(32, 64, 32),
                           interpret=True)
    assert relerr(_np(y), pal) < _tol(dt)
    assert relerr(_np(y), ref.matmul_fused_ref(jx, jw, bias=jb, act="gelu")) \
        < _tol(dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_matmul_glu(dt):
    jx, tx = _both(R.randn(64, 96), dt)
    jw, tw = _both(R.randn(96, 48), dt)
    jw2, tw2 = _both(R.randn(96, 48), dt)
    y = tmm.matmul_fused(tx, tw, w2=tw2, act="silu")
    pal = ops.matmul_fused(jx, jw, w2=jw2, act="silu", tile=(32, 32, 32),
                           interpret=True)
    assert relerr(_np(y), pal) < _tol(dt)
    assert relerr(_np(y), ref.matmul_fused_ref(jx, jw, w2=jw2, act="silu")) \
        < _tol(dt)


def test_matmul_leading_dims():
    jx, tx = _both(R.randn(2, 10, 48), "fp32")
    jw, tw = _both(R.randn(48, 32), "fp32")
    y = tmm.matmul_fused(tx, tw)
    assert y.shape == (2, 10, 32)
    pal = ops.matmul_fused(jx, jw, tile=(8, 16, 32), interpret=True)
    assert relerr(_np(y), pal) < 1e-5


@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "relu2", "sigmoid",
                                 "tanh"])
def test_matmul_each_act(act):
    jx, tx = _both(R.randn(24, 40), "fp32")
    jw, tw = _both(R.randn(40, 20), "fp32")
    jb, tb = _both(R.randn(20), "fp32")
    y = tmm.matmul_fused(tx, tw, bias=tb, act=act)
    assert relerr(_np(y), ref.matmul_fused_ref(jx, jw, bias=jb, act=act)) \
        < 1e-5


@pytest.mark.parametrize("dt,out", [("bf16", "fp32"), ("fp32", "bf16")])
def test_matmul_out_dtype(dt, out):
    jx, tx = _both(R.randn(16, 64), dt)
    jw, tw = _both(R.randn(64, 24), dt)
    jodt, todt = DTYPES[out]
    y = tmm.matmul_fused(tx, tw, act="relu", out_dtype=todt)
    assert y.dtype == todt
    pal = ops.matmul_fused(jx, jw, act="relu", out_dtype=jodt,
                           tile=(16, 32, 32), interpret=True)
    assert pal.dtype == jodt
    assert relerr(_np(y), pal) < 2e-2


# ---------------------------------------------------------------------------
# conv2d_fused (cases of tests/test_kernels.py:158-210, plus ResNet-34's)
# ---------------------------------------------------------------------------

def _conv_case(N, H, W, CI, CO, k, s, pad, bn, act, dt):
    jx, tx = _both(R.randn(N, H, W, CI), dt)
    jw, tw = _both(R.randn(k, k, CI, CO), dt)
    jbn = tbn = None
    if bn:
        vecs = [R.rand(CO) + 0.5 for _ in range(4)]
        jbn = tuple(jnp.asarray(v, jnp.float32) for v in vecs)
        tbn = tuple(torch.from_numpy(v.astype(np.float32)) for v in vecs)
    y = tconv.conv2d_fused(tx, tw, stride=s, padding=pad, bn=tbn, act=act)
    assert y.dtype == DTYPES[dt][1]
    pal = ops.conv2d_fused(jx, jw, stride=s, padding=pad, bn=jbn, act=act,
                           interpret=True)
    assert y.shape == pal.shape
    assert relerr(_np(y), pal) < _tol(dt)
    r = ref.conv2d_fused_ref(jx, jw, stride=s, padding=pad, bn=jbn, act=act)
    assert relerr(_np(y), r) < _tol(dt)


@pytest.mark.parametrize("stride,pad", [(1, "SAME"), (2, "SAME"),
                                        (2, "VALID")])
def test_conv2d_stride_padding(stride, pad):
    _conv_case(2, 12, 12, 6, 16, 3, stride, pad, False, "relu", "fp32")


@pytest.mark.parametrize("spec", [
    (2, 16, 16, 3, 8, 3, 1, "SAME", True),
    (1, 17, 17, 4, 16, 5, 2, "SAME", False),
    (2, 12, 12, 8, 8, 1, 1, "VALID", True),    # the MobileNet 1x1 workhorse
    (1, 16, 16, 3, 6, 3, 2, "VALID", False),
])
def test_conv2d(spec):
    _conv_case(*spec, act="relu", dt="fp32")


# ResNet-34's own patterns at small spatial sizes: the 7x7/2 stem pads
# (2, 3), a 3x3/2 conv pads (0, 1), a 1x1/2 projection pads nothing; BN with
# and without the fused ReLU (the second conv of a block has no act).
RESNET = {
    "stem7x7s2": (2, 16, 16, 3, 16, 7, 2, "SAME", True, "relu"),
    "c3x3s2": (2, 8, 8, 16, 32, 3, 2, "SAME", True, "relu"),
    "proj1x1s2": (2, 8, 8, 16, 32, 1, 2, "SAME", True, None),
    "c3x3s1_noact": (2, 7, 7, 32, 32, 3, 1, "SAME", True, None),
}


@pytest.mark.parametrize("name", sorted(RESNET))
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_conv2d_resnet_patterns(name, dt):
    *spec, act = RESNET[name]
    _conv_case(*spec, act=act, dt=dt)


@pytest.mark.parametrize("n,k,s", [(224, 7, 2), (112, 3, 2), (56, 3, 1),
                                   (56, 1, 2), (17, 5, 2), (7, 3, 1)])
def test_same_pads_match_xla(n, k, s):
    from jax import lax
    ((lo, hi),) = lax.padtype_to_pads((n,), (k,), (s,), "SAME")
    assert tconv.same_pads(n, k, s) == (lo, hi)


def test_cpu_wrappers_take_plain_versions_without_counting():
    before = (tconv.conv2d_fused.launches, tmm.matmul_fused.launches)
    x = torch.randn(1, 6, 6, 4)
    w = torch.randn(3, 3, 4, 8)
    assert torch.equal(tconv.conv2d_fused(x, w, stride=2),
                       tconv.conv2d_fused_plain(x, w, stride=2))
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    assert torch.equal(tmm.matmul_fused(a, b), tmm.matmul_fused_plain(a, b))
    assert (tconv.conv2d_fused.launches, tmm.matmul_fused.launches) == before
