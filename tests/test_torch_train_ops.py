"""The op layer in train mode on the CPU: each kernel's forward under
autograd (``ops_impl._KernelForward``) against its reference op, and
train-mode BatchNorm against the JAX package's op.

Under ``backend="cuda"`` a CPU model's plan resolves the ops to the kernel
wrappers, which run their plain versions on CPU tensors; in fp32 those
compute what the reference ops compute, so the output holds to 1e-6 and
the gradients, which the backward takes from the reference op, to 1e-6.
BatchNorm on the batch's statistics is held to JAX's op at 1e-5 (output)
and 1e-4 (every gradient) on well-conditioned inputs, at the shapes the
smoke CNNs give it too (2 images of 2 x 2 at their last stage).
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import SMOKE_SHAPE, relerr
from repro.core import ops_impl as jops
from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig
from repro_torch.core import ops_impl


@functools.lru_cache(maxsize=None)
def _plan(prec, backend):
    return tflow.compile("llama3.2-1b", SMOKE_SHAPE,
                         FlowConfig(mode="folded", precision=prec),
                         smoke=True, device="cpu", backend=backend).plan


def _ctx(prec="fp32", backend="cuda"):
    return ops_impl.Ctx(mode="train", plan=_plan(prec, backend))


def _leaves(rng, *shapes, scale=0.5):
    return [torch.from_numpy(rng.randn(*s).astype(np.float32) * scale)
            .requires_grad_(True) for s in shapes]


def _matmul(ctx, ts):
    x, w = ts
    return ops_impl._matmul_backend(ctx, x, w)


def _matmul_bias_gelu(ctx, ts):
    x, w, b = ts
    return ops_impl._matmul_backend(ctx, x, w, bias=b, act="gelu")


def _glu(ctx, ts):
    x, w, w2 = ts
    return ops_impl._matmul_backend(ctx, x, w, w2=w2, act="silu")


def _attention(ctx, ts):
    q, k, v = ts
    B, S = q.shape[:2]
    pos = torch.arange(S, dtype=torch.int32).expand(B, S)
    op = SimpleNamespace(attrs={"state_key": None, "causal": True})
    return ops_impl.op_attention(ctx, op, {}, q, k, v, pos)


def _conv_relu(ctx, ts):
    x, w = ts
    return ops_impl._conv_backend(ctx, x, w, stride=2, padding="SAME",
                                  act="relu")


def _conv_bn(ctx, ts):
    x, w, scale, bias = ts
    bn = (scale, bias, torch.zeros(8), torch.ones(8))
    return ops_impl._conv_backend(ctx, x, w, stride=1, padding="SAME", bn=bn)


def _rg_lru(ctx, ts):
    x, wa, wx = ts
    op = SimpleNamespace(attrs={"state_key": "lru"})
    p = {"lru_lambda": torch.linspace(-1.0, 2.0, 16), "lru_wa": wa,
         "lru_ba": torch.zeros(16), "lru_wx": wx, "lru_bx": torch.zeros(16)}
    return ops_impl.op_rg_lru(ctx, op, p, x)


CASES = {
    "matmul": (_matmul, [(2, 6, 16), (16, 24)]),
    "matmul_bias_gelu": (_matmul_bias_gelu, [(2, 6, 16), (16, 24), (24,)]),
    "glu_matmul": (_glu, [(2, 6, 16), (16, 24), (16, 24)]),
    "attention": (_attention, [(2, 8, 4, 8), (2, 8, 2, 8), (2, 8, 2, 8)]),
    "conv2d_relu": (_conv_relu, [(2, 9, 9, 4), (3, 3, 4, 8)]),
    "conv2d_bn": (_conv_bn, [(2, 6, 6, 4), (3, 3, 4, 8), (8,), (8,)]),
    "rg_lru": (_rg_lru, [(2, 6, 16), (2, 8, 8), (2, 8, 8)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_forward_takes_the_reference_gradient(case):
    fn, shapes = CASES[case]
    ts = _leaves(np.random.RandomState(0), *shapes)
    y = fn(_ctx(), ts)
    assert type(y.grad_fn).__name__ == "_KernelForwardBackward"
    g = torch.from_numpy(np.random.RandomState(1).randn(*y.shape)
                         .astype(np.float32))
    got = torch.autograd.grad(y, ts, g)
    yr = fn(_ctx(backend="reference"), ts)
    assert type(yr.grad_fn).__name__ != "_KernelForwardBackward"
    want = torch.autograd.grad(yr, ts, g)
    assert relerr(y.detach(), yr.detach()) < 1e-6
    for a, b in zip(got, want):
        assert relerr(a, b) < 1e-6


@pytest.mark.parametrize("case", ["matmul", "conv2d_relu"])
def test_kernel_forward_without_autograd_is_the_launch_alone(case):
    """Under ``no_grad`` (and in prefill) the wrapper's output comes back
    as it is: no autograd node, nothing saved."""
    fn, shapes = CASES[case]
    ts = _leaves(np.random.RandomState(0), *shapes)
    with torch.no_grad():
        assert fn(_ctx(), ts).grad_fn is None
    ctx = ops_impl.Ctx(mode="prefill", plan=_plan("fp32", "cuda"))
    assert fn(ctx, [t.detach() for t in ts]).grad_fn is None


def test_bf16_train_kernels_take_the_compute_dtype(monkeypatch):
    """A bf16 train plan's fp32 master weights reach the matmul and conv
    kernels rounded to bf16 (the reference rounds the matmul's too); their
    gradients stay fp32, the reference op's."""
    seen = []
    real = ops_impl.plan_kernel

    def spy(plan, op, **facts):
        kern = real(plan, op, **facts)

        def rec(x, w, **kw):
            seen.append((op, x.dtype, w.dtype))
            return kern(x, w, **kw)
        return rec
    monkeypatch.setattr(ops_impl, "plan_kernel", spy)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 6, 16).astype(np.float32)) \
        .to(torch.bfloat16).requires_grad_(True)
    (w,) = _leaves(rng, (16, 24))
    ctx = _ctx("bf16")
    y = ops_impl._matmul_backend(ctx, x, w)
    xi = x.reshape(2, 6, 4, 4).requires_grad_(True)
    (wc,) = _leaves(rng, (3, 3, 4, 8))
    yc = ops_impl._conv_backend(ctx, xi, wc, stride=1, padding="SAME")
    assert seen == [("matmul", torch.bfloat16, torch.bfloat16),
                    ("conv2d", torch.bfloat16, torch.bfloat16)]
    assert y.dtype == yc.dtype == torch.bfloat16
    gw, = torch.autograd.grad(y.float().sum(), [w])
    gc, = torch.autograd.grad(yc.float().sum(), [wc])
    assert gw.dtype == gc.dtype == torch.float32
    monkeypatch.setattr(ops_impl, "plan_kernel", real)
    ref = _ctx("bf16", "reference")
    want, = torch.autograd.grad(
        ops_impl._matmul_backend(ref, x, w).float().sum(), [w])
    assert torch.equal(gw, want)


@pytest.mark.parametrize("shape", [(2, 2, 2, 512), (8, 7, 7, 64),
                                   (2, 16, 16, 32)])
def test_batchnorm_train_matches_jax(shape):
    """Train-mode BN (the batch's statistics over N, H, W; the population
    variance) and its backward against JAX's op through ``jax.vjp``: the
    output within 1e-5, the gradients of the input, scale and bias within
    1e-4, and none for the running mean and variance."""
    C = shape[-1]
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 2.0 + 0.5
    scale = (1.0 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    mean, var = np.zeros(C, np.float32), np.ones(C, np.float32)
    g = rng.randn(*shape).astype(np.float32)
    op = SimpleNamespace(attrs={"eps": 1e-5})
    jctx = jops.Ctx(mode="train", plan=SimpleNamespace(
        flow=SimpleNamespace(precision="fp32")))

    def jfn(x, s, b):
        return jops.op_batchnorm(jctx, op, {"bn_scale": s, "bn_bias": b,
                                            "bn_mean": mean, "bn_var": var}, x)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale),
                      jnp.asarray(bias))
    jg = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    run = [torch.from_numpy(a).requires_grad_(True) for a in (mean, var)]
    y = ops_impl.op_batchnorm(_ctx(), op, {
        "bn_scale": ts[1], "bn_bias": ts[2], "bn_mean": run[0],
        "bn_var": run[1]}, ts[0])
    assert relerr(y.detach().numpy(), np.asarray(jy)) < 1e-5
    got = torch.autograd.grad(y, ts + run, torch.from_numpy(g),
                              allow_unused=True)
    for a, b in zip(got[:3], jg):
        assert relerr(a.numpy(), np.asarray(b)) < 1e-4
    assert got[3] is None and got[4] is None
