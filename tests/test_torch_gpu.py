"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, and one model through the port's entry point.

Every test here is marked ``gpu`` and skips without a CUDA card of compute
capability (9, 0).  The file imports neither JAX nor the JAX package (the
card's machine has no JAX), so it runs there on its own:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

TF32 is off in every test, so the fp32 plain versions are full fp32.
Tolerances (relerr, max |diff| over max |plain|): fp32 < 1e-5, the same sums
in another order; bf16 < 2e-2, one bf16 rounding of the output may land on
the other side.
"""
import pytest
import torch

from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import matmul_fused as km

pytestmark = pytest.mark.gpu

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
TOL = {"fp32": 1e-5, "bf16": 2e-2}

# (N, H, W, CI, CO, k, stride, padding, bn, act)
CONVS = {
    "stem7x7s2": (2, 32, 32, 3, 64, 7, 2, "SAME", True, "relu"),
    "c3x3s2": (2, 15, 15, 16, 96, 3, 2, "SAME", True, "relu"),
    "proj1x1s2": (2, 8, 8, 64, 128, 1, 2, "SAME", True, None),
    "c3x3s1": (3, 7, 7, 72, 40, 3, 1, "SAME", False, None),
    "k5s2valid": (1, 17, 17, 4, 16, 5, 2, "VALID", False, "relu"),
}


@pytest.fixture
def card():
    from repro_torch.device import hopper_ok
    if not hopper_ok():
        pytest.skip("needs a CUDA card of compute capability (9, 0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _rel(y, p):
    y, p = y.float(), p.float()
    return ((y - p).abs().max() / p.abs().max()).item()


def _randn(g, *shape, dt=torch.float32):
    return torch.randn(*shape, generator=g, device="cuda").to(dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv2d_kernel(card, name, dt):
    N, H, W, CI, CO, k, s, pad, bn, act = CONVS[name]
    x = _randn(card, N, H, W, CI, dt=DTYPES[dt])
    w = _randn(card, k, k, CI, CO, dt=DTYPES[dt])
    bnp = tuple(torch.rand(CO, generator=card, device="cuda") + 0.5
                for _ in range(4)) if bn else None
    n0 = kc.conv2d_fused.launches
    y = kc.conv2d_fused(x, w, stride=s, padding=pad, bn=bnp, act=act)
    torch.cuda.synchronize()
    assert kc.conv2d_fused.launches == n0 + 1
    p = kc.conv2d_fused_plain(x, w, stride=s, padding=pad, bn=bnp, act=act)
    assert y.dtype == DTYPES[dt] and y.shape == p.shape
    assert _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("glu", [False, True])
def test_matmul_kernel(card, dt, glu):
    x = _randn(card, 3, 37, 130, dt=DTYPES[dt])
    w = _randn(card, 130, 70, dt=DTYPES[dt])
    w2 = _randn(card, 130, 70, dt=DTYPES[dt]) if glu else None
    b = _randn(card, 70)
    n0 = km.matmul_fused.launches
    y = km.matmul_fused(x, w, bias=b, w2=w2, act="gelu")
    torch.cuda.synchronize()
    assert km.matmul_fused.launches == n0 + 1
    p = km.matmul_fused_plain(x, w, bias=b, w2=w2, act="gelu")
    assert y.shape == (3, 37, 70) and y.dtype == DTYPES[dt]
    assert _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "relu2", "sigmoid",
                                 "tanh"])
def test_matmul_kernel_each_act(card, act):
    x, w, b = _randn(card, 8, 512), _randn(card, 512, 1000), _randn(card, 1000)
    y = km.matmul_fused(x, w, bias=b, act=act, out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    p = km.matmul_fused_plain(x, w, bias=b, act=act, out_dtype=torch.bfloat16)
    assert _rel(y, p) < TOL["bf16"]


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = _randn(card, 1, 8, 8, 4)
    with pytest.raises(TypeError):
        kc.conv2d_fused(x.half(), _randn(card, 3, 3, 4, 8).half())
    with pytest.raises(ValueError):
        kc.conv2d_fused(x, _randn(card, 3, 3, 4, 8).cpu())
    with pytest.raises(ValueError):                      # grouped conv
        kc.conv2d_fused(x, _randn(card, 3, 3, 1, 4))
    with pytest.raises(ValueError):
        km.matmul_fused(_randn(card, 4, 6), _randn(card, 5, 3))


def test_lenet5_through_the_entry_point(card):
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    serve = ShapeConfig("serve", "prefill", 64, 8)
    cm = flow.compile("lenet5", serve)
    assert cm.device.type == "cuda"
    assert cm.plan.kernels["conv2d"] == cm.plan.kernels["matmul"] == "cuda"
    params = cm.init_params(0)
    x = {"images": _randn(card, 8, 32, 32, 1)}
    c0, m0 = kc.conv2d_fused.launches, km.matmul_fused.launches
    y, _, _ = cm.prefill(params, x)
    torch.cuda.synchronize()
    assert (kc.conv2d_fused.launches - c0, km.matmul_fused.launches - m0) \
        == (2, 3)
    ref = flow.compile("lenet5", serve, backend="reference")
    yr, _, _ = ref.prefill(params, x)
    assert y.shape == (8, 10) and torch.isfinite(y.float()).all()
    assert _rel(y, yr) < 5e-2
    rec = cm.measure("prefill", iters=2)
    assert rec["timer"] == "cuda_events" and rec["device"] != "cpu"
