"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, and two models (LeNet-5, smoke llama3.2-1b) through the port's
entry point.

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

from repro_torch.kernels import attention as ka
from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import decode_attention as kd
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

# flash_attention: (B, Sq, Skv, H, KV, D, causal, window, q_offset), the
# cases of the JAX package's kernel tests, plus the LM prefill's head width
FLASH = {
    "causal": (2, 64, 64, 4, 4, 32, True, None, 0),
    "window": (1, 48, 48, 4, 2, 16, True, 16, 0),
    "q_offset": (2, 32, 96, 6, 2, 32, True, None, 64),
    "bidir_ragged": (1, 100, 100, 2, 1, 64, False, None, 0),
    "gqa_window": (2, 128, 128, 8, 8, 64, True, 32, 0),
    "llama_heads": (1, 200, 200, 32, 8, 64, True, None, 0),
    "d128": (1, 70, 70, 4, 2, 128, True, None, 0),
}
# decode_attention: (B, C, H, KV, D, window), half the cache filled
DECODE = {
    "gqa": (2, 64, 4, 2, 32, None),
    "mqa_window": (1, 96, 8, 1, 64, 32),
    "mha": (3, 40, 4, 4, 16, None),
    "llama": (8, 1024, 32, 8, 64, None),
    "d128": (2, 300, 8, 2, 128, None),
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


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention_kernel(card, name, dt):
    B, Sq, Skv, H, KV, D, causal, win, off = FLASH[name]
    q = _randn(card, B, Sq, H, D, dt=DTYPES[dt])
    k = _randn(card, B, Skv, KV, D, dt=DTYPES[dt])
    v = _randn(card, B, Skv, KV, D, dt=DTYPES[dt])
    n0 = ka.flash_attention.launches
    y = ka.flash_attention(q, k, v, causal=causal, window=win, q_offset=off)
    torch.cuda.synchronize()
    assert ka.flash_attention.launches == n0 + 1
    p = ka.flash_attention_plain(q, k, v, causal=causal, window=win,
                                 q_offset=off)
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_flash_attention_kernel_positions_softcap(card, dt):
    """Left-padded rows (positions -1 on the padding) and a softcap: the
    valid query rows agree; pad rows are garbage the caller discards."""
    B, S, H, KV, D = 3, 80, 4, 2, 32
    pad = torch.tensor([0, 5, 70], device="cuda")
    ar = torch.arange(S, device="cuda")
    pos = torch.where(ar[None] >= pad[:, None], ar[None] - pad[:, None],
                      torch.full_like(ar[None], -1)).to(torch.int32)
    q = _randn(card, B, S, H, D, dt=DTYPES[dt])
    k = _randn(card, B, S, KV, D, dt=DTYPES[dt])
    v = _randn(card, B, S, KV, D, dt=DTYPES[dt])
    y = ka.flash_attention(q, k, v, positions=pos, softcap=5.0)
    p = ka.flash_attention_plain(q, k, v, positions=pos, softcap=5.0)
    keep = pos >= 0
    assert _rel(y[keep], p[keep]) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_attention_kernel(card, name, dt):
    B, C, H, KV, D, win = DECODE[name]
    fill = C // 2
    ar = torch.arange(C, device="cuda", dtype=torch.int32)
    pos = torch.where(ar < fill, ar, torch.full_like(ar, -1))
    pos = pos.expand(B, C).contiguous()
    q = _randn(card, B, 1, H, D, dt=DTYPES[dt])
    kcache = _randn(card, B, C, KV, D, dt=DTYPES[dt])
    vcache = _randn(card, B, C, KV, D, dt=DTYPES[dt])
    qpos = torch.full((B, 1), fill, dtype=torch.int32, device="cuda")
    n0 = kd.decode_attention.launches
    y = kd.decode_attention(q, kcache, vcache, pos, qpos, window=win,
                            softcap=30.0 if name == "mha" else None)
    torch.cuda.synchronize()
    assert kd.decode_attention.launches == n0 + 1
    p = kd.decode_attention_plain(q, kcache, vcache, pos, qpos, window=win,
                                  softcap=30.0 if name == "mha" else None)
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert _rel(y, p) < TOL[dt]


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
    q, k = _randn(card, 1, 8, 4, 24), _randn(card, 1, 8, 2, 24)
    with pytest.raises(ValueError):                      # head_dim 24
        ka.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        ka.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):                      # KV does not divide H
        ka.flash_attention(_randn(card, 1, 8, 4, 32), _randn(card, 1, 8, 3, 32),
                           _randn(card, 1, 8, 3, 32))
    kv = _randn(card, 1, 16, 2, 32)
    pos = torch.zeros(1, 16, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):                      # cache on the host
        kd.decode_attention(_randn(card, 1, 1, 4, 32), kv.cpu(), kv.cpu(),
                            pos, pos[:, :1])


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


def test_llama_smoke_through_the_entry_point(card):
    """The LM path on the card at smoke size: prefill, four decode steps and
    greedy generate, each kernel launched where the plan says, the logits
    held against the reference backend (bf16 < 5e-2)."""
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("serve", "decode", 32, 2)
    cm = flow.compile("llama3.2-1b", shape, smoke=True)
    ref = flow.compile("llama3.2-1b", shape, smoke=True, backend="reference")
    assert {cm.plan.kernels[o] for o in ("attention", "decode_attention",
                                         "matmul", "glu_matmul")} == {"cuda"}
    params = cm.init_params(0)
    tok = torch.randint(0, 256, (2, 12), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    f0, d0 = ka.flash_attention.launches, kd.decode_attention.launches
    y, st, _ = cm.prefill(params, {"tokens": tok})
    yr, st_r, _ = ref.prefill(params, {"tokens": tok})
    assert ka.flash_attention.launches - f0 == 3
    assert y.shape == (2, 1, 256) and _rel(y, yr) < 5e-2
    for t in range(4):
        nxt = tok[:, t:t + 1]
        y, st, _ = cm.decode(params, {"tokens": nxt}, st, 12 + t)
        yr, st_r, _ = ref.decode(params, {"tokens": nxt}, st_r, 12 + t)
        assert _rel(y, yr) < 5e-2
    assert kd.decode_attention.launches - d0 == 12
    toks, _ = cm.generate(params, {"tokens": tok}, steps=4)
    assert toks.shape == (2, 4) and toks.dtype == torch.int32
    rec = cm.measure("decode", iters=2, params=params)
    assert rec["timer"] == "cuda_events" and rec["tokens_per_s"] > 0
