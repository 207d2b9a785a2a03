"""The hand-written CUDA kernels on the card, against their plain PyTorch
versions, and three models (LeNet-5, smoke llama3.2-1b, smoke
recurrentgemma-2b) through the port's entry point.

Every test here is marked ``gpu`` and skips without a CUDA card of compute
capability (9, 0).  The file imports neither JAX nor the JAX package (the
card's machine has no JAX), so it runs there on its own:

    PYTHONPATH=src python -m pytest -q -x -m gpu --noconftest tests/test_torch_gpu.py

TF32 is off in every test, so the fp32 plain versions are full fp32.
Tolerances (relerr, max |diff| over max |plain|): fp32 < 1e-5, the same sums
in another order; bf16 < 2e-2, one bf16 rounding of the output may land on
the other side.
"""
import math

import pytest
import torch

from repro_torch.kernels import attention as ka
from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import matmul_fused as km
from repro_torch.kernels import lru_scan as kl

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
    # recurrentgemma-2b's heads: 10 over 1 KV head of 256, windowed
    "d256_mqa": (2, 130, 130, 10, 1, 256, True, 2048, 0),
    "d256_window_cuts": (1, 300, 300, 10, 1, 256, True, 100, 0),
    # the wgmma schedule (bf16, D >= 64): Sq not a multiple of its 128-row
    # blocks and Skv not a multiple of its 64-key tiles with B >= 2 (the 2-D
    # view's next-row keys must be masked), q_offset with Skv > Sq,
    # bidirectional, windows that cut inside a block, GQA 4 and MQA 10
    "w64_ragged_gqa4": (2, 200, 200, 16, 4, 64, True, None, 0),
    "w64_bidir_skv_gt_sq": (3, 150, 190, 4, 4, 64, False, None, 0),
    "w64_window_cuts": (2, 300, 300, 8, 2, 64, True, 90, 0),
    "w128_q_offset": (2, 100, 230, 8, 2, 128, True, None, 130),
    "w128_gqa4_window": (2, 257, 257, 8, 2, 128, True, 70, 0),
    "w128_mha_qwen": (2, 192, 192, 20, 20, 128, True, None, 0),
    "w256_mqa10_ragged": (3, 141, 141, 10, 1, 256, True, 2048, 0),
    "w256_bidir": (2, 130, 70, 2, 1, 256, False, None, 0),
    "w256_q_offset_window": (2, 70, 200, 10, 1, 256, True, 64, 130),
    # the ffma schedule (fp32, D >= 64; the cases above run on it in fp32
    # too): its 128-row (64 at D 256) blocks and 64-key tiles cut by Sq,
    # Skv, q_offset and windows; MHA 20 and MQA 10 with a bidirectional
    # window
    "f64_q_offset_window": (2, 77, 301, 8, 2, 64, True, 50, 224),
    # whisper-small's encoder: bidirectional over 1500 frames (11 x 128 +
    # 92 rows, 23 x 64 + 28 keys), 12 over 12 heads of 64, at batch 2 and
    # at the path's batch 8; its decoder's causal 128-token prompt
    "whisper_encoder": (2, 1500, 1500, 12, 12, 64, False, None, 0),
    "whisper_encoder_b8": (8, 1500, 1500, 12, 12, 64, False, None, 0),
    "whisper_decoder_prompt": (8, 128, 128, 12, 12, 64, True, None, 0),
    "f256_mha20_ragged": (2, 100, 100, 20, 20, 256, True, None, 0),
    "f128_mqa10_bidir_window": (2, 130, 150, 10, 1, 128, False, 40, 0),
}
# decode_attention: (B, C, H, KV, D, window), half the cache filled
DECODE = {
    "gqa": (2, 64, 4, 2, 32, None),
    "mqa_window": (1, 96, 8, 1, 64, 32),
    "mha": (3, 40, 4, 4, 16, None),
    "llama": (8, 1024, 32, 8, 64, None),
    "d128": (2, 300, 8, 2, 128, None),
    "d256_mqa": (8, 1024, 10, 1, 256, None),
    "d256_window_cuts": (2, 2048, 10, 1, 256, 300),
}
# lru_scan: (B, S, W), the JAX package's kernel-test cases and the
# recurrentgemma-2b prefill
LRU = {"b2s16w64": (2, 16, 64), "b1s33w130": (1, 33, 130),
       "b3s8w256": (3, 8, 256), "rg_prefill": (8, 512, 2560)}


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


# conv2d_fused's tensor-core and FFMA schedules: (N, H, W, CI, CO, k,
# stride, padding, bn, act).  A ragged M (3 x 9 x 11 pixels) at CO 64 (the
# 64-wide tile), stride 2 at CO 128, a 1x1 projection, VALID with CO 192
# (one half-masked 128-wide tile) and no BN, CO 8, ResNet-34's 56 x 56 layer
# (196 blocks: no split) and its 7 x 7 one (16 blocks: K split in 9); every
# case but the 56 x 56 one has a grid under half a wave, so K is split
TC_CONVS = {
    "ragged_co64": (3, 9, 11, 64, 64, 3, 1, "SAME", True, "relu"),
    "s2_co128": (2, 28, 28, 128, 128, 3, 2, "SAME", True, "relu"),
    "proj1x1s2": (2, 14, 14, 64, 128, 1, 2, "SAME", True, None),
    "valid_nobn_co192": (1, 12, 10, 128, 192, 3, 1, "VALID", False, None),
    "co8": (2, 8, 8, 64, 8, 1, 1, "SAME", False, "gelu"),
    "resnet_64@56": (8, 56, 56, 64, 64, 3, 1, "SAME", True, "relu"),
    "resnet_512@7": (8, 7, 7, 512, 512, 3, 1, "SAME", True, "relu"),
}
# the ffma schedule's own: CI 4 with a 5x5 VALID window, CI 12 (a 16-deep
# stage spans taps) with CO 20
FFMA_CONVS = {
    "ci4_k5s2_valid": (1, 17, 17, 4, 16, 5, 2, "VALID", False, "relu"),
    "ci12_co20_s2": (2, 15, 13, 12, 20, 3, 2, "SAME", True, None),
}


def _conv_ran(sched, fn):
    """Run fn; assert that it made one conv launch, on ``sched``."""
    s0 = dict(kc.conv2d_fused.schedule_launches)
    y = fn()
    torch.cuda.synchronize()
    assert {k: v - s0[k] for k, v in kc.conv2d_fused.schedule_launches.items()
            } == {k: int(k == sched) for k in kc.SCHEDULES}
    return y


def _conv_inputs(g, N, H, W, CI, CO, k, bn, dt):
    x = _randn(g, N, H, W, CI, dt=dt)
    w = (torch.randn(k, k, CI, CO, generator=g, device="cuda")
         * (k * k * CI) ** -0.5).to(dt)
    bnp = tuple(torch.rand(CO, generator=g, device="cuda") + 0.5
                for _ in range(4)) if bn else None
    return x, w, bnp


@pytest.mark.parametrize("dt,name", [("bf16", n) for n in sorted(TC_CONVS)]
                         + [("fp32", n) for n in sorted(TC_CONVS)
                            + sorted(FFMA_CONVS)])
def test_conv2d_tensor_core_and_ffma_schedules(card, dt, name):
    """bf16 on wgmma, fp32 on ffma, each within its tolerance of the plain
    version, the same bits twice (the K splits summed in a fixed order)."""
    N, H, W, CI, CO, k, s, pad, bn, act = {**TC_CONVS, **FFMA_CONVS}[name]
    x, w, bnp = _conv_inputs(card, N, H, W, CI, CO, k, bn, DTYPES[dt])

    def run():
        return kc.conv2d_fused(x, w, stride=s, padding=pad, bn=bnp, act=act)
    y = _conv_ran("wgmma" if dt == "bf16" else "ffma", run)
    p = kc.conv2d_fused_plain(x, w, stride=s, padding=pad, bn=bnp, act=act)
    assert y.dtype == DTYPES[dt] and y.shape == p.shape
    assert torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL[dt]
    assert torch.equal(run(), y)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", ["gelu", "silu", "relu", "relu2", "sigmoid",
                                 "tanh"])
def test_conv2d_schedules_each_act(card, dt, act):
    """Every act after the BN fold, unsplit (8 x 40 x 40 pixels: 100
    blocks) and split (9 x 9 pixels: one block, K in 9 slabs)."""
    for N, H in ((8, 40), (1, 9)):
        x, w, bnp = _conv_inputs(card, N, H, H, 64, 64, 3, True, DTYPES[dt])
        y = _conv_ran("wgmma" if dt == "bf16" else "ffma",
                      lambda: kc.conv2d_fused(x, w, bn=bnp, act=act))
        p = kc.conv2d_fused_plain(x, w, bn=bnp, act=act)
        assert _rel(y, p) < TOL[dt]


def test_conv2d_simt_keeps_the_rest(card):
    """CI 12 in bf16, CI 10 in fp32 (CI neither under 8 nor a multiple of
    the mid_ci, tensor-core or FFMA step) and unaligned views (bf16 of CI
    32, which mid_ci takes aligned; fp32 of CI 16) run on simt, each within
    its tolerance of the plain version."""
    cases = [(12, 64, torch.bfloat16), (10, 64, torch.float32)]
    for CI, CO, dt in cases:
        x, w, bnp = _conv_inputs(card, 2, 16, 16, CI, CO, 3, True, dt)
        y = _conv_ran("simt", lambda: kc.conv2d_fused(x, w, bn=bnp,
                                                      act="relu"))
        assert _rel(y, kc.conv2d_fused_plain(x, w, bn=bnp, act="relu")) \
            < TOL["fp32" if dt == torch.float32 else "bf16"]
    for dt, CI, tol in ((torch.bfloat16, 32, "bf16"),
                        (torch.float32, 16, "fp32")):
        n = 2 * 8 * 8 * CI
        x = _randn(card, n + 1, dt=dt)[1:].view(2, 8, 8, CI)   # one element
        w = _randn(card, 3, 3, CI, 16, dt=dt) * CI ** -0.5
        y = _conv_ran("simt", lambda: kc.conv2d_fused(x, w))
        assert _rel(y, kc.conv2d_fused_plain(x, w)) < TOL[tol]


# conv2d_fused's mid_ci schedule (bf16, 8 <= CI < 64): the CPU model's cases
# (tests/test_torch_conv_mid_ci.py: CI 8-48, 1x1 and 3x3, strides 1 and 2,
# SAME and VALID, CO 72 for a ragged second strip at CI 16 and 48) at batch
# 2 on 11 x 9 images, and at the path's MobileNetV1 32 -> 64 1x1 conv (784
# tiles: about two a block)
MID_CI = [(ci, k, s, p) for ci in (8, 16, 32, 48) for k in (1, 3)
          for s in (1, 2) for p in ("SAME", "VALID")]


@pytest.mark.parametrize("ci,k,stride,padding", MID_CI,
                         ids=[f"ci{c}-k{k}-s{s}-{p}" for c, k, s, p in MID_CI])
def test_conv2d_mid_ci_schedule(card, ci, k, stride, padding):
    """Each case on mid_ci, within bf16 tolerance of the plain version,
    finite, and the same bits twice."""
    co = 72 if ci in (16, 48) else 64
    x, w, bnp = _conv_inputs(card, 2, 11, 9, ci, co, k, True, torch.bfloat16)

    def run():
        return kc.conv2d_fused(x, w, stride=stride, padding=padding, bn=bnp,
                               act="relu")
    y = _conv_ran("mid_ci", run)
    p = kc.conv2d_fused_plain(x, w, stride=stride, padding=padding, bn=bnp,
                              act="relu")
    assert y.dtype == torch.bfloat16 and y.shape == p.shape
    assert torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL["bf16"]
    assert torch.equal(run(), y)


@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "relu2",
                                 "sigmoid", "tanh"])
def test_conv2d_mid_ci_path_shape_each_act(card, act):
    """MobileNetV1's 32 -> 64 pointwise conv at 112 px, batch 8, with the
    BN fold and each act (the path's ReLU and none on their own
    instantiations), and bare; a 3x3 CI 24 conv with CO 136 (three strips)
    and the runtime-K loop."""
    for shape, k, bn in (((8, 112, 112, 32, 64), 1, True),
                         ((8, 112, 112, 32, 64), 1, False),
                         ((4, 30, 30, 24, 136), 3, True)):
        N, H, W, CI, CO = shape
        x, w, bnp = _conv_inputs(card, N, H, W, CI, CO, k, bn,
                                 torch.bfloat16)
        y = _conv_ran("mid_ci", lambda: kc.conv2d_fused(x, w, bn=bnp,
                                                        act=act))
        assert _rel(y, kc.conv2d_fused_plain(x, w, bn=bnp, act=act)) \
            < TOL["bf16"]


# conv2d_fused's small_ci schedule: (N, H, W, CI, CO, k, stride, padding,
# bn, act).  ResNet-34's stem at full size (fused as the opt flow runs it,
# bare as the base flow does) and on a small image, odd sizes (SAME's odd
# high row and column), VALID; MobileNetV1's first conv; LeNet-5's two
# convs (CO 6 and 16: no 16-byte output rows); CI 5 with CO 100 (two
# channel tiles, the second ragged); a ragged last tile row and column
SMALL_CI = {
    "stem_full": (8, 224, 224, 3, 64, 7, 2, "SAME", True, "relu"),
    "stem_full_bare": (8, 224, 224, 3, 64, 7, 2, "SAME", False, None),
    "stem_small": (2, 32, 32, 3, 64, 7, 2, "SAME", True, "relu"),
    "stem_odd": (2, 33, 31, 3, 64, 7, 2, "SAME", True, "relu"),
    "stem_valid": (2, 30, 29, 3, 64, 7, 2, "VALID", False, None),
    "mbv1_first": (2, 224, 224, 3, 32, 3, 2, "SAME", True, "relu"),
    "mbv1_odd_s1": (1, 19, 23, 3, 32, 3, 1, "SAME", True, "relu"),
    "lenet_c1": (8, 32, 32, 1, 6, 5, 1, "VALID", True, "relu"),
    "lenet_c3": (8, 14, 14, 6, 16, 5, 1, "VALID", True, "relu"),
    "ci5_co100": (2, 20, 20, 5, 100, 3, 1, "SAME", True, None),
}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(SMALL_CI))
def test_conv2d_small_ci_schedule(card, dt, name):
    """Each small_ci case on its schedule, within its tolerance of the
    plain version, finite, and the same bits twice."""
    N, H, W, CI, CO, k, s, pad, bn, act = SMALL_CI[name]
    x, w, bnp = _conv_inputs(card, N, H, W, CI, CO, k, bn, DTYPES[dt])

    def run():
        return kc.conv2d_fused(x, w, stride=s, padding=pad, bn=bnp, act=act)
    y = _conv_ran("small_ci", run)
    p = kc.conv2d_fused_plain(x, w, stride=s, padding=pad, bn=bnp, act=act)
    assert y.dtype == DTYPES[dt] and y.shape == p.shape
    assert torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL[dt]
    assert torch.equal(run(), y)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "relu2",
                                 "sigmoid", "tanh"])
def test_conv2d_small_ci_each_act(card, dt, act):
    """The stem's geometry with the BN fold and each act, and without BN."""
    for bn in (True, False):
        x, w, bnp = _conv_inputs(card, 2, 40, 40, 3, 64, 7, bn, DTYPES[dt])
        y = _conv_ran("small_ci", lambda: kc.conv2d_fused(
            x, w, stride=2, bn=bnp, act=act))
        p = kc.conv2d_fused_plain(x, w, stride=2, bn=bnp, act=act)
        assert _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_conv2d_small_ci_unaligned_views(card, dt):
    """x at a one-element offset (2 bytes in bf16, 4 in fp32: no halo row
    starts aligned), and w likewise: small_ci still takes them and
    matches."""
    d = DTYPES[dt]
    n = 2 * 24 * 24 * 3
    x = _randn(card, n + 1, dt=d)[1:].view(2, 24, 24, 3)
    w = _randn(card, 7 * 7 * 3 * 64 + 1, dt=d)[1:].view(7, 7, 3, 64) * 0.1
    wv = _randn(card, 7 * 7 * 3 * 64 + 1, dt=d)[1:].view(7, 7, 3, 64)
    for ww in (w, wv):
        y = _conv_ran("small_ci", lambda: kc.conv2d_fused(x, ww, stride=2))
        assert _rel(y, kc.conv2d_fused_plain(x, ww, stride=2)) < TOL[dt]


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


def _mm_inputs(g, M, K, N, glu, dt=torch.bfloat16):
    """x (M, K), w and w2 (K, N) scaled so that the products are O(1), and
    an fp32 bias."""
    x = _randn(g, M, K, dt=dt)
    w = (torch.randn(K, N, generator=g, device="cuda") * K ** -0.5).to(dt)
    w2 = ((torch.randn(K, N, generator=g, device="cuda") * K ** -0.5).to(dt)
          if glu else None)
    return x, w, w2, _randn(g, N)


def _schedule_ran(sched, fn):
    """Run fn; assert that it made one CW launch, on ``sched``."""
    n0 = km.matmul_fused.launches
    s0 = dict(km.matmul_fused.schedule_launches)
    y = fn()
    torch.cuda.synchronize()
    assert km.matmul_fused.launches == n0 + 1
    assert {k: v - s0[k] for k, v in km.matmul_fused.schedule_launches.items()
            } == {k: int(k == sched) for k in km.SCHEDULES}
    return y


# the wgmma schedule: (M, K, N, glu, act, out dtype): a ragged M (4095), N
# not a multiple of 128 (200, and 72 in the GLU form's 64-wide tiles), K of
# 16 stages with a 40-deep tail (1000), and the llama q shape
WGMMA = {
    "ragged": (4095, 1000, 200, False, "gelu", torch.bfloat16),
    "glu_ragged": (4095, 1000, 72, True, "silu", torch.bfloat16),
    "out_fp32": (300, 576, 136, False, None, torch.float32),
    "glu_out_fp32": (129, 512, 264, True, "gelu", torch.float32),
    "llama_q": (4096, 2048, 2048, False, None, torch.bfloat16),
    "llama_glu": (512, 2048, 8192, True, "silu", torch.bfloat16),
}


@pytest.mark.parametrize("name", sorted(WGMMA))
def test_matmul_wgmma_schedule(card, name):
    M, K, N, glu, act, odt = WGMMA[name]
    x, w, w2, b = _mm_inputs(card, M, K, N, glu)
    y = _schedule_ran("wgmma", lambda: km.matmul_fused(
        x, w, bias=b, w2=w2, act=act, out_dtype=odt))
    p = km.matmul_fused_plain(x, w, bias=b, w2=w2, act=act, out_dtype=odt)
    assert y.shape == (M, N) and y.dtype == odt
    assert torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL["bf16"]


@pytest.mark.parametrize("M,glu", [(1, False), (8, False), (40, False),
                                   (64, False), (1, True), (8, True),
                                   (32, True)])
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "relu2",
                                 "sigmoid", "tanh"])
def test_matmul_small_m_schedule(card, M, glu, act):
    """Decode rows (1, 8), a verify batch (40) and each form's crossover (64
    plain, 32 GLU), every act; two runs give the same bits (the splits are
    summed in a fixed order, no float atomics)."""
    x, w, w2, b = _mm_inputs(card, M, 2048, 520, glu)
    def run():
        return km.matmul_fused(x, w, bias=None if glu else b, w2=w2, act=act)
    y = _schedule_ran("small_m", run)
    p = km.matmul_fused_plain(x, w, bias=None if glu else b, w2=w2, act=act)
    assert y.shape == (M, 520) and y.dtype == torch.bfloat16
    assert _rel(y, p) < TOL["bf16"]
    assert torch.equal(run(), y)


def test_matmul_small_m_long_k_and_fp32_out(card):
    """The hybrid's down projection at 8 rows (K 7680: many splits), fp32
    out; a 24-deep K (one partial stage)."""
    for M, K, N in ((8, 7680, 2560), (3, 24, 16)):
        x, w, _, b = _mm_inputs(card, M, K, N, False)
        y = _schedule_ran("small_m", lambda: km.matmul_fused(
            x, w, bias=b, out_dtype=torch.float32))
        p = km.matmul_fused_plain(x, w, bias=b, out_dtype=torch.float32)
        assert y.dtype == torch.float32 and _rel(y, p) < TOL["bf16"]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_matmul_simt_schedule(card, dt):
    """K = 130 (not a multiple of 8) in bf16 at any M, and fp32 with K or N
    not a multiple of 4 at decode and prefill rows: both stay on the SIMT
    kernel, fp32 in full fp32."""
    shapes = ([(37, 130, 70), (8, 130, 64), (300, 130, 64)] if dt == "bf16"
              else [(37, 130, 70), (8, 514, 256), (1000, 512, 254)])
    for M, K, N in shapes:
        x, w, w2, b = _mm_inputs(card, M, K, N, True, DTYPES[dt])
        y = _schedule_ran("simt", lambda: km.matmul_fused(
            x, w, bias=b, w2=w2, act="gelu"))
        p = km.matmul_fused_plain(x, w, bias=b, w2=w2, act="gelu")
        assert y.dtype == DTYPES[dt] and _rel(y, p) < TOL[dt]


def test_matmul_schedules_take_unaligned_views(card):
    """A weight view 16-byte aligned runs on a tensor-core schedule; one that
    is not runs on simt, with the same result as the plain version."""
    x, w, _, _ = _mm_inputs(card, 8, 64, 1024, False)
    flat = w.reshape(-1)
    aligned = flat[8:8 + 64 * 1016].view(64, 1016)
    skewed = flat[4:4 + 64 * 1016].view(64, 1016)
    for view, sched in ((aligned, "small_m"), (skewed, "simt")):
        y = _schedule_ran(sched, lambda: km.matmul_fused(x, view))
        assert _rel(y, km.matmul_fused_plain(x, view)) < TOL["bf16"]


# the ffma schedule (fp32 operands): (M, K, N, glu, act, out dtype): a
# ragged M (4095), N not a multiple of the 128- or 64-wide tiles (200, 72),
# K of 62 stages with an 8-deep tail (1000), bf16 out, a one-stage K with a
# tail (20), the hybrid's k/v at 4096 rows (a grid under half a wave: K
# split in 3) and the llama q shape
FFMA = {
    "ragged": (4095, 1000, 200, False, "gelu", torch.float32),
    "glu_ragged": (4095, 1000, 72, True, "silu", torch.float32),
    "out_bf16": (300, 576, 136, False, None, torch.bfloat16),
    "glu_out_bf16": (129, 512, 264, True, "gelu", torch.bfloat16),
    "k_tail": (65, 20, 16, False, "relu", torch.float32),
    "split_k": (4096, 2560, 256, False, None, torch.float32),
    "llama_q": (4096, 2048, 2048, False, None, torch.float32),
}


@pytest.mark.parametrize("name", sorted(FFMA))
def test_matmul_ffma_schedule(card, name):
    """Each case on ffma, within fp32's tolerance of the plain version (full
    fp32: TF32 would miss it by far), the same bits twice."""
    M, K, N, glu, act, odt = FFMA[name]
    x, w, w2, b = _mm_inputs(card, M, K, N, glu, torch.float32)

    def run():
        return km.matmul_fused(x, w, bias=b, w2=w2, act=act, out_dtype=odt)
    y = _schedule_ran("ffma", run)
    p = km.matmul_fused_plain(x, w, bias=b, w2=w2, act=act, out_dtype=odt)
    assert y.shape == (M, N) and y.dtype == odt
    assert torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL["fp32" if odt == torch.float32 else "bf16"]
    assert torch.equal(run(), y)


@pytest.mark.parametrize("M,glu", [(1, False), (8, False), (40, False),
                                   (64, False), (1, True), (8, True),
                                   (32, True)])
@pytest.mark.parametrize("act", [None, "gelu", "silu", "relu", "relu2",
                                 "sigmoid", "tanh"])
def test_matmul_ffma_small_m_schedule(card, M, glu, act):
    """fp32 decode rows (1, 8), a verify batch (40) and each form's
    crossover (64 plain, 32 GLU), every act; two runs give the same bits
    (the splits are summed in a fixed order)."""
    x, w, w2, b = _mm_inputs(card, M, 2048, 520, glu, torch.float32)

    def run():
        return km.matmul_fused(x, w, bias=None if glu else b, w2=w2, act=act)
    y = _schedule_ran("ffma_small_m", run)
    p = km.matmul_fused_plain(x, w, bias=None if glu else b, w2=w2, act=act)
    assert y.shape == (M, 520) and y.dtype == torch.float32
    assert _rel(y, p) < TOL["fp32"]
    assert torch.equal(run(), y)


def test_matmul_ffma_small_m_long_k_and_bf16_out(card):
    """The hybrid's down projection at 8 rows (K 7680: many splits), a
    24-deep K (one partial stage) with a ragged N, bf16 out."""
    for M, K, N, odt in ((8, 7680, 2560, torch.float32),
                         (3, 24, 20, torch.bfloat16)):
        x, w, _, b = _mm_inputs(card, M, K, N, False, torch.float32)
        y = _schedule_ran("ffma_small_m", lambda: km.matmul_fused(
            x, w, bias=b, out_dtype=odt))
        p = km.matmul_fused_plain(x, w, bias=b, out_dtype=odt)
        assert y.dtype == odt
        assert _rel(y, p) < TOL["fp32" if odt == torch.float32 else "bf16"]


# the base variant's routes: (M, K, N, tile, act, {dtype: schedule})
BASE = [
    (8, 512, 1000, (256, 512, 256), None,        # the ResNet FC, one slab
     {"bf16": "small_m", "fp32": "ffma_small_m"}),
    (100, 1000, 72, (32, 64, 32), "relu",        # 16 slabs, a 40-deep tail
     {"bf16": "wgmma", "fp32": "ffma"}),
    (3, 200, 40, (8, 40, 8), "gelu",             # 40-deep slabs: simt
     {"bf16": "simt", "fp32": "simt"}),
    (24, 1024, 136, (8, 128, 32), "silu",        # 8 slabs, split finer
     {"bf16": "small_m", "fp32": "ffma_small_m"}),
    (300, 1536, 264, (256, 512, 256), None,      # 3 slabs, ragged tiles
     {"bf16": "wgmma", "fp32": "ffma"}),
    (1152, 2048, 1024, (256, 512, 256), "relu",  # 4 slabs; 72 ffma blocks:
     {"bf16": "wgmma", "fp32": "ffma"}),         # unsplit in fp32 out
    (8, 120, 84, (256, 512, 256), "relu",        # N off bf16's 8-grid,
     {"bf16": "simt", "fp32": "ffma_small_m"}),  # on fp32's 4-grid
]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("odt", ["same", "bf16"])
@pytest.mark.parametrize("M,K,N,tile,act,want", BASE,
                         ids=[f"{c[0]}x{c[1]}x{c[2]}" for c in BASE])
def test_matmul_base_variant_kernel(card, dt, odt, M, K, N, tile, act, want):
    """Each route of the base variant (the CW cores and the SIMT base
    kernel) within its tolerance of the plain version, counted under its
    schedule and not as a CW launch, with the same bits twice; in the
    input dtype and in bf16 out."""
    x, w, _, b = _mm_inputs(card, M, K, N, False, DTYPES[dt])
    o = DTYPES[dt] if odt == "same" else torch.bfloat16
    n0, b0 = km.matmul_fused.launches, km.matmul_fused.base_launches
    s0 = dict(km.matmul_fused.base_schedule_launches)

    def run():
        return km.matmul_fused(x, w, bias=b, act=act, tile=tile,
                               vmem_accum=False, out_dtype=o)
    y = run()
    torch.cuda.synchronize()
    assert km.matmul_fused.base_launches == b0 + 1
    assert km.matmul_fused.launches == n0
    assert {k: v - s0[k] for k, v in
            km.matmul_fused.base_schedule_launches.items()} == \
        {k: int(k == want[dt]) for k in km.SCHEDULES}
    p = km.matmul_fused_plain(x, w, bias=b, act=act, tile=tile,
                              vmem_accum=False, out_dtype=o)
    assert y.shape == (M, N) and y.dtype == o
    assert _rel(y, p) < TOL["fp32" if o == torch.float32 else "bf16"]
    assert torch.equal(run(), y)
    with pytest.raises(ValueError):
        km.matmul_fused(x, w, w2=w, vmem_accum=False)


def test_matmul_base_variant_unaligned_views_on_simt(card):
    """An unaligned bf16 x (2-byte offset) takes the SIMT base kernel and
    matches."""
    flat = _randn(card, 8 * 512 + 1, dt=torch.bfloat16)
    x = flat[1:].view(8, 512)
    w = _randn(card, 512, 256, dt=torch.bfloat16) * 512 ** -0.5
    s0 = km.matmul_fused.base_schedule_launches["simt"]
    y = km.matmul_fused(x, w, tile=(8, 128, 8), vmem_accum=False)
    torch.cuda.synchronize()
    assert km.matmul_fused.base_schedule_launches["simt"] == s0 + 1
    assert _rel(y, km.matmul_fused_plain(x, w, tile=(8, 128, 8),
                                         vmem_accum=False)) < TOL["bf16"]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(FLASH))
def test_flash_attention_kernel(card, name, dt):
    B, Sq, Skv, H, KV, D, causal, win, off = FLASH[name]
    q = _randn(card, B, Sq, H, D, dt=DTYPES[dt])
    k = _randn(card, B, Skv, KV, D, dt=DTYPES[dt])
    v = _randn(card, B, Skv, KV, D, dt=DTYPES[dt])
    n0 = ka.flash_attention.launches
    s0 = dict(ka.flash_attention.schedules)
    y = ka.flash_attention(q, k, v, causal=causal, window=win, q_offset=off)
    torch.cuda.synchronize()
    assert ka.flash_attention.launches == n0 + 1
    # at D >= 64 bf16 on the tensor cores and fp32 on the ffma kernel; at
    # 16 and 32 both on the SIMT kernel
    sched = "simt" if D < 64 else "wgmma" if dt == "bf16" else "ffma"
    assert {k_: n - s0[k_] for k_, n in ka.flash_attention.schedules.items()
            } == {k_: int(k_ == sched) for k_ in ka.SCHEDULES}
    p = ka.flash_attention_plain(q, k, v, causal=causal, window=win,
                                 q_offset=off)
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert torch.isfinite(y.float()).all()
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


@pytest.mark.parametrize("D,H,KV,window", [(64, 32, 8, None),
                                           (128, 8, 2, 48),
                                           (256, 10, 1, 2048)])
def test_flash_attention_wgmma_positions_softcap(card, D, H, KV, window):
    """The serving engine's left-padded prefill buckets on the wgmma
    schedule: per-row positions (-1 on the padding, one row with more pad
    than a 128-row block), a softcap; the valid query rows agree."""
    B, S = 3, 200
    pad = torch.tensor([0, 7, 150], device="cuda")
    ar = torch.arange(S, device="cuda")
    pos = torch.where(ar[None] >= pad[:, None], ar[None] - pad[:, None],
                      torch.full_like(ar[None], -1)).to(torch.int32)
    q = _randn(card, B, S, H, D, dt=torch.bfloat16)
    k = _randn(card, B, S, KV, D, dt=torch.bfloat16)
    v = _randn(card, B, S, KV, D, dt=torch.bfloat16)
    w0 = ka.flash_attention.schedules["wgmma"]
    y = ka.flash_attention(q, k, v, positions=pos, softcap=5.0,
                           window=window)
    torch.cuda.synchronize()
    assert ka.flash_attention.schedules["wgmma"] == w0 + 1
    p = ka.flash_attention_plain(q, k, v, positions=pos, softcap=5.0,
                                 window=window)
    keep = pos >= 0
    assert torch.isfinite(y[keep].float()).all()
    assert _rel(y[keep], p[keep]) < TOL["bf16"]


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_wgmma_repeats_its_bits(card, D):
    """Two calls on the same inputs give the same bits (no atomics), also
    from an unaligned view of q (copied to a 16-byte aligned one)."""
    B, S, H, KV = 2, 300, 8, 2
    q = _randn(card, B, S, H, D, dt=torch.bfloat16)
    k = _randn(card, B, S, KV, D, dt=torch.bfloat16)
    v = _randn(card, B, S, KV, D, dt=torch.bfloat16)
    y1 = ka.flash_attention(q, k, v, window=100)
    y2 = ka.flash_attention(q, k, v, window=100)
    assert torch.equal(y1, y2)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    skew = flat[1:].view(q.shape)
    skew.copy_(q)
    assert skew.data_ptr() % 16 != 0
    assert torch.equal(ka.flash_attention(skew, k, v, window=100), y1)


@pytest.mark.parametrize("D,H,KV,window", [(64, 32, 8, None),
                                           (128, 20, 20, 48),
                                           (256, 10, 1, 2048)])
def test_flash_attention_ffma_positions_softcap(card, D, H, KV, window):
    """The serving engine's left-padded prefill buckets on the ffma
    schedule: per-row positions (-1 on the padding, one row with more pad
    than a 128-row block), a softcap; the valid query rows agree at fp32's
    tolerance."""
    B, S = 3, 200
    pad = torch.tensor([0, 7, 150], device="cuda")
    ar = torch.arange(S, device="cuda")
    pos = torch.where(ar[None] >= pad[:, None], ar[None] - pad[:, None],
                      torch.full_like(ar[None], -1)).to(torch.int32)
    q = _randn(card, B, S, H, D)
    k = _randn(card, B, S, KV, D)
    v = _randn(card, B, S, KV, D)
    f0 = ka.flash_attention.schedules["ffma"]
    y = ka.flash_attention(q, k, v, positions=pos, softcap=5.0,
                           window=window)
    torch.cuda.synchronize()
    assert ka.flash_attention.schedules["ffma"] == f0 + 1
    p = ka.flash_attention_plain(q, k, v, positions=pos, softcap=5.0,
                                 window=window)
    keep = pos >= 0
    assert torch.isfinite(y[keep]).all()
    assert _rel(y[keep], p[keep]) < TOL["fp32"]


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_ffma_repeats_its_bits(card, D):
    """Two calls on the same inputs give the same bits (no atomics), also
    from an unaligned view of q (copied to a 16-byte aligned one)."""
    B, S, H, KV = 2, 300, 8, 2
    q = _randn(card, B, S, H, D)
    k = _randn(card, B, S, KV, D)
    v = _randn(card, B, S, KV, D)
    y1 = ka.flash_attention(q, k, v, window=100)
    y2 = ka.flash_attention(q, k, v, window=100)
    assert torch.equal(y1, y2)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")
    skew = flat[1:].view(q.shape)
    skew.copy_(q)
    assert skew.data_ptr() % 16 != 0
    assert torch.equal(ka.flash_attention(skew, k, v, window=100), y1)


def test_flash_attention_ffma_tiles(card):
    """The kernel's tiles and shared bytes per head width and query rows
    are those the wrapper's tables state (``FFMA_TILES`` by default,
    ``FFMA_RING``, ``_ffma_smem_bytes``); it refuses the rest."""
    import ctypes
    from repro_torch.kernels import _build
    for D in ka.TILED_HEAD_DIMS:
        got = (ctypes.c_int * 5)()
        _build.call("flash_attention_ffma_tiles", D, ka.FFMA_TILES[D][0],
                    ctypes.addressof(got))
        assert tuple(got) == (*ka.FFMA_TILES[D], ka._ffma_smem_bytes(D))
    for (D, bq), (slots, blocks) in ka.FFMA_RING.items():
        got = (ctypes.c_int * 5)()
        _build.call("flash_attention_ffma_tiles", D, bq,
                    ctypes.addressof(got))
        assert tuple(got) == (bq, 64, slots, blocks,
                              ka._ffma_smem_bytes(D, bq))
    for D, bq in ((32, 64), (256, 128), (64, 96)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            _build.call("flash_attention_ffma_tiles", D, bq,
                        ctypes.addressof((ctypes.c_int * 5)()))


# flash_attention at every Hopper tile: (B, Sq, Skv, H, KV, window,
# q_offset) cutting the 64- and 128-row blocks, GQA, a window and an offset
FLASH_TILED = {"ragged_gqa": (2, 200, 200, 8, 2, None, 0),
               "window": (2, 300, 300, 4, 1, 90, 0),
               "q_offset": (2, 70, 200, 4, 2, None, 130)}


@pytest.mark.parametrize("tile", ka.TILES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", ka.TILED_HEAD_DIMS)
@pytest.mark.parametrize("case", sorted(FLASH_TILED))
def test_flash_attention_at_each_tile(card, case, D, dt, tile):
    """wgmma (bf16) and ffma (fp32) at each tile they take, against the
    plain version, counted under the tile; ffma refuses (128, 64) at D 256
    before any launch."""
    B, Sq, Skv, H, KV, window, off = FLASH_TILED[case]
    dtype = DTYPES[dt]
    q = _randn(card, B, Sq, H, D, dt=dtype)
    k = _randn(card, B, Skv, KV, D, dt=dtype)
    v = _randn(card, B, Skv, KV, D, dt=dtype)
    sched = ka._schedule(dtype, D)
    n0 = ka.flash_attention.launches
    if sched == "ffma" and (D, tile[0]) not in ka.FFMA_RING:
        with pytest.raises(ValueError, match="takes no tile"):
            ka.flash_attention(q, k, v, window=window, q_offset=off,
                               tile=tile)
        assert ka.flash_attention.launches == n0
        return
    t0 = ka.flash_attention.tiles.get((sched, tile), 0)
    y = ka.flash_attention(q, k, v, window=window, q_offset=off, tile=tile)
    p = ka.flash_attention_plain(q, k, v, window=window, q_offset=off)
    assert _rel(y, p) < TOL[dt]
    assert ka.flash_attention.tiles[(sched, tile)] == t0 + 1


# conv2d_fused at every Hopper tile: (N, H, CI, CO, k, stride), a conv of 64
# output channels (bn 64 under either tile) among them
CONV_TILED = {"c64": (2, 14, 64, 64, 3, 1), "c128s2": (2, 15, 64, 128, 3, 2),
              "c192": (2, 9, 128, 192, 3, 1), "p1x1": (3, 7, 128, 256, 1, 1)}


@pytest.mark.parametrize("tile", kc.TILES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CONV_TILED))
def test_conv2d_at_each_tile(card, case, dt, tile):
    N, H, CI, CO, kk, s = CONV_TILED[case]
    dtype = DTYPES[dt]
    x = _randn(card, N, H, H, CI, dt=dtype)
    w = (_randn(card, kk, kk, CI, CO) * (kk * kk * CI) ** -0.5).to(dtype)
    bn = [torch.rand(CO, device="cuda") + 0.5 for _ in range(4)]
    sched = kc._schedule(CI, CO, dtype, True, (kk, kk, s))
    assert sched == ("wgmma" if dt == "bf16" else "ffma")
    block = kc.block_of(sched, CO, tile)
    t0 = kc.conv2d_fused.tiles.get((sched, block), 0)
    y = kc.conv2d_fused(x, w, stride=s, bn=bn, act="relu", tile=tile)
    p = kc.conv2d_fused_plain(x, w, stride=s, bn=bn, act="relu")
    assert _rel(y, p) < TOL[dt]
    assert kc.conv2d_fused.tiles[(sched, block)] == t0 + 1
    assert block == ((128, 64) if CO == 64 else tile)


@pytest.mark.parametrize("tile", km.TILES)
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("M,K,N,glu", [(300, 512, 520, False),
                                       (4096, 2048, 2048, False),
                                       (200, 256, 384, True)])
def test_matmul_at_each_tile(card, M, K, N, glu, dt, tile):
    dtype = DTYPES[dt]
    x = _randn(card, M, K, dt=dtype)
    w = (_randn(card, K, N) * K ** -0.5).to(dtype)
    w2 = (_randn(card, K, N) * K ** -0.5).to(dtype) if glu else None
    b = None if glu else _randn(card, N) * 0.1
    sched = km._schedule(M, K, N, dtype, glu, True)
    assert sched == ("wgmma" if dt == "bf16" else "ffma")
    block = km.block_of(sched, glu, tile)
    t0 = km.matmul_fused.tiles.get((sched, block), 0)
    y = km.matmul_fused(x, w, bias=b, w2=w2, act="gelu", tile=tile)
    p = km.matmul_fused_plain(x, w, bias=b, w2=w2, act="gelu")
    assert _rel(y, p) < TOL[dt]
    assert km.matmul_fused.tiles[(sched, block)] == t0 + 1


def test_a_tile_no_kernel_takes_raises(card):
    """A TPU tile reaching a hand kernel raises at dispatch; no block is
    put in its place and nothing launches."""
    x = _randn(card, 256, 128, dt=torch.bfloat16)
    w = _randn(card, 128, 128, dt=torch.bfloat16)
    n0 = km.matmul_fused.launches
    with pytest.raises(ValueError, match="no kernel takes the tile"):
        km.matmul_fused(x, w, tile=(256, 512, 256))
    q = _randn(card, 1, 64, 2, 64, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel takes the tile"):
        ka.flash_attention(q, q, q, tile=(128, 128))
    xi = _randn(card, 1, 8, 8, 64, dt=torch.bfloat16)
    wi = _randn(card, 3, 3, 64, 64, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel takes the tile"):
        kc.conv2d_fused(xi, wi, tile=(8, 128))
    assert km.matmul_fused.launches == n0


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


# the mma (bf16) and ffma (fp32) schedules of csrc/decode_core.cuh: the
# main path's heads at head widths 64, 128 and 256
CORE_HEADS = {64: (32, 8), 128: (20, 20), 256: (10, 1)}
CORE_SCHED = {"bf16": "mma", "fp32": "ffma"}


def _one_kernel(fn):
    """The CUDA kernels one call of ``fn`` launches (after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _rolling(g, B, C, H, KV, D, dt, qpos, wrap=False, dead_ends=0):
    q = _randn(g, B, 1, H, D, dt=dt)
    kc, vc = _randn(g, B, C, KV, D, dt=dt), _randn(g, B, C, KV, D, dt=dt)
    ar = torch.arange(C, device="cuda", dtype=torch.int32)
    lo = max(0, qpos - C + 1) if wrap else 0
    slot = lo + (ar - lo) % C
    pos = torch.where(slot <= qpos, slot, torch.full_like(ar, -1))
    if dead_ends:
        pos[:dead_ends] = -1
        pos[C - dead_ends:] = -1
    qp = torch.full((B, 1), qpos, dtype=torch.int32, device="cuda")
    return q, kc, vc, pos.expand(B, C).contiguous(), qp


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("case", ["window_softcap", "wrapped",
                                  "empty_ends"])
def test_decode_attention_core_schedules(card, case, D, dt):
    """mma and ffma against the plain version: a window that cuts and a
    softcap, a wrapped rolling cache, empty tiles at both ends; each call
    one launch on its schedule, bits that repeat."""
    H, KV = CORE_HEADS[D]
    args = {"window_softcap": (2, 300, 150, False, 0),
            "wrapped": (1, 512, 700, True, 0),
            "empty_ends": (3, 256, 400, True, 40)}[case]
    B, C, qpos, wrap, ends = args
    q, kc, vc, pos, qp = _rolling(card, B, C, H, KV, D, DTYPES[dt], qpos,
                                  wrap, ends)
    kw = dict(window=64, softcap=30.0) if case == "window_softcap" \
        else dict(window=None, softcap=None)
    s0 = dict(kd.decode_attention.schedules)
    n0 = kd.decode_attention.launches
    y = kd.decode_attention(q, kc, vc, pos, qp, **kw)
    y2 = kd.decode_attention(q, kc, vc, pos, qp, **kw)
    torch.cuda.synchronize()
    assert kd.decode_attention.launches == n0 + 2
    assert {k: v - s0[k] for k, v in kd.decode_attention.schedules.items()
            } == {"mma": 0, "ffma": 0, "simt": 0, CORE_SCHED[dt]: 2}
    assert torch.equal(y, y2)
    p = kd.decode_attention_plain(q, kc, vc, pos, qp, **kw)
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert torch.isfinite(y.float()).all() and _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_attention_core_one_launch_and_empty_rows(card, dt):
    """A call of the core is one kernel, with several splits (the last
    block combines them); a row with no valid slot gets zeros (the plain
    version gives the mean of V there; the main path has no such row)."""
    q, kc, vc, pos, qp = _rolling(card, 8, 1024, 10, 1, 256, DTYPES[dt],
                                  542)
    nsplit, _ = kd.splits(8, 1024, 1, 10, 256, DTYPES[dt],
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count)
    assert nsplit > 1
    names = _one_kernel(lambda: kd.decode_attention(q, kc, vc, pos, qp))
    assert len(names) == 1 and "decode_core_kernel" in names[0]
    pos[3] = -1
    y = kd.decode_attention(q, kc, vc, pos, qp)
    p = kd.decode_attention_plain(q, kc, vc, pos, qp)
    torch.cuda.synchronize()
    assert (y[3] == 0).all()
    keep = torch.arange(8, device="cuda") != 3
    assert _rel(y[keep], p[keep]) < TOL[dt]


def _core_paged_inputs(g, bs, sq, D, dt, pad=True):
    H, KV = CORE_HEADS[D]
    B = 3
    nblk = 1024 // bs
    NB = 1 + B * nblk
    q = _randn(g, B, sq, H, D, dt=dt)
    kp, vp = _randn(g, NB, bs, KV, D, dt=dt), _randn(g, NB, bs, KV, D, dt=dt)
    perm = torch.randperm(B * nblk, generator=g, device="cuda")
    bt = (1 + perm.reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor([5, 300, 1000 - sq], dtype=torch.int32, device="cuda")
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device="cuda")[None]
    if sq > 1 and pad:
        qpos[0, sq // 2:] = -1                          # padding rows
    return q, kp, vp, bt, lens, qpos


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("bs,sq", [(8, 1), (16, 1), (8, 5), (16, 5)])
def test_paged_decode_attention_core_schedules(card, bs, sq, D, dt):
    """mma and ffma over the pool against the plain version: blocks of 8
    and 16, a decode tick and a five-query row with padding rows (qpos <
    0, zeros from the core), a window on the five-query rows and a
    softcap at bs 8; each call one launch on its schedule, bits that
    repeat."""
    q, kp, vp, bt, lens, qpos = _core_paged_inputs(card, bs, sq, D,
                                                   DTYPES[dt])
    kw = dict(qpos=qpos if sq > 1 else None,
              window=100 if sq > 1 else None,
              softcap=30.0 if bs == 8 else None)
    s0 = dict(kd.paged_decode_attention.schedules)
    y = kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    y2 = kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert {k: v - s0[k] for k, v in
            kd.paged_decode_attention.schedules.items()
            } == {"mma": 0, "ffma": 0, "simt": 0, CORE_SCHED[dt]: 2}
    assert torch.equal(y, y2)
    p = kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    live = qpos >= 0
    assert torch.isfinite(y[live].float()).all()
    assert _rel(y[live], p[live]) < TOL[dt]
    assert (y[~live] == 0).all()
    names = _one_kernel(
        lambda: kd.paged_decode_attention(q, kp, vp, bt, lens, **kw))
    assert len(names) == 1 and "decode_core_kernel" in names[0]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_decode_attention_core_table_slices(card, dt, sq):
    """Rows of more than TABLE_WHOLE blocks: each block loads the slice of
    the table that covers its split (a second round trip) in place of the
    whole row."""
    B, H, KV, D, bs, nblk = 2, 8, 2, 64, 4, 1100
    assert kd._table_entries(nblk, bs) < nblk
    q = _randn(card, B, sq, H, D, dt=DTYPES[dt])
    kp = _randn(card, 1 + B * nblk, bs, KV, D, dt=DTYPES[dt])
    vp = _randn(card, 1 + B * nblk, bs, KV, D, dt=DTYPES[dt])
    perm = torch.randperm(B * nblk, generator=card, device="cuda")
    bt = (1 + perm.reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor([3000, 4390 - sq], dtype=torch.int32, device="cuda")
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device="cuda")[None]
    kw = dict(qpos=qpos if sq > 1 else None, window=1000)
    s0 = kd.paged_decode_attention.schedules[CORE_SCHED[dt]]
    y = kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert kd.paged_decode_attention.schedules[CORE_SCHED[dt]] == s0 + 1
    p = kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    assert torch.isfinite(y.float()).all() and _rel(y, p) < TOL[dt]


def test_decode_core_shared_bytes(card):
    """The kernel's shared bytes per schedule and width are those the
    wrapper's mirror states (``_core_smem``, the basis of the one-wave
    split rule)."""
    from repro_torch.kernels import _build
    lib = _build.LIBRARY.get()
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        for D in kd.TILED_HEAD_DIMS:
            for extra in (0, 81, 2048):
                assert lib.decode_core_smem(code, D, extra) == \
                    kd._core_smem(dt, D, extra)
    assert lib.decode_core_smem(1, 32, 0) == -1

# the rest of the dense family's heads (H, KV, D): phi4-mini-3.8b's group of
# 3 query heads a KV head at width 128, stablelm-1.6b's group of 1 at 64
# over 32 KV heads
DENSE_HEADS = {"phi4": (24, 8, 128), "stablelm": (32, 32, 64)}
FLASH_SCHED = {"bf16": "wgmma", "fp32": "ffma"}


def _dense_call(g, kernel, H, KV, D, dt):
    """(wrapper, kernel call, plain call) of one attention kernel at a
    model's heads: flash at 2 x 200 causal tokens, decode over a
    1024-slot cache holding 543 positions (8 rows), paged at a decode tick
    (8 rows of 505-533 tokens in blocks of 16)."""
    if kernel == "flash":
        q = _randn(g, 2, 200, H, D, dt=dt)
        k, v = _randn(g, 2, 200, KV, D, dt=dt), _randn(g, 2, 200, KV, D, dt=dt)
        return (ka.flash_attention,
                lambda: ka.flash_attention(q, k, v, causal=True),
                lambda: ka.flash_attention_plain(q, k, v, causal=True))
    if kernel == "decode":
        args = _rolling(g, 8, 1024, H, KV, D, dt, 542)
        return (kd.decode_attention, lambda: kd.decode_attention(*args),
                lambda: kd.decode_attention_plain(*args))
    bs, nblk = 16, 64
    NB = 1 + 8 * nblk
    q = _randn(g, 8, 1, H, D, dt=dt)
    kp, vp = _randn(g, NB, bs, KV, D, dt=dt), _randn(g, NB, bs, KV, D, dt=dt)
    perm = torch.randperm(8 * nblk, generator=g, device="cuda")
    bt = (1 + perm.reshape(8, nblk)).to(torch.int32)
    lens = torch.arange(505, 537, 4, dtype=torch.int32, device="cuda")
    return (kd.paged_decode_attention,
            lambda: kd.paged_decode_attention(q, kp, vp, bt, lens),
            lambda: kd.paged_decode_attention_plain(q, kp, vp, bt, lens))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("model", sorted(DENSE_HEADS))
@pytest.mark.parametrize("kernel", ["flash", "decode", "paged"])
def test_dense_family_heads_on_their_schedules(card, kernel, model, dt):
    """flash, decode and paged attention at phi4-mini-3.8b's and
    stablelm-1.6b's heads against their plain versions, each call one
    launch counted under its schedule (flash: wgmma / ffma; decode and
    paged: mma / ffma), bits that repeat."""
    H, KV, D = DENSE_HEADS[model]
    fn, kern, plain = _dense_call(card, kernel, H, KV, D, DTYPES[dt])
    sched = FLASH_SCHED[dt] if kernel == "flash" else CORE_SCHED[dt]
    n0, s0 = fn.launches, dict(fn.schedules)
    y, y2 = kern(), kern()
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert {k: v - s0[k] for k, v in fn.schedules.items()} == \
        {k: 2 * (k == sched) for k in s0}
    assert torch.equal(y, y2)
    p = plain()
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert torch.isfinite(y.float()).all() and _rel(y, p) < TOL[dt]


# the MoE family's and llava-next-mistral-7b's head geometries at their
# paths' lengths: (kernel, H, KV, D, tokens or cache slots, query position,
# window).  deepseek-moe-16b: 16 over 16 heads of 128; mixtral-8x7b: 32
# over 8 (groups of 4) with its 4096-token window; llava: 32 over 8, a
# 1024-token prefill and a 2048-slot cache
NEW_HEADS = {
    "deepseek_flash_s512": ("flash", 16, 16, 128, 512, None, None),
    "mixtral_flash_s512_window": ("flash", 32, 8, 128, 512, None, 4096),
    "llava_flash_s1024": ("flash", 32, 8, 128, 1024, None, None),
    "deepseek_decode_c1024": ("decode", 16, 16, 128, 1024, 542, None),
    "mixtral_decode_c1024_window": ("decode", 32, 8, 128, 1024, 542, 4096),
    "llava_decode_c2048": ("decode", 32, 8, 128, 2048, 1039, None),
    "deepseek_paged": ("paged", 16, 16, 128, None, None, None),
    "mixtral_paged_window": ("paged", 32, 8, 128, None, None, 4096),
}


def _new_heads_call(g, case, dt):
    kernel, H, KV, D, n, qpos, window = NEW_HEADS[case]
    if kernel == "flash":
        q = _randn(g, 2, n, H, D, dt=dt)
        k, v = _randn(g, 2, n, KV, D, dt=dt), _randn(g, 2, n, KV, D, dt=dt)
        return (ka.flash_attention,
                lambda: ka.flash_attention(q, k, v, causal=True,
                                           window=window),
                lambda: ka.flash_attention_plain(q, k, v, causal=True,
                                                 window=window))
    if kernel == "decode":
        args = _rolling(g, 8, n, H, KV, D, dt, qpos)
        return (kd.decode_attention,
                lambda: kd.decode_attention(*args, window=window),
                lambda: kd.decode_attention_plain(*args, window=window))
    bs, nblk = 16, 64
    q = _randn(g, 8, 1, H, D, dt=dt)
    kp, vp = (_randn(g, 1 + 8 * nblk, bs, KV, D, dt=dt) for _ in range(2))
    perm = torch.randperm(8 * nblk, generator=g, device="cuda")
    bt = (1 + perm.reshape(8, nblk)).to(torch.int32)
    lens = torch.arange(505, 537, 4, dtype=torch.int32, device="cuda")
    return (kd.paged_decode_attention,
            lambda: kd.paged_decode_attention(q, kp, vp, bt, lens,
                                              window=window),
            lambda: kd.paged_decode_attention_plain(q, kp, vp, bt, lens,
                                                    window=window))


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(NEW_HEADS))
def test_moe_and_vlm_heads_on_their_schedules(card, case, dt):
    """flash, decode and paged attention at the heads and lengths of the
    MoE family's and llava's paths against their plain versions, each call
    one launch counted under its schedule (flash: wgmma / ffma; decode and
    paged: mma / ffma), bits that repeat."""
    fn, kern, plain = _new_heads_call(card, case, DTYPES[dt])
    sched = FLASH_SCHED[dt] if NEW_HEADS[case][0] == "flash" \
        else CORE_SCHED[dt]
    n0, s0 = fn.launches, dict(fn.schedules)
    y, y2 = kern(), kern()
    torch.cuda.synchronize()
    assert fn.launches == n0 + 2
    assert {k: v - s0[k] for k, v in fn.schedules.items()} == \
        {k: 2 * (k == sched) for k in s0}
    assert torch.equal(y, y2)
    p = plain()
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert torch.isfinite(y.float()).all() and _rel(y, p) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_decode_core_one_split_beside_many(card, dt):
    """stablelm-1.6b's decode cache takes one split a group (no workspace,
    no ticket), phi4-mini-3.8b's several (the last block combines them by
    ticket): calls of the two in turn each give the plain version's
    result and the bits of their first call, so neither leaves the other
    a ticket."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    calls = {}
    for model, (H, KV, D) in DENSE_HEADS.items():
        _, kern, plain = _dense_call(card, "decode", H, KV, D, DTYPES[dt])
        calls[model] = (kern, plain(), kd.splits(8, 1024, KV, H // KV, D,
                                                 DTYPES[dt], sms)[0])
    assert calls["stablelm"][2] == 1 and calls["phi4"][2] > 1
    first = {}
    for _ in range(3):
        for model, (kern, p, _) in calls.items():
            y = kern()
            torch.cuda.synchronize()
            assert _rel(y, p) < TOL[dt], model
            assert torch.equal(first.setdefault(model, y), y), model


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


# decode_attention at pinned chunks: (H, KV, D) of the main path's heads
# and of the simt widths, over a wrapped 1000-slot cache of 2 rows
TILE_HEADS = {64: (32, 8), 128: (20, 20), 256: (10, 1), 32: (8, 2)}


def _chunks(C, G, D, dt):
    """A few chunks check_tile accepts, from the least up to MAX_CHUNK, and
    the auto split's."""
    least = kd.least_tile(C, G, D, dt)
    step = kd.SLOTS if kd._schedule(dt, D) == "simt" else kd.TILE
    return sorted({least, least + step, 256, 512, kd.MAX_CHUNK}
                  - {c for c in (256, 512) if c < least})


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D", sorted(TILE_HEADS))
def test_decode_attention_at_each_tile(card, D, dt):
    """mma (bf16), ffma (fp32) and simt (D 32) at each chunk the rules
    accept, against the plain version, each launch counted under its
    chunk (``retiled`` off the auto split only); a refused chunk raises
    before any launch."""
    H, KV = TILE_HEADS[D]
    dtype = DTYPES[dt]
    B, C, G = 2, 1000, H // KV
    q, kc, vc, pos, qp = _rolling(card, B, C, H, KV, D, dtype, 1500,
                                  wrap=True)
    kw = dict(window=700, softcap=30.0)
    p = kd.decode_attention_plain(q, kc, vc, pos, qp, **kw)
    sched = kd._schedule(dtype, D)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    auto = (kd._simt_splits(B, C, KV, n_sm) if sched == "simt"
            else kd.splits(B, C, KV, G, D, dtype, n_sm))[1]
    for chunk in _chunks(C, G, D, dtype):
        t0 = kd.decode_attention.tiles.get((sched, chunk), 0)
        r0 = kd.decode_attention.retiled
        y = kd.decode_attention(q, kc, vc, pos, qp, tile=chunk, **kw)
        torch.cuda.synchronize()
        assert _rel(y, p) < TOL[dt], chunk
        assert kd.decode_attention.tiles[(sched, chunk)] == t0 + 1
        assert kd.decode_attention.retiled == r0 + (chunk != auto)
    t0 = kd.decode_attention.tiles.get((sched, auto), 0)
    r0 = kd.decode_attention.retiled
    y = kd.decode_attention(q, kc, vc, pos, qp, tile="auto", **kw)
    assert kd.decode_attention.tiles[(sched, auto)] == t0 + 1
    assert kd.decode_attention.retiled == r0 and _rel(y, p) < TOL[dt]
    n0 = kd.decode_attention.launches
    for bad in (kd.least_tile(C, G, D, dtype) - 16, 520, kd.MAX_CHUNK + 64):
        with pytest.raises(ValueError, match="decode_attention"):
            kd.decode_attention(q, kc, vc, pos, qp, tile=bad, **kw)
    assert kd.decode_attention.launches == n0


@pytest.mark.parametrize("prec", ["bf16", "fp32"])
def test_decode_tile_override_reaches_the_kernel(card, prec):
    """``FlowConfig(tile_overrides=(("decode_attention", n),))`` pins the
    chunk of every decode step of smoke llama3.2-1b (head width 16: the
    simt schedule; chip_smoke.py's phase 22 pins mma and ffma at full
    width): the counters show n,
    and the logits are the default flow's (which launches at the auto
    split, ``retiled`` 0) within the kernels' tolerance; the base flow
    pins JAX's 512."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    shape = ShapeConfig("serve", "decode", 256, 2)
    fl = FlowConfig(mode="folded", precision=prec)
    cm = flow.compile("llama3.2-1b", shape, fl, smoke=True)
    assert cm.plan.tiles["decode_attention"] == "auto"
    a = cm.cfg.attention
    G, dtype = a.n_heads // a.n_kv_heads, DTYPES[prec]
    params = cm.init_params(0)
    tok = torch.randint(0, 256, (2, 40), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")

    def steps(m, params=params):
        kd.decode_attention.tiles.clear()
        kd.decode_attention.retiled = 0
        y, st, _ = m.prefill(params, {"tokens": tok[:, :32]})
        out = []
        for t in range(4):
            y, st, _ = m.decode(params, {"tokens": tok[:, 32 + t:33 + t]},
                                st, 32 + t)
            out.append(y)
        torch.cuda.synchronize()
        return torch.stack(out), dict(kd.decode_attention.tiles), \
            kd.decode_attention.retiled
    want, tiles, retiled = steps(cm)
    sched = kd._schedule(dtype, a.head_dim)      # simt at smoke widths
    assert retiled == 0 and sum(tiles.values()) == 4 * _attention_layers(cm)
    for n in (kd.least_tile(256, G, a.head_dim, dtype), 128):
        pinned = flow.compile("llama3.2-1b", shape, FlowConfig(
            mode="folded", precision=prec,
            tile_overrides=(("decode_attention", n),)), smoke=True)
        assert pinned.plan.tiles["decode_attention"] == n
        got, tiles, _ = steps(pinned)
        assert tiles == {(sched, n): 4 * _attention_layers(cm)}
        assert _rel(got, want) < TOL[prec]
    base = flow.compile("llama3.2-1b", shape, fl.base(), smoke=True)
    assert base.plan.tiles["decode_attention"] == 512
    _, tiles, _ = steps(base, base.init_params(0))
    assert tiles == {(sched, 512): 4 * _attention_layers(cm)}


def _attention_layers(cm):
    """The model's attention layers (one decode_attention call a step)."""
    return sum(1 for b in cm.plan.graph.blocks for op in b.ops
               if op.op == "attention")


# paged_decode_attention: block sizes x query widths (1: a decode tick, 5:
# a speculative verify row, 16: a chunked catch-up cell), with a window and
# softcap on some; (B, H, KV, D) = (3, 8, 2, 64), nblk = 1024 // bs
PAGED = [(bs, sq, win, cap) for bs in (8, 16, 32) for sq in (1, 5, 16)
         for win, cap in ((None, None), (100, 30.0))]


def _paged_inputs(g, bs, sq, dt):
    B, H, KV, D = 3, 8, 2, 64
    nblk = 1024 // bs
    NB = 1 + B * nblk
    q = _randn(g, B, sq, H, D, dt=dt)
    kp, vp = _randn(g, NB, bs, KV, D, dt=dt), _randn(g, NB, bs, KV, D, dt=dt)
    perm = torch.randperm(B * nblk, generator=g, device="cuda")
    bt = (1 + perm.reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor([5, 300, 1000 - sq], dtype=torch.int32, device="cuda")
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device="cuda")[None]
    if sq > 1:
        qpos[0, sq // 2:] = -1                          # a padded row
    return q, kp, vp, bt, lens, qpos


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("bs,sq,win,cap", PAGED)
def test_paged_decode_attention_matches_plain(card, dt, bs, sq, win, cap):
    q, kp, vp, bt, lens, qpos = _paged_inputs(card, bs, sq, DTYPES[dt])
    kw = dict(qpos=qpos if sq > 1 else None, window=win, softcap=cap)
    n0 = kd.paged_decode_attention.launches
    y = kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert kd.paged_decode_attention.launches == n0 + 1
    p = kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    live = (qpos if sq > 1 else lens[:, None]) >= 0    # compared rows
    assert y.shape == p.shape and y.dtype == DTYPES[dt]
    assert torch.isfinite(y[live].float()).all()
    assert _rel(y[live], p[live]) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lead", [None, 16])
def test_copy_block_matches_plain(card, dt, lead):
    shape = (9, 16, 8, 64) if lead is None else (lead, 9, 16, 8, 64)
    pool = _randn(card, *shape, dt=DTYPES[dt])
    want = kd.copy_block_plain(pool.clone(), 3, 7)
    n0 = kd.copy_block.launches
    out = kd.copy_block(pool, 3, 7)
    torch.cuda.synchronize()
    assert out is pool and kd.copy_block.launches == n0 + 1
    assert torch.equal(pool, want)
    odd = _randn(card, 2, 5, 3, 1, 5)                   # 60-byte blocks
    want = kd.copy_block_plain(odd.clone(), 4, 0)
    kd.copy_block(odd, 4, 0)
    torch.cuda.synchronize()
    assert torch.equal(odd, want)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("lead", [None, 16])
def test_copy_block_pair_in_one_launch(card, dt, lead):
    """A paged entry's (K, V) pools, flat and folded, in one launch: each
    equal to its plain copy; 60-byte blocks (the byte path) too."""
    shape = (9, 16, 8, 64) if lead is None else (lead, 9, 16, 8, 64)
    for shp in (shape, (2, 5, 3, 1, 5)):
        pair = (_randn(card, *shp, dt=DTYPES[dt]),
                _randn(card, *shp, dt=DTYPES[dt]))
        want = [kd.copy_block_plain(p.clone(), 4, 0) for p in pair]
        n0 = kd.copy_block.launches
        assert kd.copy_block(pair, 4, 0) is pair
        torch.cuda.synchronize()
        assert kd.copy_block.launches == n0 + 1
        assert all(torch.equal(p, w) for p, w in zip(pair, want))


def test_cuda_tensors_never_reach_a_plain_version(card, monkeypatch):
    """Every wrapper launches its kernel on CUDA tensors: with each plain
    version replaced by one that raises, the wrappers still run."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")
    for mod, name in ((kc, "conv2d_fused_plain"), (km, "matmul_fused_plain"),
                      (ka, "flash_attention_plain"),
                      (kd, "decode_attention_plain"),
                      (kd, "paged_decode_attention_plain"),
                      (kd, "copy_block_plain")):
        monkeypatch.setattr(mod, name, boom)
    c0 = dict(kc.conv2d_fused.schedule_launches)
    m0 = dict(km.matmul_fused.schedule_launches)
    kc.conv2d_fused(_randn(card, 1, 8, 8, 4), _randn(card, 3, 3, 4, 8))
    kc.conv2d_fused(_randn(card, 1, 8, 8, 64, dt=torch.bfloat16),
                    _randn(card, 3, 3, 64, 8, dt=torch.bfloat16))
    kc.conv2d_fused(_randn(card, 1, 8, 8, 3), _randn(card, 3, 3, 3, 8))
    kc.conv2d_fused(_randn(card, 1, 8, 8, 32, dt=torch.bfloat16),
                    _randn(card, 3, 3, 32, 8, dt=torch.bfloat16))
    kc.conv2d_fused(_randn(card, 1, 8, 8, 12, dt=torch.bfloat16),
                    _randn(card, 3, 3, 12, 8, dt=torch.bfloat16))
    b0 = dict(km.matmul_fused.base_schedule_launches)
    km.matmul_fused(_randn(card, 4, 16), _randn(card, 16, 8))
    km.matmul_fused(_randn(card, 100, 16), _randn(card, 16, 8))
    km.matmul_fused(_randn(card, 4, 10), _randn(card, 10, 8))
    km.matmul_fused(_randn(card, 4, 64, dt=torch.bfloat16),
                    _randn(card, 64, 8, dt=torch.bfloat16), vmem_accum=False)
    km.matmul_fused(_randn(card, 4, 10), _randn(card, 10, 8),
                    vmem_accum=False)
    torch.cuda.synchronize()
    assert {k: v - c0[k] for k, v in kc.conv2d_fused.schedule_launches.items()
            } == {"wgmma": 1, "ffma": 1, "mid_ci": 1, "small_ci": 1,
                  "simt": 1}
    assert {k: v - m0[k] for k, v in km.matmul_fused.schedule_launches.items()
            } == {"wgmma": 0, "small_m": 0, "ffma": 1, "ffma_small_m": 1,
                  "simt": 1}
    assert {k: v - b0[k] for k, v in
            km.matmul_fused.base_schedule_launches.items()
            } == {"wgmma": 0, "small_m": 1, "ffma": 0, "ffma_small_m": 0,
                  "simt": 1}
    f0 = dict(ka.flash_attention.schedules)
    q = _randn(card, 1, 16, 4, 32)
    ka.flash_attention(q, _randn(card, 1, 16, 2, 32), _randn(card, 1, 16, 2,
                                                             32))
    ka.flash_attention(_randn(card, 1, 16, 4, 64), _randn(card, 1, 16, 2, 64),
                       _randn(card, 1, 16, 2, 64))
    torch.cuda.synchronize()
    assert {k: v - f0[k] for k, v in ka.flash_attention.schedules.items()
            } == {"wgmma": 0, "ffma": 1, "simt": 1}
    d0 = dict(kd.decode_attention.schedules)
    p0 = dict(kd.paged_decode_attention.schedules)
    kv = _randn(card, 1, 16, 2, 32)
    pos = torch.arange(16, dtype=torch.int32, device="cuda")[None]
    kd.decode_attention(q[:, :1], kv, kv, pos, pos[:, 3:4])
    kv64 = _randn(card, 1, 16, 2, 64, dt=torch.bfloat16)
    kd.decode_attention(_randn(card, 1, 1, 4, 64, dt=torch.bfloat16), kv64,
                        kv64, pos, pos[:, 3:4])
    pq, kp, vp, bt, lens, qpos = _paged_inputs(card, 16, 5, torch.float32)
    kd.paged_decode_attention(pq, kp, vp, bt, lens, qpos=qpos)
    torch.cuda.synchronize()
    assert {k: v - d0[k] for k, v in kd.decode_attention.schedules.items()
            } == {"mma": 1, "ffma": 0, "simt": 1}
    assert {k: v - p0[k] for k, v in
            kd.paged_decode_attention.schedules.items()
            } == {"mma": 0, "ffma": 1, "simt": 0}
    kd.copy_block(kp, 1, 2)
    kd.copy_block((kp, vp), 1, 2)
    torch.cuda.synchronize()


def test_paged_wrappers_reject_what_the_kernels_do_not_take(card):
    q, kp, vp, bt, lens, qpos = _paged_inputs(card, 16, 1, torch.float32)
    with pytest.raises(TypeError):
        kd.paged_decode_attention(q.half(), kp.half(), vp.half(), bt, lens)
    with pytest.raises(ValueError):                      # pool on the host
        kd.paged_decode_attention(q, kp.cpu(), vp.cpu(), bt, lens)
    with pytest.raises(ValueError):                      # non-contiguous
        kd.paged_decode_attention(q, kp.transpose(0, 1), vp.transpose(0, 1),
                                  bt, lens)
    with pytest.raises(ValueError):
        kd.copy_block(kp.transpose(0, 1), 0, 1)


def test_serving_engine_on_the_card(card):
    """Engine.run at smoke size on the card, fp32: a prefix-cached run with
    a COW fork and a speculative chunked run give the reference backend's
    cold greedy tokens, through the paged kernel and copy_block."""
    import numpy as np
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig, Request
    shape = ShapeConfig("serve", "decode", 64, 4)
    fl = FlowConfig(mode="folded", precision="fp32")
    cm = flow.compile("llama3.2-1b", shape, fl, smoke=True)
    ref = flow.compile("llama3.2-1b", shape, fl, smoke=True,
                       backend="reference")
    assert cm.plan.kernels["paged_decode_attention"] == "cuda"
    assert cm.plan.kernels["copy_block"] == "cuda"
    params = cm.init_params(0)
    p = np.random.RandomState(21).randint(0, 256, 12).astype(np.int32)
    reqs = [Request(x, p, max_new_tokens=6) for x in "abcd"]
    base = dict(max_batch=2, max_seq_len=64, block_size=8,
                prompt_buckets=(16, 64))
    want = Engine(ref, params, EngineConfig(**base)).run(reqs)
    n_pa, n_cb = kd.paged_decode_attention.launches, kd.copy_block.launches
    hit = Engine(cm, params, EngineConfig(prefix_cache=True, **base)).run(
        reqs)
    assert hit.metrics["cow_forks"] >= 1
    assert kd.paged_decode_attention.launches - n_pa == \
        3 * hit.metrics["decode_ticks"]
    # one launch a fork: the one paged entry's K and V pools together
    assert kd.copy_block.launches - n_cb == hit.metrics["cow_forks"]
    spec = Engine(cm, params, EngineConfig(
        chunked_prefill=True, chunk_size=4, speculation="ngram:3",
        **base)).run(reqs)
    for got in (hit, spec):
        assert {r.rid: r.tokens for r in got.results} == \
            {r.rid: r.tokens for r in want.results}


def _lru_inputs(g, B, S, W, dt):
    """a in (0, 1) as the RG-LRU's gate gives it, b of unit scale."""
    a = torch.rand(B, S, W, generator=g, device="cuda").to(dt)
    b = _randn(g, B, S, W, dt=dt)
    return a, b


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(LRU))
def test_lru_scan_kernel(card, name, dt):
    a, b = _lru_inputs(card, *LRU[name], DTYPES[dt])
    n0 = kl.lru_scan.launches
    h = kl.lru_scan(a, b)
    torch.cuda.synchronize()
    assert kl.lru_scan.launches == n0 + 1
    p = kl.lru_scan_plain(a, b)
    assert h.shape == p.shape and h.dtype == DTYPES[dt]
    assert torch.isfinite(h.float()).all()
    assert _rel(h, p) < TOL[dt]


def test_lru_scan_on_cuda_never_reaches_its_plain_version(card, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")
    monkeypatch.setattr(kl, "lru_scan_plain", boom)
    kl.lru_scan(*_lru_inputs(card, 2, 40, 300, torch.float32))
    torch.cuda.synchronize()
    with pytest.raises(TypeError):
        a, b = _lru_inputs(card, 1, 4, 8, torch.float32)
        kl.lru_scan(a.half(), b.half())
    with pytest.raises(ValueError):                      # b on the host
        kl.lru_scan(a, b.cpu())


# lru_scan's chunked schedule: the CPU model's edge shapes
# (tests/test_torch_lru_chunked.py) and the hybrid's path shapes
LRU_CHUNKED = {"s1": (2, 1, 32), "s5_under_a_chunk": (2, 5, 64),
               "s37_ragged": (3, 37, 48), "b1_s100": (1, 100, 40),
               "w40_partial_strip": (2, 70, 40), "window_cut": (1, 2080, 64),
               "rg_prefill": (8, 512, 2560), "rg_window": (1, 2080, 2560),
               "rg_serve_b8": (8, 256, 2560), "rg_serve_b1": (1, 256, 2560)}


def _lru_ran(sched, fn):
    """Run fn; assert that it made one lru_scan launch, on ``sched``."""
    s0 = dict(kl.lru_scan.schedules)
    y = fn()
    torch.cuda.synchronize()
    assert {k: v - s0[k] for k, v in kl.lru_scan.schedules.items()} == \
        {k: int(k == sched) for k in kl.SCHEDULES}
    return y


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(LRU_CHUNKED))
def test_lru_scan_chunked_schedule(card, name, dt):
    B, S, W = LRU_CHUNKED[name]
    if DTYPES[dt] == torch.bfloat16 and W % 8:
        W += 8 - W % 8                     # bf16 rows of whole 16 bytes
    a, b = _lru_inputs(card, B, S, W, DTYPES[dt])
    h = _lru_ran("chunked", lambda: kl.lru_scan(a, b))
    p = kl.lru_scan_plain(a, b)
    assert h.shape == p.shape and h.dtype == DTYPES[dt]
    assert torch.isfinite(h.float()).all()
    assert _rel(h, p) < TOL[dt]
    assert torch.equal(kl.lru_scan(a, b), h)           # no float atomics


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_lru_scan_seq_keeps_the_rest(card, dt):
    """Rows of 130 fp32 (520 bytes) or 100 bf16 (200 bytes) and an
    unaligned view run on the sequential kernel and match."""
    d = DTYPES[dt]
    a, b = _lru_inputs(card, 2, 33, 130 if dt == "fp32" else 100, d)
    h = _lru_ran("seq", lambda: kl.lru_scan(a, b))
    assert _rel(h, kl.lru_scan_plain(a, b)) < TOL[dt]
    a, b = _lru_inputs(card, 1, 40 * 64 + 1, 1, d)
    av, bv = a.view(-1)[1:].view(1, 40, 64), b.view(-1)[1:].view(1, 40, 64)
    h = _lru_ran("seq", lambda: kl.lru_scan(av, bv))
    assert _rel(h, kl.lru_scan_plain(av, bv)) < TOL[dt]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("sq", [1, 5])
def test_paged_decode_attention_head_dim_256(card, dt, sq):
    """recurrentgemma-2b's heads (10 over 1 KV head of 256) over the pool,
    a decode tick and a five-query row (50 query rows: two row tiles of
    32), windowed."""
    B, H, KV, D, bs = 3, 10, 1, 256, 16
    nblk = 1024 // bs
    q = _randn(card, B, sq, H, D, dt=DTYPES[dt])
    kp = _randn(card, 1 + B * nblk, bs, KV, D, dt=DTYPES[dt])
    vp = _randn(card, 1 + B * nblk, bs, KV, D, dt=DTYPES[dt])
    perm = torch.randperm(B * nblk, generator=card, device="cuda")
    bt = (1 + perm.reshape(B, nblk)).to(torch.int32)
    lens = torch.tensor([5, 300, 1000 - sq], dtype=torch.int32, device="cuda")
    qpos = lens[:, None] + torch.arange(sq, dtype=torch.int32,
                                        device="cuda")[None]
    kw = dict(qpos=qpos if sq > 1 else None, window=200)
    n0 = kd.paged_decode_attention.launches
    y = kd.paged_decode_attention(q, kp, vp, bt, lens, **kw)
    torch.cuda.synchronize()
    assert kd.paged_decode_attention.launches == n0 + 1
    p = kd.paged_decode_attention_plain(q, kp, vp, bt, lens, **kw)
    assert y.shape == p.shape and torch.isfinite(y.float()).all()
    assert _rel(y, p) < TOL[dt]


def test_recurrentgemma_smoke_through_the_entry_point(card):
    """The hybrid path on the card at smoke size (6 layers: 4 RG-LRU, 2
    attention): one prefill launches 4 lru_scan and 2 flash, a decode step
    2 decode_attention and no lru_scan; the logits are held against the
    reference backend (bf16 < 5e-2) and fp32 greedy tokens equal it across
    the 16-token window."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    shape = ShapeConfig("serve", "decode", 32, 2)
    cm = flow.compile("recurrentgemma-2b", shape, smoke=True)
    ref = flow.compile("recurrentgemma-2b", shape, smoke=True,
                       backend="reference")
    assert cm.plan.kernels["rg_lru"] == "cuda"
    params = cm.init_params(0)
    tok = torch.randint(0, 256, (2, 8), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    n_l, n_f = kl.lru_scan.launches, ka.flash_attention.launches
    y, st, _ = cm.prefill(params, {"tokens": tok})
    torch.cuda.synchronize()
    assert (kl.lru_scan.launches - n_l, ka.flash_attention.launches - n_f) \
        == (4, 2)
    yr, st_r, _ = ref.prefill(params, {"tokens": tok})
    assert y.shape == (2, 1, 256) and _rel(y, yr) < 5e-2
    n_l, n_d = kl.lru_scan.launches, kd.decode_attention.launches
    for t in range(4):
        nxt = tok[:, t:t + 1]
        y, st, _ = cm.decode(params, {"tokens": nxt}, st, 8 + t)
        yr, st_r, _ = ref.decode(params, {"tokens": nxt}, st_r, 8 + t)
        assert _rel(y, yr) < 5e-2
    torch.cuda.synchronize()
    assert kl.lru_scan.launches == n_l
    assert kd.decode_attention.launches - n_d == 8
    f32 = FlowConfig(mode="folded", precision="fp32")
    cm32 = flow.compile("recurrentgemma-2b", shape, f32, smoke=True)
    ref32 = flow.compile("recurrentgemma-2b", shape, f32, smoke=True,
                         backend="reference")
    p32 = cm32.init_params(0)
    t32, _ = cm32.generate(p32, {"tokens": tok}, steps=24)
    assert torch.equal(t32, ref32.generate(p32, {"tokens": tok}, steps=24)[0])
    assert torch.equal(t32, cm32.generate_fori(p32, {"tokens": tok}, 24))


def test_recurrentgemma_serving_on_the_card(card):
    """Engine.run serves the smoke hybrid on the card with exact prompt
    buckets, fp32: the reference backend's greedy tokens, the recurrent
    state through lru_scan at each prefill batch."""
    import numpy as np
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.serving import Engine, EngineConfig, Request
    shape = ShapeConfig("serve", "decode", 64, 4)
    fl = FlowConfig(mode="folded", precision="fp32")
    cm = flow.compile("recurrentgemma-2b", shape, fl, smoke=True)
    ref = flow.compile("recurrentgemma-2b", shape, fl, smoke=True,
                       backend="reference")
    params = cm.init_params(0)
    rng = np.random.RandomState(3)
    reqs = [Request(f"r{i}", rng.randint(0, 256, 16).astype(np.int32),
                    max_new_tokens=int(rng.randint(3, 12))) for i in range(6)]
    kw = dict(max_batch=4, max_seq_len=64, block_size=8, prompt_buckets=(16,))
    want = Engine(ref, params, EngineConfig(**kw)).run(reqs)
    n_l = kl.lru_scan.launches
    got = Engine(cm, params, EngineConfig(**kw)).run(reqs)
    torch.cuda.synchronize()
    assert kl.lru_scan.launches - n_l == 4 * got.metrics["prefill_batches"]
    assert {r.rid: r.tokens for r in got.results} == \
        {r.rid: r.tokens for r in want.results}


# ---------------------------------------------------------------------------
# training on the card: the forward products on the hand kernels, the
# backward through the reference ops
# ---------------------------------------------------------------------------

def _launch_counts():
    torch.cuda.synchronize()
    return {"conv2d_fused": kc.conv2d_fused.launches,
            "matmul_fused": km.matmul_fused.launches,
            "flash_attention": ka.flash_attention.launches,
            "decode_attention": kd.decode_attention.launches,
            "paged_decode_attention": kd.paged_decode_attention.launches,
            "copy_block": kd.copy_block.launches,
            "lru_scan": kl.lru_scan.launches}


def _smoke_train_batch(V, B=2, S=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, V, (B, S), generator=g),
            "labels": torch.randint(0, V, (B, S), generator=g)}


def test_train_step_on_the_card_matches_the_cpu(card):
    """One call of a smoke llama train step (fp32, no clip, the default
    eps; the first call's rate is 0) on the card, its forward on the
    kernels, and on the CPU from the same tree: the losses within 1e-5,
    the first moment (the gradients) within 1e-4 (the embedding's backward
    adds by atomics: tolerances, not bits).  Then one AdamW update of the
    card's gradients from the card's state on both devices: the parameters
    within 1e-4 (an update at eps 1e-8 is about lr * sign(g), so it is
    held on the same gradients; chip_smoke.py's ``_card_vs_cpu`` says
    more)."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, \
        tree_map
    shape = ShapeConfig("smoke", "train", 16, 2)
    f32 = FlowConfig(mode="folded", precision="fp32")
    opt = AdamW(lr=1e-3, grad_clip=0.0, warmup_steps=1, total_steps=10)
    runs = {}
    p0 = None
    for dev in ("cuda", "cpu"):
        cm = flow.compile("llama3.2-1b", shape, f32, smoke=True, device=dev)
        p0 = cm.init_params(0) if p0 is None else p0
        params = tree_map(lambda t: t.to(dev, copy=True), p0)
        batch = {k: v.to(dev) for k, v in
                 _smoke_train_batch(cm.cfg.vocab_size).items()}
        n0 = km.matmul_fused.launches
        params, state, m0 = cm.train_step(opt)(params, opt.init(params),
                                              batch)
        runs[dev] = (float(m0["loss"]), params, state,
                     km.matmul_fused.launches - n0)
    (lg, pg, sg, ng), (lc, _, sc, nc) = runs["cuda"], runs["cpu"]
    assert ng > 0 and nc == 0
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert max(_rel(a.cpu(), b) for a, b in
               zip(tree_leaves(sg.mu), tree_leaves(sc.mu))) < 1e-4
    grads = tree_map(lambda t: t / (1 - opt.b1), sg.mu)
    cpu = lambda t: t.cpu().clone()                         # noqa: E731
    pc, gc = tree_map(cpu, pg), tree_map(cpu, grads)
    stc = AdamWState(cpu(sg.step), tree_map(cpu, sg.mu), tree_map(cpu, sg.nu))
    pg, _, _ = opt.update(grads, sg, pg)
    pc, _, _ = opt.update(gc, stc, pc)
    assert max(_rel(a.cpu(), b) for a, b in
               zip(tree_leaves(pg), tree_leaves(pc))) < 1e-4
    assert max((a - b.cpu()).abs().max().item() for a, b in
               zip(tree_leaves(pc), tree_leaves(p0))) > 0


def test_train_mode_launches_the_kernels(card):
    """A train step of smoke llama and of LeNet-5 on the card: the forward
    products launch the kernels (llama: projections and flash; LeNet-5:
    convs and FCs), with no dispatch rejection; in fp32 the loss is the
    reference backend's within 1e-5 and every gradient within 1e-4 (the
    backward recomputes the reference op)."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.kernels.registry import DISPATCH_REJECTIONS
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.trainer import _grads
    shape = ShapeConfig("smoke", "train", 16, 2)
    for arch, want in (("llama3.2-1b", {"matmul_fused", "flash_attention"}),
                       ("lenet5", {"matmul_fused", "conv2d_fused"})):
        for prec in ("bf16", "fp32"):
            fl = FlowConfig(mode="folded", precision=prec)
            cm = flow.compile(arch, shape, fl, smoke=True)
            assert cm.plan.kernels["matmul"] == "cuda"
            params = cm.init_params(0)
            batch = cm._measure_inputs(0)
            DISPATCH_REJECTIONS.clear()
            before = _launch_counts()
            loss, _, grads = _grads(cm.loss_fn, params, batch)
            after = _launch_counts()
            assert torch.isfinite(loss)
            assert {k for k in after if after[k] != before[k]} == want
            assert DISPATCH_REJECTIONS == {}
            if prec == "fp32":
                ref = flow.compile(arch, shape, fl, smoke=True,
                                   backend="reference")
                want_loss, _, want_g = _grads(ref.loss_fn, params, batch)
                assert abs(float(loss) - float(want_loss)) <= \
                    1e-5 * abs(float(want_loss))
                assert max(_rel(a, b) for a, b in zip(
                    tree_leaves(grads), tree_leaves(want_g))) < 1e-4


def test_trained_smoke_model_prefill_through_the_kernels(card):
    """Smoke llama trained 3 steps on the card (fp32 masters, bf16
    compute, the forward on the kernels), its tree cast to bf16 into a
    serve plan: the prefill launches flash and matmul_fused and holds to
    the reference backend (< 5e-2)."""
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.optim.adamw import AdamW, tree_map
    tm = flow.compile("llama3.2-1b", ShapeConfig("smoke", "train", 16, 2),
                      smoke=True)
    params = tm.init_params(0)
    opt = AdamW(lr=3e-3, warmup_steps=1, total_steps=3)
    state = opt.init(params)
    batch = {k: v.cuda() for k, v in _smoke_train_batch(256).items()}
    step = tm.train_step(opt)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    serve = ShapeConfig("serve", "decode", 32, 2)
    cm = flow.compile("llama3.2-1b", serve, smoke=True)
    ref = flow.compile("llama3.2-1b", serve, smoke=True, backend="reference")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    f0, m0 = ka.flash_attention.launches, km.matmul_fused.launches
    y, _, _ = cm.prefill(p16, {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    assert ka.flash_attention.launches - f0 == 3
    assert km.matmul_fused.launches - m0 == 3 * 6
    yr, _, _ = ref.prefill(p16, {"tokens": batch["tokens"]})
    assert _rel(y, yr) < 5e-2


# ---------------------------------------------------------------------------
# the stages on captured CUDA graphs (repro_torch.flow.graphs)
# ---------------------------------------------------------------------------

def _clone_tree(t):
    return {k: _clone_tree(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.clone()


def _smoke_lm(prec="bf16", arch="llama3.2-1b"):
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    cm = flow.compile(arch, ShapeConfig("serve", "decode", 32, 2),
                      FlowConfig(mode="folded", precision=prec), smoke=True)
    tok = torch.randint(0, 256, (2, 12), generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    return cm, cm.init_params(0), tok


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_graph_decode_is_eager_bit_for_bit(card, arch):
    """Six decode steps replayed from one graph give the eager steps'
    logits bit for bit (recurrentgemma's 16-slot window wraps at 16), leave
    the same state, and count the same launches; each replay's logits are
    the caller's: the next replay leaves them as they were."""
    from repro_torch import flow
    from repro_torch.kernels import registry
    cm, params, tok = _smoke_lm(arch=arch)
    _, st, _ = cm.prefill(params, {"tokens": tok})
    st_e = _clone_tree(st)
    c0 = registry.snapshot_counts()
    got = [cm.decode(params, {"tokens": tok[:, t:t + 1]}, st, 12 + t)[0]
           for t in range(6)]
    torch.cuda.synchronize()
    c1 = registry.snapshot_counts()
    with flow.disable_graphs():
        want = [cm.decode(params, {"tokens": tok[:, t:t + 1]}, st_e,
                          12 + t)[0] for t in range(6)]
    torch.cuda.synchronize()
    c2 = registry.snapshot_counts()
    assert cm.stage_graphs.stats["captured"] == 2     # prefill, decode
    assert cm.stage_graphs.stats["replays"] == 5
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert all(torch.equal(a, b) for a, b in zip(flat(st), flat(st_e)))
    assert registry.count_delta(c0, c1) == registry.count_delta(c1, c2)


def test_second_params_tree_gets_its_own_capture(card):
    from repro_torch import flow
    cm, params, tok = _smoke_lm()
    p2 = cm.init_params(1)
    for p in (params, p2, params, p2):
        _, st, _ = cm.prefill(p, {"tokens": tok})
        st_e = _clone_tree(st)
        y = cm.decode(p, {"tokens": tok[:, :1]}, st, 12)[0]
        y = cm.decode(p, {"tokens": tok[:, 1:2]}, st, 13)[0]
        with flow.disable_graphs():
            cm.decode(p, {"tokens": tok[:, :1]}, st_e, 12)
            w = cm.decode(p, {"tokens": tok[:, 1:2]}, st_e, 13)[0]
        assert torch.equal(y, w)
    # one capture per (params, state): each prefill makes a new state
    assert cm.stage_graphs.stats["captured"] >= 2


def test_graph_ticket_buffer_outlives_a_grown_call(card):
    """A graph captured over decode_attention's tickets (llama's split-KV
    shape) replays right after a larger call has grown them: the old
    buffer is kept, and the replay equals the eager call."""
    from repro_torch.flow.graphs import StageGraphs
    dev = torch.device("cuda", torch.cuda.current_device())
    B, C, H, KV, D = DECODE["llama"][:5]
    q = _randn(card, B, 1, H, D, dt=torch.bfloat16)
    kc = _randn(card, B, C, KV, D, dt=torch.bfloat16)
    vc = _randn(card, B, C, KV, D, dt=torch.bfloat16)
    pos = torch.arange(C, dtype=torch.int32, device="cuda").repeat(B, 1)
    pos[:, C // 2:] = -1
    qpos = torch.full((B, 1), C // 2 - 1, dtype=torch.int32, device="cuda")

    def attend(st):
        return kd.decode_attention(st["q"], kc, vc, pos, qpos)
    sg = StageGraphs(dev)
    sg.run(("tickets",), {"q": q}, attend)
    old = kd._TICKETS[dev]
    kd._tickets(dev, old.numel() + 1)
    assert kd._TICKETS[dev] is not old
    assert any(t is old for t in kd._RETIRED_TICKETS)
    y = sg.run(("tickets",), {"q": 2 * q}, attend)
    assert sg.stats["replays"] == 1
    assert torch.equal(y, kd.decode_attention(2 * q, kc, vc, pos, qpos))


def test_capture_that_reads_the_host_raises(card):
    """The warm-up may read the host; the capture of the same function
    raises, and nothing is kept."""
    from repro_torch.flow.graphs import StageGraphs
    sg = StageGraphs(torch.device("cuda", 0))
    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        sg.run(("host_read",), {"x": x}, lambda st: st["x"] * st["x"].sum()
               .item())
    assert len(sg) == 0
    y = sg.run(("ok",), {"x": x}, lambda st: st["x"] * 2)
    y2 = sg.run(("ok",), {"x": x + 1}, lambda st: st["x"] * 2)
    assert torch.equal(y, x * 2) and torch.equal(y2, (x + 1) * 2)


def test_capture_without_room_drops_the_graphs(card, monkeypatch):
    """With room on the card a new key keeps the other graphs; a new key
    whose warm-up took more than the card has free drops every graph and
    held state (their shared pool goes back to the device) and captures
    into a new pool; a dropped key captures again when it comes back.  A
    pure stage's first call hands back a replay's copy."""
    from repro_torch.flow.graphs import StageGraphs
    sg = StageGraphs(torch.device("cuda", 0))
    x = torch.ones(1 << 20, device="cuda")

    def twice(st):
        return st["x"] * 2
    sg.run(("a",), {"x": x}, twice)
    sg.held({"s": x})
    assert sg.stats["pool_bytes"] > 0
    assert sg.stats["held_bytes"] == x.numel() * x.element_size()
    y = sg.run(("p",), {"x": x + 3}, twice, pure=True)
    assert torch.equal(y, (x + 3) * 2)
    assert y.data_ptr() != sg._graphs[("p",)].outputs.data_ptr()
    assert len(sg) == 2 and sg.stats["evicted"] == 0
    assert sg.stats["replays"] == 0
    free = torch.cuda.mem_get_info
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "mem_get_info",
                  lambda d=None: (0, free(d)[1]))
        y = sg.run(("b",), {"x": x + 1}, twice)
    assert torch.equal(y, (x + 1) * 2)
    assert sg.stats["evicted"] == 2 and len(sg) == 1
    assert sg.stats["held_bytes"] == 0
    y = sg.run(("a",), {"x": x + 2}, twice)
    assert torch.equal(y, (x + 2) * 2) and sg.stats["captured"] == 4
    assert torch.equal(sg.run(("b",), {"x": x}, twice), x * 2)
    assert sg.stats["replays"] == 1 and sg.stats["evicted"] == 2


def test_pure_warm_up_out_of_memory_drops_the_graphs(card):
    """A pure stage whose warm-up runs out of memory drops the card's
    graphs (another model's too) and runs it once more; a stage that
    writes state in place raises instead, and keeps nothing."""
    from repro_torch.flow.graphs import StageGraphs
    dev = torch.device("cuda", 0)
    other, sg = StageGraphs(dev), StageGraphs(dev)
    x = torch.ones(1 << 20, device="cuda")
    other.run(("a",), {"x": x}, lambda st: st["x"] * 2)
    tries = []

    def short_once(st):
        tries.append(1)
        if len(tries) == 1:
            raise torch.OutOfMemoryError("short")
        return st["x"] + 1
    with pytest.raises(torch.OutOfMemoryError):
        sg.run(("s",), {"x": x}, short_once)
    assert len(sg) == 0 and len(other) == 1
    tries.clear()
    y = sg.run(("p",), {"x": x}, short_once, pure=True)
    assert torch.equal(y, x + 1) and len(tries) == 3    # fail, run, capture
    assert len(other) == 0 and other.stats["evicted"] == 1
    assert torch.equal(sg.run(("p",), {"x": x + 1}, short_once), x + 2)


def test_generate_fori_and_segments_replay_graphs(card):
    """generate_fori equals generate; a sampled decode segment draws the
    host loop's tokens; both replay without a device-to-host read."""
    from repro_torch import flow
    from repro_torch.serving import Engine, EngineConfig
    cm, params, tok = _smoke_lm("fp32")
    want, _ = cm.generate(params, {"tokens": tok}, steps=6)
    assert torch.equal(cm.generate_fori(params, {"tokens": tok}, 6), want)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = cm.generate_fori(params, {"tokens": tok}, 6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(again, want)
    eng = Engine(cm, params, EngineConfig(max_batch=2, max_seq_len=32,
                                          block_size=8))
    seg = cm.decode_segment(4, temperature=1.0)
    y, pst, _ = cm.prefill(params, {"tokens": tok})
    out = {}
    for graphed in (True, False):
        cache = eng.new_cache()          # each row its own block chain
        for r in range(2):
            cache.admit(r, 12, 28, pst, r, 0)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(3)
        cur = y[:, -1].argmax(-1).to(torch.int32)
        runs = []
        for i in range(3):
            pos = torch.full_like(cur, 12 + 4 * i)
            if graphed:
                t = seg(params, cache.state, cur, pos, gen)[0]
            else:
                with flow.disable_graphs():
                    t = seg(params, cache.state, cur, pos, gen)[0]
            runs.append(t)
            cur = t[:, -1].contiguous()
        out[graphed] = torch.cat(runs, 1)
    assert torch.equal(out[True], out[False])


def test_cnn_prefill_replays_a_graph(card):
    from repro_torch import flow
    from repro_torch.configs.base import ShapeConfig
    cm = flow.compile("lenet5", ShapeConfig("serve", "prefill", 32, 4))
    params = cm.init_params(0)
    x = torch.randn(4, 32, 32, 1, generator=card, device="cuda")
    ys = [cm.prefill(params, {"images": x * s})[0] for s in (1.0, 2.0)]
    with flow.disable_graphs():
        ws = [cm.prefill(params, {"images": x * s})[0] for s in (1.0, 2.0)]
    assert cm.stage_graphs.stats["replays"] == 1
    assert all(torch.equal(y, w) for y, w in zip(ys, ws))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b",
                                  "deepseek-moe-16b", "rwkv6-7b",
                                  "whisper-small"])
def test_lm_prefill_replays_a_graph(card, arch):
    """Two prefills of one shape (a warm-up and capture, then a replay)
    give the eager prefill's logits and state bit for bit and the same
    launches; the replay leaves the first call's state as it was."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.kernels import registry
    cm = flow.compile(arch, ShapeConfig("serve", "prefill", 32, 2),
                      FlowConfig(mode="folded"), smoke=True)
    params = cm.init_params(0)
    b1, b2 = cm._measure_inputs(0), cm._measure_inputs(1)
    c0 = registry.snapshot_counts()
    y1, s1, _ = cm.prefill(params, b1)
    keep = _clone_tree(s1)
    y2, s2, _ = cm.prefill(params, b2)
    torch.cuda.synchronize()
    c1 = registry.snapshot_counts()
    with flow.disable_graphs():
        w1, t1, _ = cm.prefill(params, b1)
        w2, t2, _ = cm.prefill(params, b2)
    torch.cuda.synchronize()
    c2 = registry.snapshot_counts()
    flat = lambda t: [x for v in t.values() for x in (  # noqa: E731
        flat(v) if isinstance(v, dict) else [v])]
    assert cm.stage_graphs.stats["captured"] == 1
    assert cm.stage_graphs.stats["replays"] == 1
    assert torch.equal(y1, w1) and torch.equal(y2, w2)
    for a, b in ((s1, t1), (s2, t2), (s1, keep)):
        assert all(torch.equal(x, y) for x, y in zip(flat(a), flat(b)))
    assert registry.count_delta(c0, c1) == registry.count_delta(c1, c2)


def test_generate_decodes_on_one_graph(card):
    """Three ``generate`` calls capture the prefill and decode once, and
    each call's tokens are the eager ones."""
    from repro_torch import flow
    cm, params, tok = _smoke_lm()
    with flow.disable_graphs():
        want, _ = cm.generate(params, {"tokens": tok}, steps=6)
    caps = []
    for _ in range(3):
        got, _ = cm.generate(params, {"tokens": tok}, steps=6)
        assert torch.equal(got, want)
        caps.append(cm.stage_graphs.stats["captured"])
    assert caps == [2, 2, 2]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "lenet5", "resnet34",
                                  "recurrentgemma-2b", "deepseek-moe-16b",
                                  "rwkv6-7b", "whisper-small"])
def test_train_step_replays_a_graph(card, arch):
    """Three steps on the step's graph (a warm-up and capture, then two
    replays) from one init and batch: the parameters and moments written
    in place, and the losses, parameters and launches of three eager
    steps (ResNet-34's cuDNN weight gradients are not deterministic: its
    steps are held to their finite losses and launches)."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.kernels import registry
    from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
    cm = flow.compile(arch, ShapeConfig("train", "train", 32, 2),
                      FlowConfig(mode="folded"), smoke=True)
    p0 = cm.init_params(0)
    batch = cm._measure_inputs(0)
    opt = AdamW(lr=1e-3, warmup_steps=1)
    step = cm.train_step(opt)
    out = {}
    for graphed in (True, False):
        params = tree_map(torch.clone, p0)
        st = opt.init(params)
        owned = [t.data_ptr() for t in tree_leaves(params) +
                 tree_leaves(st.mu) + [st.step]]
        c0 = registry.snapshot_counts()
        losses = []
        for _ in range(3):
            if graphed:
                params, st, m = step(params, st, batch)
            else:
                with flow.disable_graphs():
                    params, st, m = step(params, st, batch)
            losses.append(float(m["loss"]))
        assert [t.data_ptr() for t in tree_leaves(params) +
                tree_leaves(st.mu) + [st.step]] == owned
        assert int(st.step) == 3
        out[graphed] = (losses, params, registry.count_delta(
            c0, registry.snapshot_counts()))
    assert cm.stage_graphs.stats["captured"] == 1
    assert cm.stage_graphs.stats["replays"] == 2
    (lg, pg, cg), (le, pe, ce) = out[True], out[False]
    assert cg == ce and all(math.isfinite(x) for x in lg)
    if arch != "resnet34":
        assert lg == le
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pg),
                                                     tree_leaves(pe)))


def test_measure_trace_names_the_wgmma_matmul(card, tmp_path):
    """``measure("prefill", trace_dir=)`` of a bf16 prefill (smoke llama at
    2 x 64 tokens: 128 rows, the projections on ``wgmma``): the Chrome
    trace names ``matmul_wgmma_kernel`` among its device kernels and holds
    one ``measure.step`` annotation a timed call."""
    import json
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    cm = flow.compile("llama3.2-1b", ShapeConfig("s", "prefill", 64, 2),
                      FlowConfig(mode="folded"), smoke=True)
    rec = cm.measure("prefill", iters=3, trace_dir=str(tmp_path))
    with open(rec["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("matmul_wgmma_kernel" in k for k in kernels), sorted(kernels)
    assert sum(e.get("name") == "measure.step" and
               e.get("cat") == "user_annotation" for e in events) == 3
    assert rec["device"] == torch.cuda.get_device_name(0)


def test_compressed_adamw_on_a_one_rank_mesh_is_the_unsharded_step(card):
    """Two ``AdamW(compress="int8_ef")`` updates of smoke llama's fp32
    masters on a one-rank NCCL mesh (DTensor parameters, gradients, moments
    and error buffers) against the same updates of the plain tensors:
    every parameter, moment and error buffer equal bit for bit (at one
    rank the scale's MAX all-reduce and the norm's sum reduce nothing, and
    the clip bites: the gradients' norm is above 1)."""
    from repro_torch import flow
    from repro_torch.configs.base import FlowConfig, ShapeConfig
    from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map
    from torch.distributed.tensor import DTensor
    shape = ShapeConfig("train", "train", 16, 2)
    fl = FlowConfig(mode="folded")
    cm0 = flow.compile("llama3.2-1b", shape, fl, smoke=True)
    cm = flow.compile("llama3.2-1b", shape, fl, smoke=True,
                      mesh={"data": 1, "model": 1})
    shd = cm.rules.params_shardings(cm.plan)
    p0 = cm0.init_params(0)
    p = cm.rules.distribute(_clone_tree(p0), shd)
    opt = AdamW(lr=1e-3, warmup_steps=1, compress="int8_ef")
    s0, s = opt.init(p0), opt.init(p)
    for _ in range(2):
        g0 = tree_map(lambda t: torch.randn(t.shape, generator=card,
                                            device="cuda"), p0)
        g = tree_map(lambda t, q: cm.rules.wrap(t.clone(), q.placements,
                                                q.shape), g0, p)
        p0, s0, m0 = opt.update(g0, s0, p0)
        p, s, m = opt.update(g, s, p)
        assert float(m0["grad_norm"]) > 1.0
        assert torch.equal(m0["grad_norm"], m["grad_norm"])
    assert isinstance(tree_leaves(s.err)[0], DTensor)
    for a, b in ((p0, p), (s0.mu, s.mu), (s0.nu, s.nu), (s0.err, s.err)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y.to_local())
