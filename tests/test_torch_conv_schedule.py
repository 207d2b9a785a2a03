"""conv2d_fused's schedule choice and K split on the CPU.

``_schedule`` and ``_conv_split`` are pure functions of the shapes: these
tests pin the choice at every conv of the three CNNs the port runs
(ResNet-34, MobileNetV1, LeNet-5, read from their graphs with their taps)
in both dtypes, at the channel counts and taps around the rules' edges,
and the split at every distinct ResNet-34 conv at batch 8 and 224 px.  The schedules' kernels run
only on the card (``tests/test_torch_gpu.py``).
"""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import matmul_fused as km
from repro_torch.models.cnn import build_cnn_graph

BF, F32 = torch.bfloat16, torch.float32
SMS = 132


def _convs(arch):
    """(CI, CO, (kh, kw, stride)) of every conv2d op in the model's graph
    (depthwise convs are another op, which the registry sends to the
    reference op)."""
    out = []
    for blk in build_cnn_graph(get_config(arch)).blocks:
        for op in blk.ops:
            if op.op == "conv2d":
                kh, kw, ci, co = op.params[0].shape
                out.append((ci, co, (kh, kw, op.attrs.get("stride", 1))))
    return out


# arch -> dtype -> launches by schedule of one forward, the wrapper giving
# each conv's taps: the 7x7 stride-2 stem (CI 3), MobileNetV1's first conv
# (CI 3) and LeNet-5's CI 1 and 6 on small_ci; MobileNetV1's 32-channel
# pointwise conv in bf16 (CI not a multiple of 64, nor under 8) on mid_ci;
# no conv on simt
WANT = {
    "resnet34": {BF: {"wgmma": 35, "small_ci": 1},
                 F32: {"ffma": 35, "small_ci": 1}},
    "mobilenetv1": {BF: {"wgmma": 12, "small_ci": 1, "mid_ci": 1},
                    F32: {"ffma": 13, "small_ci": 1}},
    "lenet5": {BF: {"small_ci": 2}, F32: {"small_ci": 2}},
}


@pytest.mark.parametrize("dt", [BF, F32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("arch", sorted(WANT))
def test_schedule_at_every_conv_of_the_cnns(arch, dt):
    got = {}
    for ci, co, taps in _convs(arch):
        s = kc._schedule(ci, co, dt, True, kernel=taps)
        got[s] = got.get(s, 0) + 1
    assert got == WANT[arch][dt]


# (CI, CO, dtype, aligned) -> schedule, around each rule's edges (no taps:
# mid_ci reads a 1x1 conv)
EDGES = [
    ((64, 64, BF, True), "wgmma"), ((128, 8, BF, True), "wgmma"),
    ((64, 1000, BF, True), "wgmma"), ((512, 512, BF, True), "wgmma"),
    ((63, 64, BF, True), "simt"), ((32, 64, BF, True), "mid_ci"),
    ((8, 64, BF, True), "mid_ci"), ((16, 8, BF, True), "mid_ci"),
    ((24, 64, BF, True), "mid_ci"), ((48, 96, BF, True), "mid_ci"),
    ((56, 1024, BF, True), "mid_ci"), ((12, 64, BF, True), "simt"),
    ((16, 12, BF, True), "simt"), ((32, 64, BF, False), "simt"),
    ((8, 16, BF, False), "simt"), ((48, 64, torch.float16, True), "simt"),
    ((96, 64, BF, True), "simt"), ((64, 12, BF, True), "simt"),
    ((64, 64, BF, False), "simt"), ((3, 64, BF, True), "simt"),
    ((64, 64, F32, True), "ffma"), ((32, 64, F32, True), "ffma"),
    ((4, 16, F32, True), "ffma"), ((12, 20, F32, True), "ffma"),
    ((63, 64, F32, True), "simt"), ((64, 62, F32, True), "simt"),
    ((6, 16, F32, True), "simt"), ((64, 64, F32, False), "simt"),
    ((64, 64, torch.float16, True), "simt"),
]


@pytest.mark.parametrize("args,want", EDGES,
                         ids=[f"ci{a[0]}-co{a[1]}-{str(a[2])[6:]}"
                              f"{'' if a[3] else '-unaligned'}"
                              for a, _ in EDGES])
def test_schedule_edges(args, want):
    assert kc._schedule(*args) == want


# (CI, CO, dtype, aligned, (kh, kw, stride)) -> schedule around small_ci's
# edges: CI 7 in, CI 8 out (to mid_ci in bf16); fp32 with CI a multiple of
# 4 stays on ffma
# (aligned), takes small_ci unaligned; K = 256 in (CI 1 at 16 x 16, CI 4 at
# 8 x 8), 260 and 320 out; a halo of 3036 elements in, 3080 out (CI 1, 16 x
# 9 and 16 x 10 taps at stride 4: 44 x 69 and 44 x 70 pixels); float16 out;
# any alignment in
TAP_EDGES = [
    ((3, 64, BF, True, (7, 7, 2)), "small_ci"),
    ((3, 64, F32, True, (7, 7, 2)), "small_ci"),
    ((3, 32, BF, True, (3, 3, 2)), "small_ci"),
    ((3, 64, BF, False, (7, 7, 2)), "small_ci"),
    ((7, 16, BF, True, (3, 3, 1)), "small_ci"),
    ((8, 16, BF, True, (3, 3, 1)), "mid_ci"),
    ((4, 16, F32, True, (5, 5, 2)), "ffma"),
    ((4, 16, F32, False, (5, 5, 2)), "small_ci"),
    ((6, 16, F32, True, (5, 5, 1)), "small_ci"),
    ((1, 6, BF, True, (16, 16, 1)), "small_ci"),
    ((1, 6, BF, True, (2, 130, 1)), "simt"),
    ((4, 8, BF, True, (8, 8, 1)), "small_ci"),
    ((5, 8, BF, True, (8, 8, 1)), "simt"),
    ((1, 4, BF, True, (16, 9, 4)), "small_ci"),
    ((1, 4, BF, True, (16, 10, 4)), "simt"),
    ((3, 64, torch.float16, True, (7, 7, 2)), "simt"),
    ((64, 64, BF, True, (3, 3, 1)), "wgmma"),
    ((32, 64, BF, True, (1, 1, 1)), "mid_ci"),
    # mid_ci's K bound (576): 3x3 at CI 16, 48 and 56 in; 8 x 9 taps of 8
    # channels (576) in, 7 x 11 (616) and the 7x7 stem at CI 16 (784) out;
    # unaligned out
    ((16, 64, BF, True, (3, 3, 2)), "mid_ci"),
    ((48, 64, BF, True, (3, 3, 1)), "mid_ci"),
    ((56, 64, BF, True, (3, 3, 1)), "mid_ci"),
    ((8, 64, BF, True, (8, 9, 1)), "mid_ci"),
    ((8, 64, BF, True, (7, 11, 1)), "simt"),
    ((16, 64, BF, True, (7, 7, 2)), "simt"),
    ((32, 64, BF, False, (1, 1, 1)), "simt"),
    ((63, 64, BF, True, (1, 1, 1)), "simt"),
]


@pytest.mark.parametrize("args,want", TAP_EDGES,
                         ids=[f"ci{a[0]}-co{a[1]}-{str(a[2])[6:]}"
                              f"-k{a[4][0]}x{a[4][1]}s{a[4][2]}"
                              f"{'' if a[3] else '-unaligned'}"
                              for a, _ in TAP_EDGES])
def test_schedule_edges_with_taps(args, want):
    *head, taps = args
    assert kc._schedule(*head, kernel=taps) == want


# every distinct ResNet-34 conv at batch 8, 224 px: (name, M = 8 Ho Wo,
# K = k k CI, CO)
RESNET = [("3x3s1_64@56", 8 * 56 * 56, 9 * 64, 64),
          ("3x3s2_64to128", 8 * 28 * 28, 9 * 64, 128),
          ("3x3s1_128@28", 8 * 28 * 28, 9 * 128, 128),
          ("1x1s2_64to128", 8 * 28 * 28, 64, 128),
          ("3x3s2_128to256", 8 * 14 * 14, 9 * 128, 256),
          ("3x3s1_256@14", 8 * 14 * 14, 9 * 256, 256),
          ("1x1s2_128to256", 8 * 14 * 14, 128, 256),
          ("3x3s2_256to512", 8 * 7 * 7, 9 * 256, 512),
          ("3x3s1_512@7", 8 * 7 * 7, 9 * 512, 512),
          ("1x1s2_256to512", 8 * 7 * 7, 256, 512)]


def _blocks(M, CO):
    return -(-M // 128) * -(-CO // (64 if CO == 64 else 128))


@pytest.mark.parametrize("name,M,K,CO", RESNET, ids=[r[0] for r in RESNET])
def test_conv_split_covers_k_in_whole_stages(name, M, K, CO):
    nsplit, kc_ = kc._conv_split(M, K, CO)
    assert kc_ % 64 == 0 and nsplit >= 1
    assert (nsplit - 1) * kc_ < K <= nsplit * kc_        # no empty split
    blocks, stages = _blocks(M, CO), -(-K // 64)
    if 2 * blocks >= SMS:                                # half a wave: kept
        assert nsplit == 1
    else:        # to half a wave or more, as far as K's stages allow, and
        # within one wave of one block an SM
        assert blocks * nsplit <= SMS
        assert 2 * blocks * nsplit >= SMS or nsplit == stages


def test_conv_split_of_the_deep_layers():
    """The 7 x 7 and 14 x 14 layers (16 and 26 blocks) reach 128 and 130
    blocks; the 28 x 28 ones (49) 98; the 56 x 56 one (196) is unsplit."""
    got = {name: _blocks(M, CO) * kc._conv_split(M, K, CO)[0]
           for name, M, K, CO in RESNET}
    assert got["3x3s1_512@7"] == 128 and got["3x3s2_256to512"] == 128
    assert got["3x3s1_256@14"] == 130 and got["3x3s2_128to256"] == 130
    assert got["3x3s1_128@28"] == 98 and got["3x3s1_64@56"] == 196


@pytest.mark.parametrize("blocks,K", [(1, 64), (1, 4608), (16, 4608),
                                      (65, 2048), (66, 2048), (64, 2560),
                                      (200, 20), (3, 100)])
def test_wave_split_is_the_matmul_rule_too(blocks, K):
    """The matmul ffma schedule's split: the same rule on its own grid."""
    nsplit, kc_ = km._wave_split(blocks, K, SMS)
    assert kc_ % km.WAVE_STAGE == 0 and (nsplit - 1) * kc_ < K <= nsplit * kc_
    assert nsplit == 1 or blocks * nsplit <= SMS
    assert (nsplit == 1) == (2 * blocks >= SMS or K <= km.WAVE_STAGE)


def test_cpu_wrapper_counts_no_schedule():
    """On CPU tensors the wrapper runs the plain version and neither count
    moves."""
    before = (kc.conv2d_fused.launches,
              dict(kc.conv2d_fused.schedule_launches))
    x, w = torch.randn(1, 6, 6, 64), torch.randn(3, 3, 64, 64)
    assert torch.equal(kc.conv2d_fused(x, w), kc.conv2d_fused_plain(x, w))
    assert torch.equal(kc.conv2d_fused(x.bfloat16(), w.bfloat16()),
                       kc.conv2d_fused_plain(x.bfloat16(), w.bfloat16()))
    assert (kc.conv2d_fused.launches,
            kc.conv2d_fused.schedule_launches) == before
    assert set(kc.conv2d_fused.schedule_launches) == set(kc.SCHEDULES)
