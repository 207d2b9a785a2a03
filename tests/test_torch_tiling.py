"""The tiling pass's Hopper target, on the CPU: plan-level and cheap.

A plan for the CPU keeps the JAX package's tile table key for key; a plan
for the card (built here without one) takes the Hopper tiles the hand
kernels read, which by default are the blocks each kernel took before it
took a tile, and in the base flow the minimal ones.  The static verifier
refuses a tile no kernel takes (X002) or whose working set exceeds the 227
KiB a block may opt in to (K202).  The pure helpers the wrappers launch
with (``block_of``, ``_conv_split``, ``_ffma_blocks``, ``_ffma_smem_bytes``,
the working-set mirrors) are pinned at every candidate tile; the kernels
themselves run at each candidate only on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``'s phase 22).
"""
import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.passes import tiling as jtiling
from repro_torch import flow as tflow
from repro_torch.analysis import verify_plan
from repro_torch.configs import ARCHS, CNNS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core.passes import tiling
from repro_torch.core.plan import _build_plan
from repro_torch.kernels import attention as ka
from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import matmul_fused as km
from repro_torch.kernels import ops as kops
from repro_torch.kernels import workingset as ws

BF, F32 = torch.bfloat16, torch.float32
LM_SHAPES = {"serve": ("serve", "decode", 1024, 8),
             "train": ("train", "train", 512, 8)}
CNN_SHAPES = {"serve": ("serve", "prefill", 64, 8),
              "train": ("train", "train", 64, 8)}
# the blocks each kernel took before it took a tile: matmul_wgmma.cu's
# PLAIN_BN, conv2d.py's bn for CO above 64, flash_attention_wgmma.cu's BQ,
# attention.py's FFMA_TILES query rows
HARD_CODED = {"matmul": (128, 64, 128), "conv2d": (128, 128),
              "attention": {"bf16": {64: 128, 128: 128, 256: 128},
                            "fp32": {64: 64, 128: 128, 256: 64}}}
MINIMAL = {"matmul": (128, 64, 64), "attention": (64, 64),
           "conv2d": (128, 64)}


def _shape(name, kind):
    fam = get_config(name).family
    return (CNN_SHAPES if fam == "cnn" else LM_SHAPES)[kind]


@pytest.mark.parametrize("select", [True, False])
@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_cpu_tile_table_equals_jax(name, kind, select):
    """A CPU plan's tile table is ``repro.core.passes.tiling.run``'s, at the
    serve and train shapes, with tile selection on and off."""
    sh = _shape(name, kind)
    want = jtiling.run(jget_config(name), JShapeConfig(*sh),
                       JFlowConfig(tile_select=select))
    got = tiling.run(get_config(name), ShapeConfig(*sh),
                     FlowConfig(tile_select=select), "cpu")
    assert got == want


@pytest.mark.parametrize("name", ["llama3.2-1b", "resnet34"])
def test_cpu_plan_carries_the_jax_table(name):
    """The pass writes the table into the plan (and its stats) unchanged."""
    sh = _shape(name, "serve")
    plan = _build_plan(get_config(name), FlowConfig(mode="folded"),
                       ShapeConfig(*sh), platform="cpu")
    assert plan.tiles == jtiling.run(jget_config(name), JShapeConfig(*sh),
                                     JFlowConfig(mode="folded"))
    bm, bk, bn = plan.tiles["matmul"]
    assert plan.pass_stats["tiling"]["matmul_workingset_bytes"] == \
        (bm * bk + bk * bn) * 2 + bm * bn * 6


@pytest.mark.parametrize("prec", ["bf16", "fp32"])
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_cuda_plan_selects_the_hard_coded_blocks(name, prec):
    """A card plan's default flow selects exactly the blocks the kernels
    took before they took a tile; the base flow the minimal tiles; every
    other key is the TPU table's."""
    cfg, sh = get_config(name), ShapeConfig(*_shape(name, "serve"))
    flow = FlowConfig(mode="folded", precision=prec)
    tiles = tiling.run(cfg, sh, flow, "cuda")
    tpu = tiling.run(cfg, sh, flow, "cpu")
    assert tiles["matmul"] == HARD_CODED["matmul"]
    assert tiles["conv2d"] == HARD_CODED["conv2d"]
    if cfg.attention is not None:
        d = cfg.attention.head_dim
        assert tiles["attention"] == (HARD_CODED["attention"][prec][d], 64)
    assert set(tiles) == set(tpu)
    assert {k: v for k, v in tiles.items() if k not in MINIMAL} == \
        {k: v for k, v in tpu.items() if k not in MINIMAL}
    base = tiling.run(cfg, sh, flow.base() if prec == "fp32"
                      else FlowConfig(tile_select=False), "cuda")
    assert {k: base[k] for k in MINIMAL} == MINIMAL
    plan = _build_plan(cfg, flow, sh, platform="cuda")
    assert plan.tiles == tiles
    assert plan.pass_stats["tiling"]["matmul_workingset_bytes"] == \
        (99376 if prec == "bf16" else 73728)


def test_cuda_plan_default_is_the_wrappers_default():
    """The selected table is what a wrapper takes without a tile."""
    for D in ka.TILED_HEAD_DIMS:
        assert ka.default_tile(BF, D) == (128, 64)
        assert ka.default_tile(F32, D) == (ka.FFMA_TILES[D][0], 64)
    assert km.HOPPER_TILE == km.block_of("wgmma", False)
    assert kc.DEFAULT_TILE == kc.block_of("wgmma", 128)


def test_allowance_shrinks_a_tile_to_fit():
    """The selector shrinks a tile whose working set exceeds min(227 KiB,
    vmem_budget_bytes // 4); at the flow's 96 / 48 MiB candidates it never
    binds."""
    cfg = get_config("recurrentgemma-2b")            # head width 256
    for vmem in FlowConfig().tuning.vmem_candidates:
        flow = FlowConfig(vmem_budget_bytes=vmem)
        assert tiling.hopper_allowance(flow) == tiling.BLOCK_SHARED
        assert tiling.hopper_tiles(cfg, flow) == {
            "matmul": (128, 64, 128), "attention": (128, 64),
            "conv2d": (128, 128)}
    tight = FlowConfig(vmem_budget_bytes=4 * 190_000)
    assert tiling.hopper_allowance(tight) == 190_000
    # wgmma at D 256: bq 128 asks 198,192 bytes, bq 64 165,424
    assert tiling.hopper_tiles(cfg, tight)["attention"] == (64, 64)
    assert tiling.hopper_tiles(cfg, tight)["matmul"] == (128, 64, 128)


def test_overrides_apply_on_a_cuda_plan():
    """``tile_overrides`` pin a Hopper tile on a card plan (a list from the
    tune database becomes a tuple); a key the cell lacks is ignored."""
    ov = (("attention", [64, 64]), ("matmul", (128, 64, 64)))
    flow = FlowConfig(mode="folded", tile_overrides=ov)
    lm = _build_plan(get_config("llama3.2-1b"), flow,
                     ShapeConfig(*LM_SHAPES["serve"]), platform="cuda")
    assert lm.tiles["attention"] == (64, 64)
    assert lm.tiles["matmul"] == (128, 64, 64)
    assert lm.tiles["conv2d"] == (128, 128)
    cnn = _build_plan(get_config("resnet34"), flow,
                      ShapeConfig(*CNN_SHAPES["serve"]), platform="cuda")
    assert "attention" not in cnn.tiles
    assert cnn.tiles["matmul"] == (128, 64, 64)
    assert verify_plan(lm).ok and verify_plan(cnn).ok


def _codes(result):
    return [d.code for d in result.diagnostics]


def test_oversized_tile_draws_k202():
    """fp32 flash at head width 256 and bq 128 needs 301,568 shared bytes:
    a tile the ffma kernel does not take, refused by K202 before any
    launch (X002 takes it: it is one of the kernels' tiles)."""
    flow = FlowConfig(mode="folded", precision="fp32", kernel_backend="cuda",
                      tile_overrides=(("attention", (128, 64)),))
    plan = _build_plan(get_config("recurrentgemma-2b"), flow,
                       ShapeConfig(*LM_SHAPES["serve"]), platform="cuda")
    res = verify_plan(plan)
    assert not res.ok
    assert "K202" in _codes(res) and "X002" not in _codes(res)
    (k202,) = [d for d in res.diagnostics if d.code == "K202"]
    assert "attention" in k202.message and "301568" in k202.message
    ok = _build_plan(get_config("recurrentgemma-2b"),
                     FlowConfig(mode="folded", precision="fp32",
                                kernel_backend="cuda"),
                     ShapeConfig(*LM_SHAPES["serve"]), platform="cuda")
    assert verify_plan(ok).ok


def test_cuda_decode_plan_draws_no_x002():
    """On the card no even division is needed (m 8 against bm 128 at a
    decode step): a card decode plan is clean; a tile no kernel takes is
    X002."""
    flow = FlowConfig(mode="folded", kernel_backend="cuda")
    plan = _build_plan(get_config("llama3.2-1b"), flow,
                       ShapeConfig(*LM_SHAPES["serve"]), platform="cuda")
    res = verify_plan(plan)
    assert res.ok and "X002" not in _codes(res)
    bad = _build_plan(get_config("llama3.2-1b"), FlowConfig(
        mode="folded", kernel_backend="cuda",
        tile_overrides=(("matmul", (256, 512, 256)),)),
        ShapeConfig(*LM_SHAPES["serve"]), platform="cuda")
    res = verify_plan(bad)
    assert _codes(res).count("X002") == 1 and not res.ok
    assert bad.pass_stats["tiling"]["matmul_workingset_bytes"] is None


@pytest.mark.parametrize("D,bq,want", [
    (64, 64, 105472), (64, 128, 122624), (128, 64, 153344),
    (128, 128, 204544), (256, 64, 217600), (256, 128, 301568)])
def test_ffma_smem_bytes_at_each_tile(D, bq, want):
    """The ffma kernel's shared bytes at each (D, bq), as
    ``csrc/flash_attention_ffma.cu`` static_asserts them (D 256 at 128
    rows: the two-slot ring it would need, over the limit)."""
    assert ka._ffma_smem_bytes(D, bq) == want
    assert ((D, bq) in ka.FFMA_RING) == (want <= ws.BLOCK_SHARED)


@pytest.mark.parametrize("bq", [64, 128])
def test_ffma_blocks_at_each_tile(bq):
    """The launch order at each bq covers every (query tile, head, batch
    row) once, the last query tile first."""
    B, Sq, H, D = 2, 300, 4, 64
    order = ka._ffma_blocks(B, Sq, H, D, bq)
    nq = -(-Sq // bq)
    assert sorted(order) == sorted((t, h, b) for t in range(nq)
                                   for h in range(H) for b in range(B))
    assert order[0][0] == nq - 1 and order[-1][0] == 0
    assert ka._ffma_blocks(B, Sq, H, D) == \
        ka._ffma_blocks(B, Sq, H, D, ka.FFMA_TILES[D][0])


def test_block_of_refuses_what_no_kernel_takes():
    """A tile a schedule does not take raises; it is never replaced."""
    assert ka.block_of("ffma", 256, F32, (64, 64)) == (64, 64)
    with pytest.raises(ValueError, match="ffma kernel takes no tile"):
        ka.block_of("ffma", 256, F32, (128, 64))
    assert ka.block_of("wgmma", 256, BF, (128, 64)) == (128, 64)
    assert ka.block_of("simt", 32, BF, (128, 64)) is None
    for mod, bad in ((ka, (128, 128)), (kc, (8, 128)),
                     (km, (256, 512, 256))):
        with pytest.raises(ValueError, match="no kernel takes the tile"):
            mod.check_tile(bad)
    assert kc.block_of("wgmma", 64, (128, 128)) == (128, 64)
    assert kc.block_of("ffma", 256, (128, 64)) == (128, 64)
    assert kc.block_of("mid_ci", 64, (128, 128)) is None
    assert km.block_of("wgmma", True, (128, 64, 128)) == (128, 64, 64)
    assert km.block_of("ffma", False, [128, 64, 64]) == (128, 64, 64)
    assert km.block_of("small_m", False, (128, 64, 64)) is None


@pytest.mark.parametrize("M,K,CO", [(8 * 56 * 56, 576, 64),
                                    (8 * 28 * 28, 1152, 128),
                                    (8 * 14 * 14, 2304, 256),
                                    (8 * 7 * 7, 4608, 512)])
def test_conv_split_at_each_tile(M, K, CO):
    """The K split of ResNet-34's 3 x 3 convs at batch 8 at each candidate:
    the grid of 128-pixel x bn-channel blocks (bn 64 for a 64-channel conv
    under either tile) split by ``_wave_split``."""
    for tile in kc.TILES:
        bn = 64 if CO == 64 else tile[1]
        blocks = -(-M // 128) * -(-CO // bn)
        assert kc._conv_split(M, K, CO, 132, tile) == \
            km._wave_split(blocks, K, 132)
    assert kc._conv_split(M, K, CO) == kc._conv_split(M, K, CO, 132,
                                                      kc.DEFAULT_TILE)


@pytest.mark.parametrize("tile,wgmma,ffma", [((128, 64, 64), 74800, 57344),
                                             ((128, 64, 128), 99376, 73728)])
def test_matmul_workingset_at_each_tile(tile, wgmma, ffma):
    """The matmul kernels' shared bytes at each tile (the GLU form at bn 64
    under either)."""
    assert ws.matmul(4096, 2048, 2048, BF, False, tile=tile) == \
        ("wgmma", wgmma)
    assert ws.matmul(4096, 2048, 2048, F32, False, tile=tile) == \
        ("ffma", ffma)
    assert ws.matmul(4096, 2048, 8192, BF, True, tile=tile) == \
        ("wgmma", 99376)
    assert ws.matmul(4096, 2048, 8192, F32, True, tile=tile) == \
        ("ffma", 73728)
    assert ws.matmul(8, 2048, 2048, BF, False, tile=tile) == \
        ws.matmul(8, 2048, 2048, BF, False)


@pytest.mark.parametrize("tile,wgmma,ffma", [((128, 64), 74752, 57344),
                                             ((128, 128), 99328, 73728)])
def test_conv_workingset_at_each_tile(tile, wgmma, ffma):
    assert ws.conv2d(3, 3, 128, 128, 1, BF, tile=tile) == ("wgmma", wgmma)
    assert ws.conv2d(3, 3, 128, 128, 1, F32, tile=tile) == ("ffma", ffma)
    assert ws.conv2d(3, 3, 64, 64, 1, BF, tile=tile) == ("wgmma", 74752)


@pytest.mark.parametrize("D,bq,want", [
    (64, 64, 75864), (64, 128, 84056), (128, 64, 116548),
    (128, 128, 132932), (256, 64, 165424), (256, 128, 198192)])
def test_flash_workingset_at_each_tile(D, bq, want):
    """flash_attention_wgmma.cu's smem_bytes<D, BQ> and the ffma kernel's,
    through the mirror."""
    assert ws.flash_attention(D, BF, tile=(bq, 64)) == ("wgmma", want)
    assert ws.flash_attention(D, F32, tile=(bq, 64)) == \
        ("ffma", ka._ffma_smem_bytes(D, bq))


def test_fakes_accept_the_tile():
    """The dry-run's stand-ins take the plan's tile and refuse one no
    kernel takes, as the wrappers do."""
    x = torch.empty(4, 64)
    w = torch.empty(64, 32)
    assert km.matmul_fused_fake(x, w, tile=(128, 64, 64)).shape == (4, 32)
    with pytest.raises(ValueError):
        km.matmul_fused_fake(x, w, tile=(256, 512, 256))
    assert km.matmul_fused_fake(x, w, tile=(256, 512, 256),
                                vmem_accum=False).shape == (4, 32)
    q = torch.empty(1, 8, 2, 64)
    assert ka.flash_attention_fake(q, q, q, tile=(64, 64)).shape == q.shape
    with pytest.raises(ValueError):
        ka.flash_attention_fake(q, q, q, tile=(128, 128))
    xi = torch.empty(1, 8, 8, 4)
    wi = torch.empty(3, 3, 4, 8)
    assert kc.conv2d_fused_fake(xi, wi, tile=(128, 64)).shape == (1, 8, 8, 8)
    with pytest.raises(ValueError):
        kc.conv2d_fused_fake(xi, wi, tile=(8, 128))


def _logits(cm, params, batch):
    with torch.no_grad():
        return cm.prefill(params, batch)[0]


@pytest.mark.parametrize("name", ["llama3.2-1b", "lenet5"])
def test_smoke_forward_is_tile_invariant_on_the_cpu(name):
    """The smoke model's forward on the CPU (the kernels' plain versions
    under ``backend="cuda"``) under each candidate override equals the
    forward without one: the plain versions take no tile."""
    cfg = get_smoke(name)
    if cfg.family == "cnn":
        sh, key, cands = ShapeConfig("s", "prefill", 64, 2), "conv2d", kc.TILES
        rng = np.random.RandomState(0)
        batch = {"images": torch.from_numpy(rng.randn(
            2, cfg.image_size, cfg.image_size,
            cfg.image_channels).astype(np.float32))}
    else:
        sh, key, cands = ShapeConfig("s", "prefill", 16, 2), "attention", \
            ka.TILES
        rng = np.random.RandomState(0)
        batch = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int64))}
    base = tflow.compile(cfg, sh, FlowConfig(mode="folded"), backend="cuda",
                         device="cpu")
    params = base.init_params(0)
    want = _logits(base, params, batch)
    for tile in cands:
        cm = tflow.compile(cfg, sh, FlowConfig(
            mode="folded", tile_overrides=((key, tile),)), backend="cuda",
            device="cpu")
        assert cm.plan.tiles[key] == tile
        assert torch.equal(_logits(cm, params, batch), want)


def test_base_variant_slabs_are_held_to_jax():
    """The base variant reads its slab from JAX's TPU tile, never a Hopper
    one: through the facade (no tile: (256, 512, 256), 512-deep slabs) and
    at a CPU plan's matmul tile, the slab depth is JAX's bk = min(tile[1],
    rup(K, 128)), and the result equals JAX's Pallas kernel in interpret
    mode (within one bf16 ulp of the output's magnitude: both round each
    slab and each running sum to nearest even, the slab's fp32 sums taken
    in another order, as ``tests/test_torch_matmul_base.py`` states); the
    facade hands a CW call no TPU tile."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    rng = np.random.RandomState(0)
    M, K, N = 16, 1000, 48
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    cpu_tile = _build_plan(get_config("llama3.2-1b"), FlowConfig(),
                           ShapeConfig(*LM_SHAPES["train"]),
                           platform="cpu").tiles["matmul"]
    for tile in (None, cpu_tile):
        bk = km._slab_depth(K, tile or km.DEFAULT_TILE)
        assert bk == min((tile or (256, 512, 256))[1], -(-K // 128) * 128)
        got = kops.matmul_fused(torch.from_numpy(x).to(BF),
                                torch.from_numpy(w).to(BF), tile=tile,
                                vmem_accum=False)
        want = jops.matmul_fused(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w, jnp.bfloat16), tile=tile,
                                 vmem_accum=False, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got.float().numpy() - want).max() <= ulp
    # the Hopper tile never sets the slabs: the CW form takes it
    assert km._slab_depth(K, km.HOPPER_TILE) == 64 != \
        km._slab_depth(K, km.DEFAULT_TILE)
    y = kops.matmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                          tile=(256, 512, 256))
    torch.testing.assert_close(y, torch.from_numpy(x @ w), rtol=1e-5,
                               atol=1e-5)
