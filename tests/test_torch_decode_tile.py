"""decode_attention's tile on the CPU: the split's chunk in slots, the
port's counterpart of the Pallas kernel's ``block_k``.

* ``check_tile`` accepts and refuses a pinned chunk by the rules the auto
  split keeps (whole 16-slot tiles, at most ``MAX_CHUNK``, at most
  ``MAX_SPLITS`` splits, at least ``min_chunk`` and ``combine_chunk``, a
  block's shared memory within an SM; the simt schedule's 64-slot tiles);
* ``splits`` with an explicit chunk equals the auto form at the auto
  form's own chunk, at every rolling cache ``chip_smoke.py`` runs;
* the tiling pass's Hopper target: ``"auto"`` with ``tile_select``, JAX's
  512 without where the rules take it, else the least chunk they take; an
  override passes through; the static verifier's X002 refuses what the
  rules refuse and K202 reads the pinned chunk;
* the dry-run's stand-in raises at a refused chunk as the wrapper does;
* the kernels' arithmetic at a pinned chunk (the CPU model of
  ``tests/test_torch_decode_schedule.py``) against the Pallas kernel in
  interpret mode at the same ``block_k``, fp32 within 1e-5;
* a CPU plan's tile table and ``describe()`` stay the JAX package's.

The kernels run at each chunk only on the card (``tests/test_torch_gpu.py``
and ``chip_smoke.py``'s phase 22).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import relerr
from repro.configs import get_config as jget_config
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.plan import _build_plan as jbuild_plan
from repro.kernels import ops as jops
from repro_torch.analysis import verify_plan
from repro_torch.configs import get_config
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core.passes import tiling
from repro_torch.core.plan import _build_plan
from repro_torch.kernels import _fake
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import workingset as ws
from test_torch_decode_schedule import ROLLING, _roll_inputs, rolling_model

N_SM = 132
BF16, FP32 = torch.bfloat16, torch.float32


def _least(C, G, D, dt):
    rows, elem = min(G, tdec.ROWS), dt.itemsize
    splits = -(-C // tdec.MAX_SPLITS)
    return max(tdec.min_chunk(rows, D, elem),
               tdec.combine_chunk(C, rows, D, elem),
               -(-splits // tdec.TILE) * tdec.TILE)


# (what, C, G, D, dtype, chunk, accepted)
CASES = [
    ("llama_512", 1024, 4, 64, BF16, 512, True),
    ("off_tile", 1024, 4, 64, BF16, 520, False),
    ("max_chunk", 4096, 4, 64, BF16, tdec.MAX_CHUNK, True),
    ("over_max_chunk", 4096, 4, 64, BF16, tdec.MAX_CHUNK + 16, False),
    ("max_splits", 65536, 1, 64, BF16, 512, True),          # 128 splits
    ("over_max_splits", 65552, 1, 64, BF16, 512, False),
    ("under_min_chunk", 256, 16, 64, BF16, 64, False),      # min_chunk 80
    ("at_min_chunk", 256, 16, 64, BF16, 80, True),
    ("under_combine", 16384, 16, 64, BF16, 512, False),     # combine 528
    ("at_combine", 16384, 16, 64, BF16, 528, True),
    ("fp32_d256", 1024, 10, 256, FP32, 256, True),
    ("zero", 1024, 4, 64, BF16, 0, False),
    ("simt_64s", 1024, 2, 32, BF16, 128, True),
    ("simt_off_tile", 1024, 2, 32, FP32, 96, False),
    ("simt_over_max_splits", 16384, 2, 16, FP32, 64, False),
]


@pytest.mark.parametrize("what,C,G,D,dt,chunk,ok", CASES,
                         ids=[c[0] for c in CASES])
def test_check_tile_accepts_and_refuses_by_the_rules(what, C, G, D, dt,
                                                      chunk, ok):
    if ok:
        assert tdec.check_tile(chunk, 8, C, 8, G, D, dt) == chunk
        assert tdec.splits(8, C, 8, G, D, dt, N_SM, chunk) == \
            (-(-C // chunk), chunk)
    else:
        with pytest.raises(ValueError, match="decode_attention"):
            tdec.check_tile(chunk, 8, C, 8, G, D, dt)


def test_check_tile_refuses_what_is_not_a_chunk():
    for tile in ("512", 512.0, True, (512,)):
        with pytest.raises(ValueError, match="chunk of slots"):
            tdec.check_tile(tile, 8, 1024, 8, 4, 64, BF16)
    assert tdec.check_tile(np.int64(512), 8, 1024, 8, 4, 64, BF16) == 512
    assert tdec.pinned(None) is None and tdec.pinned("auto") is None
    assert tdec.pinned(256) == 256


def test_check_tile_holds_the_shared_memory_rule(monkeypatch):
    """A chunk whose slot map takes a block's shared memory past an SM's
    is refused (no chunk up to MAX_CHUNK does so on an H100 at these
    tiles, so the SM is shrunk here)."""
    room = tdec._core_smem(FP32, 256, 256) + 1024
    monkeypatch.setattr(tdec, "SM_SHARED", room)
    assert tdec.check_tile(256, 1, 1024, 1, 10, 256, FP32) == 256
    with pytest.raises(ValueError, match="shared bytes"):
        tdec.check_tile(272, 1, 1024, 1, 10, 256, FP32)


@pytest.mark.parametrize("dt", [BF16, FP32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name,B,C,KV,G,D", ROLLING)
def test_explicit_splits_equal_the_auto_form(name, B, C, KV, G, D, dt):
    """At the auto form's own chunk the explicit form is the auto form;
    the least chunk the rules take is accepted and a tile less refused."""
    auto = tdec.splits(B, C, KV, G, D, dt, N_SM)
    assert tdec.splits(B, C, KV, G, D, dt, N_SM, auto[1]) == auto
    assert tdec.check_tile(auto[1], B, C, KV, G, D, dt) == auto[1]
    least = tdec.least_tile(C, G, D, dt)
    assert least == _least(C, G, D, dt) <= auto[1]
    if least > tdec.TILE:
        with pytest.raises(ValueError):
            tdec.check_tile(least - tdec.TILE, B, C, KV, G, D, dt)


def test_least_tile_of_the_simt_schedule_and_of_no_split():
    assert tdec.least_tile(16384, 2, 32, BF16) == 128       # 16384 / 128
    assert tdec.least_tile(1024, 2, 16, FP32) == 64
    assert tdec.least_tile(tdec.MAX_SPLITS * tdec.MAX_CHUNK + 16, 4, 64,
                           BF16) is None


# (arch, seq_len): decode cells whose rolling caches the base flow pins
DECODE = [("llama3.2-1b", 1024), ("llama3.2-1b", 32768),
          ("llama3.2-1b", 131072), ("recurrentgemma-2b", 32768),
          ("qwen1.5-4b", 1024), ("whisper-small", 448)]


@pytest.mark.parametrize("prec", ["bf16", "fp32"])
@pytest.mark.parametrize("arch,S", DECODE)
def test_hopper_target_decode_tile(arch, S, prec):
    cfg = get_config(arch)
    a = cfg.attention
    sh = ShapeConfig("serve", "decode", S, 8)
    C = min(S, a.window) if a.window else S
    G, dt = a.n_heads // a.n_kv_heads, BF16 if prec == "bf16" else FP32
    sel = tiling.run(cfg, sh, FlowConfig(precision=prec), "cuda")
    assert sel["decode_attention"] == "auto"
    base = tiling.run(cfg, sh, FlowConfig(precision=prec).base(), "cuda")
    try:
        want = tdec.check_tile(512, 8, C, a.n_kv_heads, G, a.head_dim, dt)
    except ValueError:
        want = tdec.least_tile(C, G, a.head_dim, dt)
    assert base["decode_attention"] == want
    assert (want == 512) == (C <= 512 * tdec.MAX_SPLITS)
    # an override passes through unchanged, on either flow
    for flow in (FlowConfig(precision=prec), FlowConfig(precision=prec).base()):
        for tile in (256, "auto"):
            ov = dataclasses.replace(
                flow, tile_overrides=(("decode_attention", tile),))
            assert tiling.run(cfg, sh, ov, "cuda")["decode_attention"] == tile
    # the CPU plan keeps the JAX package's table
    cpu = tiling.run(cfg, sh, FlowConfig(precision=prec).base(), "cpu")
    assert cpu["decode_attention"] == 512


def test_verifier_reads_the_pinned_chunk():
    """X002 refuses a chunk the rules refuse at the plan's cache; K202's
    working set is the pinned chunk's (its slot map in shared memory)."""
    cfg = get_config("llama3.2-1b")
    sh = ShapeConfig("serve", "decode", 1024, 8)
    for tile, bad in ((256, False), (520, True), (4096, True)):
        flow = FlowConfig(mode="folded",
                          tile_overrides=(("decode_attention", tile),))
        plan = _build_plan(cfg, flow, sh, platform="cuda")
        codes = {d.code for d in verify_plan(plan).diagnostics}
        assert plan.tiles["decode_attention"] == tile
        assert ("X002" in codes) == bad, (tile, codes)
    s, b = ws.decode_attention(64, 4, BF16, 8, 1024, 8, tile=256)
    assert (s, b) == ("mma", tdec._core_smem(BF16, 64, 256))
    assert ws.decode_attention(64, 4, BF16, 8, 1024, 8, tile="auto") == \
        ws.decode_attention(64, 4, BF16, 8, 1024, 8)
    with pytest.raises(ValueError):
        ws.decode_attention(64, 4, BF16, 8, 1024, 8, tile=520)


def test_fake_refuses_a_chunk_as_the_wrapper_does():
    _fake.COST.clear()
    with FakeTensorMode():
        q = torch.empty(8, 1, 32, 64, dtype=BF16)
        kc = torch.empty(8, 1024, 8, 64, dtype=BF16)
        pos = torch.empty(8, 1024, dtype=torch.int32)
        qp = torch.empty(8, 1, dtype=torch.int32)
        for tile in (None, "auto", 256):
            assert tdec.decode_attention_fake(q, kc, kc, pos, qp,
                                              tile=tile).shape == q.shape
        with pytest.raises(ValueError, match="multiple of 16"):
            tdec.decode_attention_fake(q, kc, kc, pos, qp, tile=520)
    assert _fake.COST["decode_attention"]["calls"] == 3


def test_cpu_wrapper_runs_the_plain_version_at_any_tile():
    """A CPU tensor takes the plain version, whose result does not depend
    on the tile; the wrapper counts nothing there."""
    arrs, kw = _roll_inputs("half_gqa", seed=1)
    t = [torch.from_numpy(a) for a in arrs]
    n0 = tdec.decode_attention.launches
    want = tdec.decode_attention_plain(*t, **kw)
    for tile in (None, "auto", 16, 64):
        assert torch.equal(tdec.decode_attention(*t, tile=tile, **kw), want)
    assert tdec.decode_attention.launches == n0


@pytest.mark.parametrize("name,chunks", [("half_gqa", (32, 48, 96)),
                                         ("group3", (16, 32, 64))])
def test_model_at_a_pinned_chunk_matches_pallas_at_its_block_k(name, chunks):
    """The mma schedule's arithmetic split at each chunk the rules take (a
    tile less is refused), against the Pallas kernel at ``block_k`` = the
    chunk (its tile), fp32 within 1e-5."""
    arrs, kw = _roll_inputs(name, seed=11)
    q, kc = arrs[0], arrs[1]
    B, C, KV, D = kc.shape
    G = q.shape[2] // KV
    t = [torch.from_numpy(a) for a in arrs]
    assert tdec.least_tile(C, G, D, BF16) == chunks[0]
    for chunk in chunks:
        assert tdec.check_tile(chunk, B, C, KV, G, D, BF16) == chunk
        pal = np.asarray(jops.decode_attention(
            *(jnp.asarray(a) for a in arrs), tile=chunk, interpret=True,
            **kw))
        y = rolling_model(*t, chunk=chunk, **kw).numpy()
        assert relerr(y, pal) < 1e-5, chunk


@pytest.mark.parametrize("select", [True, False])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b",
                                  "resnet34"])
def test_cpu_plan_describe_is_jax(arch, select):
    """A CPU plan's tile table is JAX's key for key, so its ``describe()``
    lines carry JAX's tiles, the decode tile among them."""
    sh = ("serve", "decode", 1024, 8) if arch != "resnet34" \
        else ("serve", "prefill", 64, 8)
    plan = _build_plan(get_config(arch), FlowConfig(tile_select=select),
                       ShapeConfig(*sh), platform="cpu")
    jplan = jbuild_plan(jget_config(arch), JFlowConfig(tile_select=select),
                        JShapeConfig(*sh))
    assert plan.tiles == jplan.tiles

    def tiles_line(text):
        return [ln for ln in text.splitlines() if "tiles:" in ln]
    assert tiles_line(plan.describe()) == tiles_line(jplan.describe())
