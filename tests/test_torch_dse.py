"""The port's estimator and design-space explorer held to the JAX
package's on the CPU: the estimator's outputs at the v5e and v5p presets,
``param_count``, the tunable space and the candidates' knob strings, the
winners of ``explore`` under ``validate="none"`` and ``"compile"``, the
F501 pruning counts and the explorer cache; then the port's own parts: the
``h100`` preset and the budget a search on the card takes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import TuningConfig as JTuningConfig
from repro.core import dse as jdse
from repro.core import estimator as jest
from repro_torch.configs import ARCHS, CNNS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig, TuningConfig
from repro_torch.core import dse, estimator

CNN_SERVE = ("bench", "prefill", 64, 8)
SHAPES = {
    "train": ("smoke", "train", 16, 2),
    "prefill": ("p", "prefill", 64, 8),
    "decode": ("d", "decode", 128, 4),
}
FLOWS = [
    {}, {"precision": "fp32"}, {"remat": "nested", "microbatches": 4},
    {"cached_writes": False, "fuse_epilogues": False, "tile_select": False},
    {"mesh_split": (("data", 2), ("model", 2))},
    {"mesh_split": (("data", 2), ("pod", 2)), "pp_axis": "pod"},
]


@pytest.fixture(autouse=True)
def _fresh_caches():
    dse.clear_explore_cache()
    jdse.clear_explore_cache()
    yield
    dse.clear_explore_cache()
    jdse.clear_explore_cache()


def _pair(name, smoke=True):
    return ((get_smoke if smoke else get_config)(name),
            (jget_smoke if smoke else jget_config)(name))


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, str):
        assert a == b
    else:
        assert abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300), (a, b)


# ---------------------------------------------------------------------------
# estimator parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_param_count_equals_jax(name, smoke):
    t, j = _pair(name, smoke)
    assert t.param_count() == j.param_count() > 0
    assert t.active_param_count() == j.active_param_count()
    assert estimator.non_embedding_params(t) == \
        jest.non_embedding_params(j)


@pytest.mark.parametrize("device", ["v5e", "v5p"])
@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_estimator_equals_jax(name, kind, device):
    t, j = _pair(name)
    sh = SHAPES[kind] if t.family != "cnn" else CNN_SERVE
    ts, js = ShapeConfig(*sh), JShapeConfig(*sh)
    _close(estimator.model_flops(t, ts), jest.model_flops(j, js))
    _close(estimator.attention_flops(t, ts), jest.attention_flops(j, js))
    _close(estimator.hbm_bytes_kernel_path(t, ts),
           jest.hbm_bytes_kernel_path(j, js))
    for over in FLOWS:
        tf, jf = FlowConfig(**over), JFlowConfig(**over)
        for dev in (1, 4):
            _close(estimator.estimate_footprint(t, ts, tf, dev),
                   jest.estimate_footprint(j, js, jf, dev))
            _close(estimator.estimate_step_seconds(t, ts, tf, dev, device),
                   jest.estimate_step_seconds(j, js, jf, dev, device))
        _close(estimator.estimate_comm_bytes(t, ts, tf),
               jest.estimate_comm_bytes(j, js, jf))


def test_tpu_presets_unchanged():
    for name in ("v5e", "v5p"):
        assert estimator.DEVICE_PRESETS[name] == jest.DEVICE_PRESETS[name]


def test_h100_preset():
    """The card's data-sheet rates (the bounds chip_smoke.py uses): fp32
    runs at 67 TFLOP/s, not half the bf16 rate as on the TPU presets."""
    p = estimator.DEVICE_PRESETS["h100"]
    assert (p["hbm_bw"], p["bf16_flops"], p["fp32_flops"]) == \
        (3.35e12, 989e12, 67e12)
    assert p["hbm_bytes"] == 80 * 1024 ** 3
    cfg, shape = get_config("llama3.2-1b"), ShapeConfig("t", "train", 512, 8)
    bf = estimator.estimate_step_seconds(cfg, shape, FlowConfig(),
                                         device="h100")
    fp = estimator.estimate_step_seconds(
        cfg, shape, FlowConfig(precision="fp32"), device="h100")
    flops = estimator.model_flops(cfg, shape) * 4 / 3 + \
        estimator.attention_flops(cfg, shape) * 4 / 3
    untiled = estimator.estimate_step_seconds(
        cfg, shape, FlowConfig(tile_select=False), device="h100")
    # the base flow's minimal Hopper tiles re-read A twice as often: 1.5x
    # the bytes (estimator.DEVICE_PRESETS["h100"]["plan_tiles"])
    assert p["plan_tiles"] == 1.5
    assert untiled["memory_s"] == pytest.approx(bf["memory_s"] * 1.5,
                                                rel=1e-12)
    assert untiled["compute_s"] == bf["compute_s"]
    assert fp["bound"] == "compute"
    assert fp["compute_s"] == pytest.approx(flops / 67e12, rel=1e-12)
    assert bf["compute_s"] == pytest.approx(flops / 989e12, rel=1e-12)
    if not torch.cuda.is_available():
        assert estimator.h100_hbm_bytes() == 80 * 1024 ** 3


def test_budget_and_preset_follow_the_device():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert dse.preset_for(cpu) == "v5e" and dse.preset_for(cuda) == "h100"
    assert dse.HBM_BYTES == jdse.HBM_BYTES == 16 * 1024 ** 3
    assert dse.budget_bytes(TuningConfig(), cpu) == dse.HBM_BYTES
    assert dse.budget_bytes(TuningConfig(), cuda) == \
        estimator.h100_hbm_bytes(cuda)
    custom = TuningConfig(hbm_bytes=1234)
    assert dse.budget_bytes(custom, cuda) == 1234
    assert dse.budget_bytes(custom, cpu) == 1234
    # a budget the caller sets is kept on the card, v5e's 16 GiB included
    v5e = TuningConfig(hbm_bytes=16 * 1024 ** 3)
    assert dse.budget_bytes(v5e, cuda) == 16 * 1024 ** 3
    assert TuningConfig().hbm_bytes is None


# ---------------------------------------------------------------------------
# the design space and the winners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_tunable_space_and_knob_strings_equal_jax(name, kind):
    t, j = _pair(name)
    sh = SHAPES[kind] if t.family != "cnn" else CNN_SERVE
    ts, js = ShapeConfig(*sh), JShapeConfig(*sh)
    tspace = dse.tunable_space(t, FlowConfig(mode="folded"), ts, "cpu")
    assert tspace == jdse.tunable_space(j, JFlowConfig(mode="folded"), js)
    cap = dict(tuning=TuningConfig(max_candidates=400))
    tc = dse.enumerate_candidates(t, ts, FlowConfig(mode="folded", **cap),
                                  device="cpu")
    jc = jdse.enumerate_candidates(
        j, js, JFlowConfig(mode="folded",
                           tuning=JTuningConfig(max_candidates=400)))
    assert [k for _, k in tc] == [k for _, k in jc]


@pytest.mark.parametrize("name,kind", [
    ("llama3.2-1b", "train"), ("llama3.2-1b", "decode"),
    ("recurrentgemma-2b", "decode"), ("phi4-mini-3.8b", "prefill"),
    ("qwen1.5-4b", "train"), ("stablelm-1.6b", "decode"),
    ("lenet5", "prefill"), ("mobilenetv1", "prefill"),
    ("resnet34", "prefill")])
def test_explore_none_picks_jax_winner(name, kind):
    t, j = _pair(name)
    sh = SHAPES[kind] if t.family != "cnn" else CNN_SERVE
    tr = dse.explore(t, ShapeConfig(*sh), use_cache=False, device="cpu")
    jr = jdse.explore(j, JShapeConfig(*sh), use_cache=False)
    assert tr.best.knob_str() == jr.best.knob_str()
    assert [c.knob_str() for c in tr.candidates[:8]] == \
        [c.knob_str() for c in jr.candidates[:8]]
    assert (tr.n_enumerated, tr.n_rejected, tr.n_static_pruned,
            tr.budget_bytes) == (jr.n_enumerated, jr.n_rejected,
                                 jr.n_static_pruned, jr.budget_bytes)
    assert tr.plan.describe().splitlines()[:4] == \
        jr.plan.describe().splitlines()[:4]


@pytest.mark.parametrize("name,smoke,kind", [
    ("lenet5", False, "prefill"), ("llama3.2-1b", True, "train"),
    ("resnet34", True, "prefill")])
def test_explore_compile_picks_jax_winner(name, smoke, kind):
    """validate="compile": the first fitting survivor in the estimator's
    order wins on both (the port records the estimator's footprint on the
    CPU, JAX the compiled module's; both fit)."""
    t, j = _pair(name, smoke)
    sh = SHAPES[kind] if t.family != "cnn" else CNN_SERVE
    ts, js = ShapeConfig(*sh), JShapeConfig(*sh)
    tr = dse.explore(t, ts, validator=dse.compile_validator(t, ts, "cpu"),
                     top_k=1, use_cache=False, device="cpu")
    jr = jdse.explore(j, js, validator=jdse.compile_validator(j, js),
                      top_k=1, use_cache=False)
    assert tr.best.knob_str() == jr.best.knob_str()
    assert tr.validated[0]["bytes_source"] == "estimator"
    assert tr.validated[0]["fits"] and tr.validated[0]["knobs"] == \
        jr.validated[0]["knobs"]
    assert tr.best.flow == tr.plan.flow


def test_f501_pruning_counts_equal_jax():
    space = {"kernel_backend": ("auto", "bogus", "reference"),
             "precision": ("bf16", "fp16", "fp32"),
             "microbatches": (0, 1, 2)}
    t, j = _pair("llama3.2-1b")
    tr = dse.explore(t, ShapeConfig(*SHAPES["train"]), space=space,
                     use_cache=False, device="cpu")
    jr = jdse.explore(j, JShapeConfig(*SHAPES["train"]), space=space,
                      use_cache=False)
    assert tr.n_static_pruned == jr.n_static_pruned == 27 - 8
    assert tr.best.knob_str() == jr.best.knob_str()


def test_explore_deterministic():
    cfg = get_smoke("llama3.2-1b")
    sh = ShapeConfig(*SHAPES["train"])
    r1 = dse.explore(cfg, sh, use_cache=False, device="cpu")
    r2 = dse.explore(cfg, sh, use_cache=False, device="cpu")
    assert r1 is not r2 and r1.best.flow == r2.best.flow
    assert [c.knobs for c in r1.candidates] == [c.knobs for c in r2.candidates]
    assert r1.plan.describe() == r2.plan.describe()


def test_explore_result_cached_across_calls():
    cfg = get_smoke("llama3.2-1b")
    sh = ShapeConfig(*SHAPES["train"])
    calls = []

    def validator(flow):
        calls.append(flow)
        return dse.compile_candidate(cfg, sh, flow, "cpu")

    r1 = dse.explore(cfg, sh, validator=validator, top_k=1, device="cpu")
    n = len(calls)
    assert n >= 1
    r2 = dse.explore(cfg, sh, validator=validator, top_k=1, device="cpu")
    assert r2 is r1 and len(calls) == n
    assert dse.explore_cache_stats()["hits"] == 1


def test_explore_cache_keys_on_backend_and_device(monkeypatch):
    cfg = get_smoke("llama3.2-1b")
    sh = ShapeConfig(*SHAPES["train"])
    f_auto = FlowConfig(mode="folded")
    f_ref = dataclasses.replace(f_auto, kernel_backend="reference")
    r1 = dse.explore(cfg, sh, f_auto, device="cpu")
    r2 = dse.explore(cfg, sh, f_ref, device="cpu")
    assert r1 is not r2
    assert dse.explore_cache_stats() == {"hits": 0, "misses": 2,
                                         "evictions": 0}
    assert dse.explore(cfg, sh, f_auto, device="cpu") is r1
    monkeypatch.setattr(dse, "_platform_key", lambda dev: "cuda:other card")
    assert dse.explore(cfg, sh, f_auto, device="cpu") is not r1


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("name", ["llama3.2-1b", "resnet34"])
def test_card_space_leaves_out_the_tile_knobs(name, kind):
    """On the card the hand kernels take their blocks from plan.tiles, so
    the space keeps ``tile_select`` (selected or minimal Hopper tiles) and
    drops only ``vmem_budget_bytes`` (:data:`dse.TILE_KNOBS`: its allowance
    never binds below the 227 KiB a block may opt in to); the rest is the
    CPU's (a cuda torch.device needs no card).  Every candidate keeps the
    base flow's vmem_budget_bytes, and both tile_select values are
    searched."""
    cfg = get_smoke(name)
    sh = ShapeConfig(*SHAPES[kind]) if cfg.family != "cnn" \
        else ShapeConfig(*CNN_SERVE)
    base = FlowConfig(mode="folded", vmem_budget_bytes=64 * 2 ** 20)
    cpu = dse.tunable_space(cfg, base, sh, "cpu")
    card = dse.tunable_space(cfg, base, sh, torch.device("cuda"))
    assert dse.TILE_KNOBS == ("vmem_budget_bytes",)
    assert set(dse.TILE_KNOBS) <= set(cpu)
    assert not set(dse.TILE_KNOBS) & set(card)
    assert card["tile_select"] == cpu["tile_select"] == (True, False)
    assert card == {k: v for k, v in cpu.items() if k not in dse.TILE_KNOBS}
    assert dse.tunable_space(cfg, base, sh) == card      # the card's default
    cands = dse.enumerate_candidates(cfg, sh, base, device="cuda")
    assert len({f for f, _ in cands}) == len(cands)
    assert {(f.tile_select, f.vmem_budget_bytes) for f, _ in cands} == \
        {(True, 64 * 2 ** 20), (False, 64 * 2 ** 20)}


def test_kernel_backend_is_a_tunable_dimension():
    cfg = get_smoke("llama3.2-1b")
    sh = ShapeConfig(*SHAPES["train"])
    space = dse.tunable_space(cfg, FlowConfig(mode="folded"), sh)
    assert space["kernel_backend"] == ("auto", "reference")


def test_explore_fits_budget_cnns_and_lm():
    for cfg in (get_config("lenet5"), get_config("mobilenetv1"),
                get_config("resnet34"), get_smoke("llama3.2-1b")):
        r = dse.explore(cfg, ShapeConfig(*CNN_SERVE), device="cpu")
        assert r.best.fits and r.best.footprint_bytes < r.budget_bytes
        assert set(r.plan.pass_stats) >= {"fusion", "folding", "tiling"}


def test_budget_is_a_config_knob():
    cfg = get_smoke("llama3.2-1b")
    sh = ShapeConfig(*SHAPES["train"])
    tight = FlowConfig(mode="folded", tuning=TuningConfig(hbm_bytes=1024))
    r = dse.explore(cfg, sh, tight, device="cpu")
    assert r.budget_bytes == 1024 and not r.best.fits
    assert r.best.footprint_bytes == min(c.footprint_bytes
                                         for c in r.candidates)
    roomy = dse.explore(cfg, sh, device="cpu")
    assert roomy.budget_bytes == dse.HBM_BYTES and roomy.best.fits


def test_enumeration_respects_cap():
    capped = FlowConfig(mode="folded", tuning=TuningConfig(max_candidates=7))
    flows = dse.enumerate_candidates(get_smoke("llama3.2-1b"),
                                     ShapeConfig(*SHAPES["train"]), capped)
    assert len(flows) == 7


def test_measure_validator_on_the_cpu():
    """The measured validator times the stage (the wall clock on the CPU)
    and records the estimator's footprint; a candidate that proposes a mesh
    is timed on that mesh (here a one-rank one; four ranks in
    ``tests/test_torch_mesh.py``)."""
    cfg = get_config("lenet5")
    sh = ShapeConfig(*CNN_SERVE)
    rec = dse.measure_validator(cfg, sh, iters=1, device="cpu")(
        FlowConfig(mode="folded"))
    assert rec["measured_step_s"] > 0 and rec["timer"] == "wall_clock"
    assert rec["bytes_source"] == "estimator" and rec["per_device_bytes"] > 0
    rec = dse.measure_validator(cfg, sh, iters=1, device="cpu")(
        FlowConfig(mode="folded", mesh_split=(("data", 1),)))
    assert rec["measured_step_s"] > 0 and rec["timer"] == "wall_clock"


def test_compile_autotune_describe_has_dse_line():
    from repro_torch import flow as tflow
    cm = tflow.compile("lenet5", ShapeConfig(*CNN_SERVE), autotune=True,
                       device="cpu")
    er = cm.explore_result
    assert cm.describe().splitlines()[-1] == (
        f"  dse: best=[{er.best.knob_str()}] enumerated={er.n_enumerated} "
        f"validated={len(er.validated)}")
    # compile(mesh=): the sharding line on the plan, DTensor logits equal
    # to the unsharded ones; a mesh larger than the process group raises
    cm1 = tflow.compile("lenet5", ShapeConfig(*CNN_SERVE), mesh={"data": 1},
                        device="cpu")
    cm0 = tflow.compile("lenet5", ShapeConfig(*CNN_SERVE), device="cpu")
    assert "  sharding: mesh={data:1} dp=data:1" in cm1.describe()
    x = torch.from_numpy(np.random.RandomState(0).randn(
        CNN_SERVE[3], 32, 32, 1).astype(np.float32))
    got, _, _ = cm1.prefill(cm1.init_params(0), {"images": x})
    want, _, _ = cm0.prefill(cm0.init_params(0), {"images": x})
    assert torch.equal(got.to_local(), want)
    with pytest.raises(ValueError, match="process group has 1"):
        tflow.compile("lenet5", ShapeConfig(*CNN_SERVE), mesh={"data": 2},
                      device="cpu")
