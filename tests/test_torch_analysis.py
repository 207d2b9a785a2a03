"""The port's static verifier (repro_torch.analysis) held to the JAX
package's: a negative case per diagnostic code (each mutation makes its code
fire exactly once; the port's plans resolve the hand kernels as ``cuda``
where JAX's test forces ``pallas``), the ported configs verifying clean on
the card's plan and the CPU's, the same codes as JAX's verifier on both
packages' plans, the hand kernels' shared bytes (K202's working sets) at the
values their sources state, and the wiring into ``flow.compile(verify=)``,
the DSE and ``launch.check``."""
import copy
import dataclasses
import inspect
import sys
from types import SimpleNamespace

import pytest
import torch

from repro.analysis import verify_plan as jverify_plan
from repro.configs.base import FlowConfig as JFlowConfig
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.plan import _build_plan as _jbuild_plan
from repro_torch import flow as tflow
from repro_torch.analysis import (DIAGNOSTIC_CODES, PlanVerificationError,
                                  verify_engine_config, verify_pipeline,
                                  verify_plan)
from repro_torch.analysis.checkers import (_iter_param_shapes,
                                           static_flow_diagnostics)
from repro_torch.configs import ARCHS, CNNS, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import dse
from repro_torch.core.passes import default_passes
from repro_torch.core.passes.fusion import FusionPass
from repro_torch.core.passmanager import PassManager
from repro_torch.core.plan import _build_plan
from repro_torch.kernels import workingset as ws
from repro_torch.kernels.registry import REGISTRY, KernelContract
from repro_torch.serving.engine import EngineConfig

DECODE = ShapeConfig("an_decode", "decode", 128, 4)
CNN_SHAPE = ShapeConfig("an_cnn", "prefill", 64, 8)
BF, F32 = torch.bfloat16, torch.float32


@pytest.fixture(scope="module")
def lm_plan():
    return _build_plan(get_smoke("llama3.2-1b"), FlowConfig(), DECODE)


@pytest.fixture(scope="module")
def cnn_plan():
    return _build_plan(get_config("lenet5"), FlowConfig(), CNN_SHAPE)


def _mutated(plan, **over):
    p = dataclasses.replace(plan)
    for k, v in over.items():
        setattr(p, k, v)
    return p


def _fires_once(result, code):
    codes = list(result.codes())
    assert codes.count(code) == 1, (code, result.describe())
    return [d for d in result.diagnostics if d.code == code][0]


# ---------------------------------------------------------------------------
# negative cases — cross-pass contracts (X)
# ---------------------------------------------------------------------------

def test_x001_units_must_partition_blocks(lm_plan):
    res = verify_plan(_mutated(lm_plan, units=lm_plan.units[:-1]))
    d = _fires_once(res, "X001")
    assert d.severity == "error" and not res.ok


def test_x002_tile_must_divide_problem_dim(lm_plan):
    tiles = dict(lm_plan.tiles)
    bm, bk, bn = tiles["matmul"]
    tiles["matmul"] = (3, bk, bn)       # decode m = max(1, 8) = 8; 8 % 3 != 0
    _fires_once(verify_plan(_mutated(lm_plan, tiles=tiles)), "X002")


def test_x003_stream_stage_bounds(lm_plan):
    bad = dataclasses.replace(lm_plan.stream, stage_boundaries=(5, 2))
    _fires_once(verify_plan(_mutated(lm_plan, stream=bad)), "X003")


def test_x004_shard_axes_must_divide(lm_plan):
    key, shape = next(iter(_iter_param_shapes(lm_plan)))
    sp = SimpleNamespace(axis_sizes={"data": 7},
                         param_specs={key: (("data",),) +
                                      (None,) * (len(shape) - 1)})
    assert shape[0] % 7 != 0
    _fires_once(verify_plan(_mutated(lm_plan, sharding=sp)), "X004")


def test_x005_unknown_mesh_axis(lm_plan):
    key, _ = next(iter(_iter_param_shapes(lm_plan)))
    sp = SimpleNamespace(axis_sizes={}, param_specs={key: ("ghost",)})
    _fires_once(verify_plan(_mutated(lm_plan, sharding=sp)), "X005")


@pytest.mark.parametrize("kernels", [{"bogus_op": "ref"},
                                     {"matmul": "pallas"}],
                         ids=["unknown_op", "unknown_backend"])
def test_x006_unknown_op_or_backend_in_kernel_table(lm_plan, kernels):
    res = verify_plan(_mutated(lm_plan,
                               kernels={**lm_plan.kernels, **kernels}))
    _fires_once(res, "X006")


def test_x007_invalid_graph(lm_plan):
    class _BadGraph:
        def __init__(self, blocks):
            self.blocks = blocks

        def validate(self):
            raise AssertionError("op reads undefined value %x0")

    res = verify_plan(_mutated(lm_plan, graph=_BadGraph(lm_plan.graph.blocks)))
    _fires_once(res, "X007")


def test_x008_unconsumed_tile_key(lm_plan):
    res = verify_plan(_mutated(lm_plan,
                               tiles={**lm_plan.tiles, "mystery": (8, 8)}))
    _fires_once(res, "X008")


# ---------------------------------------------------------------------------
# negative cases — pipeline ordering (P)
# ---------------------------------------------------------------------------

def test_p101_reader_before_writer():
    _fires_once(verify_pipeline(PassManager([FusionPass()])), "P101")


def test_p102_required_artifact_never_written():
    passes = [p for p in default_passes() if p.name != "tiling"]
    d = _fires_once(verify_pipeline(PassManager(passes)), "P102")
    assert d.op == "tiles"


def test_default_pipeline_orders_clean():
    assert verify_pipeline(PassManager.default_pipeline()).ok


# ---------------------------------------------------------------------------
# negative cases — kernel contracts (K)
# ---------------------------------------------------------------------------

def test_k201_backend_without_impl(lm_plan):
    res = verify_plan(_mutated(lm_plan,
                               kernels={**lm_plan.kernels, "norm": "cuda"}))
    _fires_once(res, "K201")


def test_k202_workingset_exceeds_budget(lm_plan):
    plan = _mutated(
        lm_plan,
        kernels={**lm_plan.kernels, "matmul": "cuda"},
        flow=dataclasses.replace(lm_plan.flow, vmem_budget_bytes=64))
    d = _fires_once(verify_plan(plan), "K202")
    assert "small_m" in d.message or "wgmma" in d.message


def test_k202_holds_the_card_limit_not_the_tpu_budget():
    """The TPU default budget (96 MiB of VMEM) does not loosen the check:
    a block may opt in to 227 KiB of shared memory, and a plan whose kernel
    asks for more trips K202 under the default flow."""
    plan = _build_plan(get_smoke("llama3.2-1b"), FlowConfig(
        kernel_backend="cuda"), DECODE)
    assert FlowConfig().vmem_budget_bytes > ws.BLOCK_SHARED
    assert verify_plan(plan).ok
    big = KernelContract(workingset=lambda plan, ecfg: [
        ("probe", "probe", ws.BLOCK_SHARED + 1)])
    REGISTRY.register("big_probe_op", "cuda", lambda: None, contract=big)
    try:
        res = verify_plan(_mutated(
            plan, kernels={**plan.kernels, "big_probe_op": "cuda"}))
        d = _fires_once(res, "K202")
        assert str(ws.BLOCK_SHARED) in d.message
    finally:
        del REGISTRY._impls[("big_probe_op", "cuda")]


def test_k203_donation_unsafe_kernel(lm_plan):
    REGISTRY.register("unsafe_probe_op", "cuda", lambda: None,
                      contract=KernelContract(donation_safe=False))
    try:
        assert lm_plan.cache.donate_state
        res = verify_plan(_mutated(
            lm_plan,
            kernels={**lm_plan.kernels, "unsafe_probe_op": "cuda"}))
        _fires_once(res, "K203")
    finally:
        del REGISTRY._impls[("unsafe_probe_op", "cuda")]


def _with_attrs(plan, op, **attrs):
    """``plan`` with ``attrs`` set on every micro-op ``op`` of a copied
    graph."""
    graph = copy.deepcopy(plan.graph)
    for block in graph.blocks:
        for mop in block.ops:
            if mop.op == op:
                mop.attrs.update(attrs)
    return _mutated(plan, graph=graph,
                    kernels={**plan.kernels, op: "cuda"})


@pytest.mark.parametrize("case", ["grouped_conv", "cross_attention"])
def test_k204_static_capability_fallback_warns(lm_plan, cnn_plan, case):
    """A conv with groups != 1 (as MobileNetV1's depthwise convs would be
    if they reached conv2d) and a cross-attention op statically reject the
    hand kernel: dispatch takes the reference op, a warning."""
    if case == "grouped_conv":
        plan, want = _with_attrs(cnn_plan, "conv2d", groups=2), "grouped"
    else:
        plan, want = _with_attrs(lm_plan, "attention", cross=True), \
            "cross-attention"
    res = verify_plan(plan)
    d = _fires_once(res, "K204")
    assert d.severity == "warning" and res.ok
    assert want in d.message


def test_k205_pool_smaller_than_one_slot(lm_plan):
    ecfg = EngineConfig(max_seq_len=64, block_size=16, num_blocks=3)
    _fires_once(verify_engine_config(lm_plan, ecfg), "K205")


# ---------------------------------------------------------------------------
# negative cases — serving invariants (S)
# ---------------------------------------------------------------------------

def test_s301_block_must_divide_prompt_buckets(lm_plan):
    ecfg = EngineConfig()
    ecfg.prompt_buckets = (ecfg.block_size + 1, ecfg.max_seq_len)
    _fires_once(verify_engine_config(lm_plan, ecfg), "S301")


def test_s302_chunk_ladder_needs_rung_one(lm_plan):
    ecfg = EngineConfig(chunk_size=4, chunk_buckets=(1, 4))
    ecfg.chunk_buckets = (2, 4)
    _fires_once(verify_engine_config(lm_plan, ecfg), "S302")


def test_s303_fori_seg_one_invalid(lm_plan):
    ecfg = EngineConfig()
    ecfg.fori_seg = 1
    _fires_once(verify_engine_config(lm_plan, ecfg), "S303")


def test_s304_batch_ladder_must_end_at_max_batch(lm_plan):
    ecfg = EngineConfig()
    ecfg.batch_buckets = (ecfg.max_batch + 1,)
    _fires_once(verify_engine_config(lm_plan, ecfg), "S304")


def test_s305_prompt_buckets_exceed_envelope(lm_plan):
    ecfg = EngineConfig()
    ecfg.prompt_buckets = (ecfg.max_seq_len * 2,)
    _fires_once(verify_engine_config(lm_plan, ecfg), "S305")


def test_s306_chunk_size_out_of_range(lm_plan):
    ecfg = EngineConfig(chunk_size=4, chunk_buckets=(1, 4))
    ecfg.chunk_size = ecfg.max_seq_len * 2
    ecfg.chunk_buckets = (1, ecfg.chunk_size)
    _fires_once(verify_engine_config(lm_plan, ecfg), "S306")


def test_s307_speculation_fori_seg_clash(lm_plan):
    ecfg = EngineConfig(speculation="ngram:4")
    ecfg.fori_seg = 4
    _fires_once(verify_engine_config(lm_plan, ecfg), "S307")


# ---------------------------------------------------------------------------
# negative cases — mesh-split divisibility (M, warnings)
# ---------------------------------------------------------------------------

def test_m401_batch_not_divisible_by_dp(lm_plan):
    plan = _mutated(lm_plan, flow=dataclasses.replace(
        lm_plan.flow, mesh_split=(("data", 3),)))
    d = _fires_once(verify_plan(plan), "M401")
    assert d.severity == "warning"


def test_m402_tp_idles_for_cnn(cnn_plan):
    plan = _mutated(cnn_plan, flow=dataclasses.replace(
        cnn_plan.flow, mesh_split=(("model", 2),)))
    _fires_once(verify_plan(plan), "M402")


def test_m403_pp_outside_lm_train(lm_plan):
    plan = _mutated(lm_plan, flow=dataclasses.replace(
        lm_plan.flow, pp_axis="pod", mesh_split=(("pod", 2),)))
    _fires_once(verify_plan(plan), "M403")


# ---------------------------------------------------------------------------
# negative cases — flow-knob screen (F) and the tunedb (T)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over", [
    {"kernel_backend": "bogus"}, {"kernel_backend": "pallas"},
    {"tile_overrides": (("bogus_kernel", (8, 128)),)}],
    ids=["bogus_backend", "tpu_backend", "bogus_tile_key"])
def test_f501_bogus_flow_knob(lm_plan, over):
    diags = static_flow_diagnostics(
        lm_plan.cfg, lm_plan.shape, dataclasses.replace(lm_plan.flow, **over))
    assert [d.code for d in diags] == ["F501"]


def test_t601_stale_tunedb_record_warns_and_remeasures(tmp_path):
    import warnings as _warnings
    from repro_torch import tunedb
    cfg = get_smoke("llama3.2-1b")
    shape = ShapeConfig("t601", "decode", 64, 4)
    flow = FlowConfig(mode="folded")
    db = tunedb.TuneDB(str(tmp_path / "tune.jsonl"))
    cpu = torch.device("cpu")
    key = dse._explore_db_key(cfg, shape, flow, 1, None, None, "compile",
                              dse._platform_key(cpu))
    db.put(tunedb.TuneRecord.make(
        "explore", key,
        {"best_knobs": (("no_such_flow_field", 1),), "validated": []}))
    dse.clear_explore_cache()
    with _warnings.catch_warnings(record=True) as w:
        _warnings.simplefilter("always")
        r = dse.explore(cfg, shape, flow,
                        validator=lambda f: {"per_device_bytes": 1000},
                        use_cache=False, db=db, device="cpu")
    assert any("[T601]" in str(x.message) for x in w)
    assert r.tunedb_status == "cold" and r.n_measured >= 1


def test_every_code_has_a_negative_case():
    src = inspect.getsource(sys.modules[__name__])
    for code in DIAGNOSTIC_CODES:
        assert f'"{code}"' in src or f"_{code.lower()}_" in src, code


def test_codes_match_the_jax_package():
    from repro.analysis import DIAGNOSTIC_CODES as JCODES
    assert list(DIAGNOSTIC_CODES) == list(JCODES)
    for code, meaning in JCODES.items():
        if code != "K202":
            assert DIAGNOSTIC_CODES[code] == meaning, code
    assert "shared memory" in DIAGNOSTIC_CODES["K202"]


# ---------------------------------------------------------------------------
# the hand kernels' shared bytes (K202's working sets)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("got,want", [
    # csrc/flash_attention_ffma.cu static_asserts
    (ws.flash_attention(64, F32), ("ffma", 105472)),
    (ws.flash_attention(128, F32), ("ffma", 204544)),
    (ws.flash_attention(256, F32), ("ffma", 217600)),
    # csrc/flash_attention.cu and csrc/decode_attention.cu comments
    (ws.flash_attention(256, F32)[1] < ws.BLOCK_SHARED, True),
    (ws.decode_attention(32, 10, F32, 8, 1024, 1)[0], "simt"),
    # matmul_wgmma.cu: two blocks an SM of ~97 KB
    (ws.matmul(4096, 2048, 2048, BF, False), ("wgmma", 99376)),
    (ws.matmul(4096, 2048, 8192, BF, True), ("wgmma", 99376)),
    (ws.matmul(8, 2048, 2048, BF, False)[0], "small_m"),
    (ws.matmul(8, 2048, 2048, F32, False)[0], "ffma_small_m"),
    (ws.matmul(8, 84, 10, BF, False)[0], "simt"),
    (ws.conv2d(7, 7, 3, 64, 2, BF)[0], "small_ci"),
    (ws.conv2d(3, 3, 64, 64, 1, BF)[0], "wgmma"),
    (ws.conv2d(1, 1, 32, 64, 1, BF)[0], "mid_ci"),
    (ws.conv2d(3, 3, 128, 128, 1, F32), ("ffma", 73728)),
    (ws.lru_scan(8, 512, 2560, F32)[0], "chunked"),
], ids=lambda x: str(x))
def test_shared_bytes_at_the_sources_values(got, want):
    assert got == want


def test_simt_shared_bytes_at_the_sources_comments():
    """flash_attention.cu: 222,464 bytes at D = 256; decode_attention.cu:
    154,744 at D = 256, G = 10 (computed through the simt formulas)."""
    from repro_torch.kernels import workingset as w
    assert (256 * 68 * 2 + 64 * 256 + 64 * 68) * 4 + 256 == 222464
    assert w.decode_attention(256, 10, F32, 8, 2048, 1)[0] == "ffma"
    # the simt branches at the widths the kernels take them
    s, b = w.flash_attention(32, F32)
    assert s == "simt" and b == (32 * 68 * 2 + 64 * 32 + 64 * 68) * 4 + 256


def test_decode_core_bytes_are_the_wrappers():
    """The core keeps a split's slots of slot map (the rolling cache) or
    the table entries and query positions (the pool), as the wrappers
    hand them to the kernel."""
    from repro_torch.kernels.decode_attention import (_core_smem,
                                                      _paged_tmax, splits)
    for dt in (BF, F32):
        for D in (64, 128, 256):
            chunk = splits(8, 1024, 8, 4, D, dt, ws.H100_SMS)[1]
            assert ws.decode_attention(D, 4, dt, 8, 1024, 8)[1] == \
                _core_smem(dt, D, chunk)
            for sq in (1, 16):
                tmax = _paged_tmax(64, 16, sq)
                assert ws.paged_decode_attention(D, dt, sq, 4, 64, 16)[1] \
                    == _core_smem(dt, D, tmax + sq)


class _FakeLibrary:
    """Stands in for the loaded kernel library: every ``*_smem`` query
    answers 1000 + its argument count and is recorded."""

    def __init__(self, answer=None):
        self.calls, self.answer = [], answer

    def __getattr__(self, name):
        def query(*args):
            self.calls.append((name, args))
            return 1000 + len(args) if self.answer is None else self.answer
        return query


@pytest.mark.parametrize("fn,args,query,qargs", [
    (ws.matmul, (4096, 2048, 2048, BF, False), "matmul_wgmma_smem", (0,)),
    (ws.matmul, (4096, 2048, 8192, BF, True), "matmul_wgmma_smem", (1,)),
    (ws.matmul, (40, 2048, 2048, BF, False), "matmul_small_m_smem", (40, 0)),
    (ws.matmul, (4096, 2048, 2048, F32, True), "matmul_ffma_smem", (1,)),
    (ws.matmul, (8, 2048, 2048, F32, False), "matmul_ffma_small_m_smem",
     (8, 0)),
    (ws.matmul, (8, 84, 10, BF, False), "matmul_simt_smem", (0,)),
    (ws.conv2d, (3, 3, 64, 64, 1, BF), "conv2d_wgmma_smem", (64,)),
    (ws.conv2d, (3, 3, 128, 128, 1, F32), "conv2d_ffma_smem", (128,)),
    (ws.conv2d, (1, 1, 32, 64, 1, BF), "conv2d_mid_ci_smem", (32, 1, 1)),
    (ws.conv2d, (7, 7, 3, 64, 2, F32), "conv2d_small_ci_smem",
     (0, 3, 7, 7, 2)),
    (ws.flash_attention, (128, BF), "flash_attention_wgmma_smem", (128,)),
    (ws.flash_attention, (32, F32), "flash_attention_simt_smem", (32,)),
    (ws.decode_attention, (64, 4, BF, 8, 1024, 8), "decode_core_smem",
     None),
    (ws.decode_attention, (32, 10, F32, 8, 1024, 1),
     "decode_attention_simt_smem", (32, 10)),
    (ws.paged_decode_attention, (64, BF, 16, 4, 64, 16),
     "paged_decode_core_smem", None),
    (ws.paged_decode_attention, (32, F32, 2, 10, 64, 16),
     "paged_decode_attention_simt_smem", (32, 20)),
    (ws.lru_scan, (8, 512, 2560, F32), "lru_scan_smem", None),
], ids=lambda x: x if isinstance(x, str) else None)
def test_workingset_asks_the_library_for_each_schedule(fn, args, query,
                                                       qargs):
    """With ``lib`` each schedule's bytes come from its source's query
    (the one ``chip_smoke.py`` holds the mirror to on the card), at the
    arguments of the call; a query that refuses the shape raises."""
    lib = _FakeLibrary()
    sched, nb = fn(*args, lib=lib)
    assert sched == fn(*args)[0]
    ((name, got),) = lib.calls
    assert name == query and nb == 1000 + len(got)
    if qargs is not None:
        assert got == qargs
    with pytest.raises(ValueError, match="no such shape"):
        fn(*args, lib=_FakeLibrary(answer=-1))


def test_flash_ffma_bytes_read_the_tiles_query():
    class Lib:
        def flash_attention_ffma_tiles(self, D, tiles):
            tiles[4] = 7 * D
            return 0
    assert ws.flash_attention(128, F32, lib=Lib()) == ("ffma", 896)


# ---------------------------------------------------------------------------
# golden sweep — every ported config verifies clean, as in JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_ported_configs_verify_clean(name, device):
    from repro_torch.launch.check import check_config
    summary, diags = check_config(name, device=device)
    assert summary.startswith("ok"), (name, summary, diags)
    assert diags == []


def test_card_plan_resolves_the_hand_kernels():
    """The check's default plan is the card's: ``auto`` resolved to the
    hand kernels without a card, so K202 reads their shared bytes."""
    plan = _build_plan(get_config("llama3.2-1b"),
                       FlowConfig(kernel_backend="cuda"),
                       ShapeConfig("c", "decode", 128, 4), platform="cuda")
    assert plan.kernels["matmul"] == plan.kernels["attention"] == "cuda"
    calls = REGISTRY.get("attention", "cuda").contract.workingset(plan, None)
    assert calls == [("D=64", "wgmma", ws.flash_attention(64, BF)[1])]


@pytest.mark.parametrize("flow", [
    {}, {"mesh_split": (("data", 3),)}, {"mesh_split": (("model", 2),)},
    {"pp_axis": "pod", "mesh_split": (("pod", 2),)}],
    ids=["default", "dp3", "tp2", "pp2"])
@pytest.mark.parametrize("name", ARCHS + CNNS)
def test_same_codes_as_jax_on_smoke_plans(name, flow):
    from repro.configs import get_smoke as jget_smoke
    shape = dict(family_cnn=("c", "prefill", 64, 8),
                 lm=("c", "decode", 128, 4))
    args = shape["family_cnn" if get_smoke(name).family == "cnn" else "lm"]
    jres = jverify_plan(_jbuild_plan(jget_smoke(name), JFlowConfig(**flow),
                                     JShapeConfig(*args)))
    tres = verify_plan(_build_plan(get_smoke(name), FlowConfig(**flow),
                                   ShapeConfig(*args)))
    assert tres.codes() == jres.codes()
    assert tres.summary_line() == jres.summary_line()


def test_compile_verify_records_result():
    cm = tflow.compile("llama3.2-1b", DECODE, smoke=True, verify=True,
                       device="cpu")
    assert cm.plan.verification is not None and cm.plan.verification.ok
    assert "verify: ok" in cm.plan.describe()


def test_compile_verify_gates_before_any_weight(monkeypatch):
    from repro_torch.core import lowering
    made = []
    monkeypatch.setattr(lowering, "init_params",
                        lambda *a, **k: made.append(1))
    flow = FlowConfig(kernel_backend="cuda", vmem_budget_bytes=1)
    with pytest.raises(PlanVerificationError) as ei:
        tflow.compile("llama3.2-1b", DECODE, flow, smoke=True, verify=True,
                      device="cpu")
    assert "K202" in str(ei.value) and not ei.value.result.ok
    assert made == []


def test_unverified_describe_has_no_verify_line(lm_plan):
    assert "verify:" not in lm_plan.describe()


def test_verified_describe_matches_jax():
    from repro import flow as rflow
    j = rflow.compile("lenet5", JShapeConfig("c", "prefill", 64, 8),
                      verify=True)
    t = tflow.compile("lenet5", ShapeConfig("c", "prefill", 64, 8),
                      verify=True, device="cpu")
    jl = [x for x in j.plan.describe().splitlines() if "kernels:" not in x]
    tl = [x for x in t.plan.describe().splitlines() if "kernels:" not in x]
    assert tl == jl and "  verify: ok (9 checks)" in tl


# ---------------------------------------------------------------------------
# DSE static pruning, as in JAX
# ---------------------------------------------------------------------------

def test_dse_static_pruning_skips_compiles_keeps_winner():
    cfg = get_smoke("llama3.2-1b")
    flow0 = FlowConfig(mode="folded")
    calls = []

    def validator(flow):
        calls.append(flow)
        return {"per_device_bytes": 1}

    er = dse.explore(cfg, DECODE, flow0, validator=validator,
                     space={"kernel_backend": ("auto", "bogus")},
                     use_cache=False, device="cpu")
    assert er.n_enumerated == 2 and er.n_static_pruned == 1
    assert "static_pruned=1" in er.describe()
    n_bad = len(calls)
    calls.clear()
    er2 = dse.explore(cfg, DECODE, flow0, validator=validator,
                      space={"kernel_backend": ("auto",)}, use_cache=False,
                      device="cpu")
    assert er2.n_static_pruned == 0
    assert len(calls) == n_bad == 1
    assert er.best.flow == er2.best.flow
    assert er.plan.describe() == er2.plan.describe()


def test_dse_all_candidates_statically_invalid_raises():
    with pytest.raises(ValueError, match="static flow screen"):
        dse.explore(get_smoke("llama3.2-1b"), DECODE,
                    FlowConfig(mode="folded"),
                    space={"kernel_backend": ("bogus",)}, use_cache=False,
                    device="cpu")


# ---------------------------------------------------------------------------
# the check CLI
# ---------------------------------------------------------------------------

def test_launch_check_all_exits_zero(capsys):
    from repro_torch.launch import check
    assert check.main(["--all"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok (9 checks)") == len(ARCHS + CNNS)
    assert check.main(["--all", "--device", "cpu", "--smoke"]) == 0


def test_launch_check_codes_lists_every_code(capsys):
    from repro_torch.launch import check
    assert check.main(["--codes"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == \
        list(DIAGNOSTIC_CODES)


def test_launch_check_fails_on_an_error(capsys):
    from repro_torch.launch import check
    summary, diags = check.check_config(
        "resnet34", flow=FlowConfig(vmem_budget_bytes=1024))
    assert summary.startswith("FAIL") and all("K202" in d for d in diags)
