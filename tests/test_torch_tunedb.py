"""The port's persistent autotune database held to the JAX package's: the
cases of ``tests/test_tunedb.py`` on ``repro_torch.tunedb`` and the port's
DSE and serving autotune (on the CPU), and the two packages' JSONL files
read by each other with equal fingerprints, records of the other's code
version never served (T601)."""
import dataclasses
import json
import os
import threading

import pytest
import torch

from repro import tunedb as jtunedb
from repro_torch import tunedb
from repro_torch.configs import get_smoke
from repro_torch.configs.base import FlowConfig, ShapeConfig, TuningConfig
from repro_torch.core import dse

DECODE_B4 = ShapeConfig("db_decode4", "decode", 64, 4)
DECODE_B8 = ShapeConfig("db_decode8", "decode", 64, 8)
CPU = dict(device="cpu")


@pytest.fixture(autouse=True)
def _fresh_caches():
    dse.clear_explore_cache()
    tunedb.close_all()
    yield
    dse.clear_explore_cache()
    dse.set_explore_cache_limit(64)
    tunedb.close_all()


def _validator(calls):
    """Deterministic fake validator: every candidate fits; 'measured' time
    is a stable function of the knobs, so winner selection is exact."""
    def validate(flow):
        calls.append(flow)
        t = 0.001 + (0.0005 if flow.precision == "fp32" else 0.0) \
            + 0.0001 * flow.scan_unroll
        return {"per_device_bytes": 1000, "measured_step_s": t}
    return validate


# ---------------------------------------------------------------------------
# store semantics
# ---------------------------------------------------------------------------

def test_tuple_values_roundtrip_exactly():
    v = {"knobs": (("mesh_split", (("data", 2), ("model", 2))),
                   ("tile", (128, 256))),
         "nested": [1, (2, 3), {"k": (4,)}]}
    assert tunedb.decode_value(json.loads(tunedb.canonical_json(v))) == v


def test_record_roundtrip_and_last_wins(tmp_path):
    path = str(tmp_path / "tune.jsonl")
    db = tunedb.TuneDB(path)
    key = {"cfg": "a", "shape": 4}
    db.record("explore", key, {"best": 1})
    db.record("explore", key, {"best": 2})
    db.record("serving", {"cfg": "b"}, {"best": 3})
    assert len(db) == 2
    re = tunedb.TuneDB(path)
    rec = re.lookup(key)
    assert rec is not None and rec.value == {"best": 2}
    assert [r.kind for r in re.records("serving")] == ["serving"]
    assert re.stats()["by_kind"] == {"explore": 1, "serving": 1}


def test_corrupt_and_truncated_lines_skipped_with_warning(tmp_path):
    path = str(tmp_path / "tune.jsonl")
    db = tunedb.TuneDB(path)
    db.record("explore", {"k": 1}, {"best": 1})
    db.record("explore", {"k": 2}, {"best": 2})
    with open(path, "a", encoding="utf-8") as f:
        f.write("not json at all\n")
        f.write('{"kind": "explore", "fingerprint": "abc", "ke')
    with pytest.warns(UserWarning, match="skipping corrupt record"):
        re = tunedb.TuneDB(path)
    assert len(re) == 2 and re.n_skipped == 2
    assert re.lookup({"k": 2}).value == {"best": 2}


def test_concurrent_writers_never_tear_records(tmp_path):
    path = str(tmp_path / "tune.jsonl")
    n_threads, n_each = 8, 25

    def writer(i):
        db = tunedb.TuneDB(path)
        for j in range(n_each):
            db.record("serving", {"w": i, "j": j},
                      {"best": i * 1000 + j, "pad": "x" * 256})

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    re = tunedb.TuneDB(path)
    assert re.n_skipped == 0 and len(re) == n_threads * n_each
    for i in range(n_threads):
        for j in range(n_each):
            assert re.lookup({"w": i, "j": j}).value["best"] == i * 1000 + j


def test_gc_compacts_and_drops_stale(tmp_path):
    path = str(tmp_path / "tune.jsonl")
    db = tunedb.TuneDB(path)
    for _ in range(3):
        db.record("explore", {"k": 1}, {"best": 1})
    db.put(dataclasses.replace(
        tunedb.TuneRecord.make("explore", {"k": 2}, {"best": 2}),
        code_version="pr0.0"))
    assert sum(1 for _ in open(path)) == 4
    assert db.gc() == {"kept": 1, "dropped_stale": 1}
    assert sum(1 for _ in open(path)) == 1
    assert tunedb.TuneDB(path).lookup({"k": 1}).value == {"best": 1}


def test_stale_code_version_never_served(tmp_path):
    db = tunedb.TuneDB(str(tmp_path / "tune.jsonl"))
    db.put(dataclasses.replace(
        tunedb.TuneRecord.make("explore", {"k": 1}, {"best": 1}),
        code_version="pr0.0"))
    assert db.get(tunedb.fingerprint({"k": 1})) is None
    assert db.get(tunedb.fingerprint({"k": 1}), code_version=None) is not None


# ---------------------------------------------------------------------------
# the two packages' files
# ---------------------------------------------------------------------------

KEYS = [{"cfg": "a", "shape": 4}, {"knobs": (("tile", (128, 256)),)},
        {"nested": [1, (2, 3), {"k": (4,)}], "f": 0.5, "n": None}]


def test_fingerprints_and_lines_equal_jax():
    for key in KEYS:
        assert tunedb.fingerprint(key) == jtunedb.fingerprint(key)
        assert tunedb.canonical_json(key) == jtunedb.canonical_json(key)
    rec = tunedb.TuneRecord(kind="explore", fingerprint="f", key=KEYS[1],
                            value={"best": (1, 2)}, device="cpu:cpu",
                            code_version="v", created_s=1.5)
    jrec = jtunedb.TuneRecord(kind="explore", fingerprint="f", key=KEYS[1],
                              value={"best": (1, 2)}, device="cpu:cpu",
                              code_version="v", created_s=1.5)
    assert rec.to_json() == jrec.to_json()


def test_code_versions_differ():
    assert tunedb.CODE_VERSION != jtunedb.CODE_VERSION
    assert tunedb.SCHEMA_VERSION == jtunedb.SCHEMA_VERSION
    assert tunedb.KINDS == jtunedb.KINDS


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    """A file one package wrote is read whole by the other with the same
    fingerprints; its records are not served under the reader's code
    version (the T601 rule), only with ``code_version=None``."""
    path = str(tmp_path / "tune.jsonl")
    w, r = (jtunedb, tunedb) if writer == "jax" else (tunedb, jtunedb)
    db = w.TuneDB(path)
    for i, key in enumerate(KEYS):
        db.record(("explore", "serving", "kernel")[i], key, {"best": i})
    other = r.TuneDB(path)
    assert other.n_skipped == 0 and len(other) == len(KEYS)
    assert sorted(x.fingerprint for x in other.records()) == \
        sorted(x.fingerprint for x in db.records())
    for i, key in enumerate(KEYS):
        fp = r.fingerprint(key)
        assert other.get(fp) is None                     # stale: not served
        assert other.get(fp, code_version=None).value == {"best": i}
    assert other.stats()["stale"] == len(KEYS)


def test_jax_explore_record_is_not_served_to_the_port(tmp_path):
    """The same search key on the CPU in both packages: a record the JAX
    package banked is stale for the port, which measures afresh."""
    from repro.configs import get_smoke as jget_smoke
    from repro.configs.base import FlowConfig as JFlowConfig
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.core import dse as jdse
    path = str(tmp_path / "tune.jsonl")
    jdse.clear_explore_cache()
    jr = jdse.explore(jget_smoke("llama3.2-1b"),
                      JShapeConfig("db_decode4", "decode", 64, 4),
                      JFlowConfig(mode="folded"),
                      validator=lambda f: {"per_device_bytes": 1000},
                      use_cache=False, db=path)
    assert jr.tunedb_status == "cold"
    jtunedb.close_all()
    db = tunedb.open_db(path)
    (jrec,) = db.records()
    # the JAX package writes its default budget out (16 GiB); the port's
    # flow names the same budget to make the same search
    flow = FlowConfig(mode="folded",
                      tuning=TuningConfig(hbm_bytes=dse.HBM_BYTES))
    key = dse._explore_db_key(get_smoke("llama3.2-1b"), DECODE_B4, flow, 1,
                              None, None, "compile", "cpu:cpu")
    assert tunedb.fingerprint(key) == jrec.fingerprint     # the same search
    assert db.stats()["stale"] == 1
    calls = []
    tr = dse.explore(get_smoke("llama3.2-1b"), DECODE_B4, flow,
                     validator=_validator(calls), use_cache=False, db=db,
                     **CPU)
    assert tr.tunedb_status == "cold" and len(calls) >= 1
    assert db.get(jrec.fingerprint).code_version == tunedb.CODE_VERSION


# ---------------------------------------------------------------------------
# dse.explore: exact hit and cross-config transfer
# ---------------------------------------------------------------------------

def test_explore_exact_hit_measures_nothing(tmp_path):
    cfg = get_smoke("llama3.2-1b")
    calls = []
    kw = dict(validator=_validator(calls), rank_measured=True,
              use_cache=False, db=str(tmp_path / "tune.jsonl"), **CPU)
    cold = dse.explore(cfg, DECODE_B4, **kw)
    assert cold.tunedb_status == "cold" and cold.n_measured > 0
    n_cold = len(calls)
    warm = dse.explore(cfg, DECODE_B4, **kw)
    assert warm.tunedb_status == "hit"
    assert warm.n_measured == 0 and len(calls) == n_cold
    assert warm.best.flow == cold.best.flow
    assert warm.best.knobs == cold.best.knobs
    assert warm.validated == cold.validated


def test_explore_transfer_halves_measurements(tmp_path):
    cfg = get_smoke("llama3.2-1b")
    path = str(tmp_path / "tune.jsonl")
    calls = []
    kw = dict(validator=_validator(calls), rank_measured=True,
              use_cache=False, **CPU)
    baseline = dse.explore(cfg, DECODE_B8, **kw)
    seed = dse.explore(cfg, DECODE_B4, **kw, db=path)
    assert seed.tunedb_status == "cold"
    warm = dse.explore(cfg, DECODE_B8, **kw, db=path)
    assert warm.tunedb_status == "transfer"
    assert 1 <= warm.n_measured <= seed.n_measured // 2
    assert warm.best.flow == baseline.best.flow


def test_explore_writes_back_transfer_results(tmp_path):
    cfg = get_smoke("llama3.2-1b")
    calls = []
    kw = dict(validator=_validator(calls), rank_measured=True,
              use_cache=False, db=str(tmp_path / "tune.jsonl"), **CPU)
    dse.explore(cfg, DECODE_B4, **kw)
    assert dse.explore(cfg, DECODE_B8, **kw).tunedb_status == "transfer"
    again = dse.explore(cfg, DECODE_B8, **kw)
    assert again.tunedb_status == "hit" and again.n_measured == 0


def test_explore_db_defaults_from_flow_tuning(tmp_path):
    cfg = get_smoke("llama3.2-1b")
    path = str(tmp_path / "tune.jsonl")
    flow = FlowConfig(mode="folded")
    flow = dataclasses.replace(
        flow, tuning=dataclasses.replace(flow.tuning, tune_db=path))
    calls = []
    kw = dict(validator=_validator(calls), rank_measured=True,
              use_cache=False, **CPU)
    cold = dse.explore(cfg, DECODE_B4, flow, **kw)
    warm = dse.explore(cfg, DECODE_B4, flow, **kw)
    assert cold.tunedb_status == "cold" and warm.tunedb_status == "hit"
    assert os.path.exists(path)


def test_explore_fingerprint_keys_on_platform(monkeypatch, tmp_path):
    """The process cache and every persisted record key on the device:
    the card's records never serve the CPU, nor the reverse."""
    cfg = get_smoke("llama3.2-1b")
    path = str(tmp_path / "tune.jsonl")
    calls = []
    kw = dict(validator=_validator(calls), rank_measured=True,
              use_cache=True, db=path, **CPU)
    monkeypatch.setattr(dse, "_platform_key", lambda dev: "cpu:host-A")
    r1 = dse.explore(cfg, DECODE_B4, **kw)
    monkeypatch.setattr(dse, "_platform_key",
                        lambda dev: "cuda:NVIDIA H100 80GB HBM3")
    r2 = dse.explore(cfg, DECODE_B4, **kw)
    assert r2 is not r1 and r2.tunedb_status == "cold"
    assert dse.explore_cache_stats()["hits"] == 0
    r3 = dse.explore(cfg, DECODE_B4, **kw)
    assert r3 is r2
    fresh = dse.explore(cfg, DECODE_B4, validator=_validator(calls),
                        rank_measured=True, use_cache=False, db=path, **CPU)
    assert fresh.tunedb_status == "hit"


def test_device_keys():
    assert tunedb.device_key("cpu") == "cpu:cpu"
    if not torch.cuda.is_available():
        assert tunedb.device_key() == "cpu:cpu"
    rec = tunedb.TuneRecord.make("serving", {"k": 1}, {"best": 1},
                                 device="cuda:NVIDIA H100 80GB HBM3")
    assert rec.device.startswith("cuda:")


def test_timed_runs_discard_warmup_compile_time(monkeypatch):
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import autotune
    state = {"t": 0.0, "calls": 0}

    def fn():
        state["t"] += 10.0 if state["calls"] == 0 else 1.0
        state["calls"] += 1

    monkeypatch.setattr(autotune, "TRACER", Tracer(clock=lambda: state["t"]))
    ts = autotune._timed_runs("t", fn, iters=3)
    assert state["calls"] == 4 and ts == [1.0, 1.0, 1.0]


def test_explore_cache_lru_bounded_with_metrics():
    from repro_torch.obs import METRICS
    cfg = get_smoke("llama3.2-1b")
    dse.set_explore_cache_limit(2)
    ev0 = METRICS.counter("dse.cache.evictions").value
    shapes = [ShapeConfig(f"lru{i}", "decode", 64, 2 ** i) for i in range(3)]
    results = [dse.explore(cfg, s, **CPU) for s in shapes]
    assert len(dse._EXPLORE_CACHE) == 2
    stats = dse.explore_cache_stats()
    assert stats["misses"] == 3 and stats["evictions"] == 1
    assert METRICS.counter("dse.cache.evictions").value == ev0 + 1
    assert dse.explore(cfg, shapes[2], **CPU) is results[2]
    assert dse.explore(cfg, shapes[0], **CPU) is not results[0]
    dse.clear_explore_cache()
    assert dse.explore_cache_stats() == {"hits": 0, "misses": 0,
                                         "evictions": 0}


def test_explore_cache_limit_zero_disables():
    cfg = get_smoke("llama3.2-1b")
    dse.set_explore_cache_limit(0)
    r1 = dse.explore(cfg, DECODE_B4, **CPU)
    r2 = dse.explore(cfg, DECODE_B4, **CPU)
    assert r1 is not r2 and len(dse._EXPLORE_CACHE) == 0


# ---------------------------------------------------------------------------
# serving microbench banking
# ---------------------------------------------------------------------------

def test_tune_block_size_served_from_db(monkeypatch, tmp_path):
    from repro_torch.serving import autotune
    cfg = get_smoke("llama3.2-1b")
    prof = autotune.ServingProfile(name="dbt", batch_buckets=(1, 2),
                                   max_seq_len=32, block_sizes=(8, 16))
    path = str(tmp_path / "tune.jsonl")
    b1, t1 = autotune.tune_block_size(cfg, prof, iters=2, db=path, **CPU)

    def boom(*a, **kw):
        raise AssertionError("benched despite a banked record")

    monkeypatch.setattr(autotune, "_timed_runs", boom)
    b2, t2 = autotune.tune_block_size(cfg, prof, iters=2, db=path, **CPU)
    assert (b2, t2) == (b1, t1)
    assert isinstance(b2, int) and all(isinstance(k, int) for k in t2)


def test_tile_overrides_applied_by_tiling_pass():
    from repro_torch.core.passes import tiling
    cfg = get_smoke("llama3.2-1b")
    flow = FlowConfig(mode="folded",
                      tile_overrides=(("attention", (128, 256)),
                                      ("wkv_chunk", 8)))
    tiles = tiling.run(cfg, ShapeConfig("t", "prefill", 256, 2), flow)
    assert tiles["attention"] == (128, 256) and tiles["wkv_chunk"] == 8


def test_no_hand_kernel_declares_tile_candidates():
    """Only the kernels that take a Hopper tile declare candidates to tune
    (flash attention and the conv); no other hand kernel does, matmul
    declares its tile key without candidates, as in JAX."""
    from repro_torch.kernels.registry import REGISTRY
    tuned = set()
    for op in REGISTRY.accelerated_ops():
        c = REGISTRY.get(op, "cuda").contract
        assert c is not None, op
        if c.tile_candidates is not None:
            tuned.add(op)
    assert tuned == {"attention", "conv2d"}


# ---------------------------------------------------------------------------
# the maintenance CLI
# ---------------------------------------------------------------------------

def test_launch_tune_cli_show_gc_export(tmp_path, capsys):
    from repro_torch.launch import tune as cli
    path = str(tmp_path / "tune.jsonl")
    db = tunedb.TuneDB(path)
    db.record("explore", {"k": 1}, {"best": (("tile_select", True),)})
    db.put(dataclasses.replace(
        tunedb.TuneRecord.make("serving", {"k": 2}, {"best": 2}),
        code_version="pr0.0"))
    assert cli.main(["show", "--db", path, "-v"]) == 0
    out = capsys.readouterr().out
    assert "records" in out and "STALE" in out and "explore" in out
    exp = str(tmp_path / "dump.json")
    assert cli.main(["export", "--db", path, "--out", exp]) == 0
    doc = json.load(open(exp))
    assert len(doc["records"]) == 2
    assert doc["code_version"] == tunedb.CODE_VERSION
    assert cli.main(["gc", "--db", path]) == 0
    assert len(tunedb.TuneDB(path)) == 1
