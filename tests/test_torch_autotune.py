"""The port's serving autotune (repro_torch.serving.autotune) on the CPU:
``autotune_decode(validate="compile")`` deterministic and pinning JAX's
flow, ``validate="measure"`` pinning an engine that serves, the five
engine microbenches' tie-breaks on a fake clock, ``tune_kernel_tiles``
finding no tile to bench, and the launchers (``launch.serve
--serving-autotune``, ``launch.check --all``, ``launch.tune``)."""
import dataclasses
import os
import subprocess
import sys

import pytest

from repro_torch import tunedb
from repro_torch.configs import get_smoke
from repro_torch.core import dse
from repro_torch.serving import autotune
from repro_torch.serving.autotune import ServingProfile, autotune_decode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROF = dict(name="t", batch_buckets=(1, 2), max_seq_len=32,
            block_sizes=(8, 16))


@pytest.fixture(autouse=True)
def _fresh_caches():
    dse.clear_explore_cache()
    tunedb.close_all()
    yield
    dse.clear_explore_cache()
    tunedb.close_all()


def test_compile_autotune_deterministic_and_equal_to_jax():
    from repro.core import dse as jdse
    from repro.serving.autotune import ServingProfile as JProfile
    from repro.serving.autotune import autotune_decode as jautotune
    kw = dict(validate="compile", smoke=True, tune_blocks=False,
              tune_chunks=False, use_cache=False)
    a = autotune_decode("llama3.2-1b", profile=ServingProfile(**PROF),
                        device="cpu", **kw)
    b = autotune_decode("llama3.2-1b", profile=ServingProfile(**PROF),
                        device="cpu", **kw)
    assert a.flow_for(2) == b.flow_for(2)
    assert a.best_bucket == b.best_bucket == 2
    jdse.clear_explore_cache()
    j = jautotune("llama3.2-1b", profile=JProfile(**PROF), **kw)
    # the same flow: the port's budget None is the CPU's 16 GiB, which the
    # JAX package writes out
    tf, jf = dataclasses.asdict(a.flow_for(2)), dataclasses.asdict(
        j.flow_for(2))
    assert tf["tuning"].pop("hbm_bytes") is None
    assert jf["tuning"].pop("hbm_bytes") == dse.budget_bytes(
        a.flow_for(2).tuning, a.device) == dse.HBM_BYTES
    assert tf == jf
    for bucket in PROF["batch_buckets"]:
        assert a.per_bucket[bucket].best.knob_str() == \
            j.per_bucket[bucket].best.knob_str()
    assert a.describe().splitlines()[0] == j.describe().splitlines()[0]


def test_measure_autotune_pins_an_engine_that_serves(tmp_path):
    from repro_torch.serving.scheduler import synthetic_requests
    path = str(tmp_path / "tune.jsonl")
    prof = ServingProfile(name="m", batch_buckets=(2,), max_seq_len=64,
                          block_sizes=(8, 16), chunk_sizes=(1, 2),
                          fori_segs=(0, 4), spec_ks=(0, 2))
    at = autotune_decode("llama3.2-1b", profile=prof, smoke=True,
                         validate="measure", iters=1, db=path, device="cpu")
    assert at.n_measured >= 1 and at.tunedb_statuses == {2: "cold"}
    assert at.block_size in (8, 16) and set(at.block_times_us) == {8, 16}
    assert set(at.chunk_times_us) == {1, 2}
    # a microbench pick above 1 is kept only if the engine replay serves
    # it faster than chunked prefill off
    micro = min(sorted(at.chunk_times_us, reverse=True),
                key=at.chunk_times_us.get)
    if micro == 1:
        assert at.chunk_size == 1 and at.chunk_replay_s == {}
    else:
        r = at.chunk_replay_s
        assert set(r) == {"1", "2"}
        assert at.chunk_size == (2 if r["2"] < r["1"] else 1)
    assert set(at.fori_times_s) == {"0", "4"}
    assert set(at.prefix_times_s) == {"off", "on"}
    assert set(at.spec_times_s) == {"off", "ngram:2"}
    assert at.tile_overrides == () and at.tile_times_s == {}
    desc = at.describe()
    assert desc.startswith("serving-autotune[llama3.2-1b x m]")
    assert "tunedb: b2=cold" in desc and "block_us:" in desc
    eng = at.engine()
    assert eng.compiled.device.type == "cpu"
    rep = eng.run(synthetic_requests(3, at.cfg.vocab_size, prompt_len=8,
                                     max_new_tokens=4))
    assert len(rep.results) == 3
    assert all(len(r.tokens) == 4 for r in rep.results)
    # a warm re-run with the same store measures nothing
    dse.clear_explore_cache()
    again = autotune_decode("llama3.2-1b", profile=prof, smoke=True,
                            validate="measure", iters=1, db=path,
                            device="cpu")
    assert again.tunedb_statuses == {2: "hit"} and again.n_measured == 0
    assert again.flow_for() == at.flow_for()
    assert (again.block_size, again.chunk_size, again.fori_seg,
            again.prefix_cache, again.speculation, again.chunk_replay_s) == \
        (at.block_size, at.chunk_size, at.fori_seg, at.prefix_cache,
         at.speculation, at.chunk_replay_s)


def test_five_tuners_same_winners_on_fake_clock(monkeypatch):
    """Every span costs one tick: ties everywhere, so each tuner's
    documented tie-break decides — stable across repeat runs."""
    from repro_torch.obs.trace import Tracer
    cfg = get_smoke("llama3.2-1b")
    prof = ServingProfile(name="fake", batch_buckets=(2,), max_seq_len=32,
                          block_sizes=(8, 16), chunk_sizes=(1, 2),
                          fori_segs=(0, 4), spec_ks=(0, 2))
    at = autotune_decode(cfg, profile=prof, validate="none",
                         tune_blocks=False, tune_chunks=False,
                         use_cache=False, device="cpu")
    at.block_size = 8
    state = {"t": 0.0}
    monkeypatch.setattr(autotune, "TRACER",
                        Tracer(clock=lambda: state.__setitem__(
                            "t", state["t"] + 0.5) or state["t"]))
    runs = []
    for _ in range(2):
        runs.append({
            "block": autotune.tune_block_size(cfg, prof, iters=2,
                                              device="cpu")[0],
            "chunk": autotune.tune_chunk_size(cfg, prof, iters=2,
                                              device="cpu")[0],
            "fori": autotune.tune_fori_seg(at, iters=1)[0],
            "prefix": autotune.tune_prefix_cache(at, iters=1)[0],
            "spec": autotune.tune_speculation(at, iters=1)[0],
            "chunk_replay": autotune._confirm_chunk(at, 2, iters=1)[0],
        })
    a, b = runs
    assert a == b
    assert a["block"] == 16 and a["chunk"] == 2 and a["fori"] == 4
    assert a["prefix"] is True and a["spec"] == "ngram:2"
    # a tie in the engine replay keeps chunked prefill off
    assert a["chunk_replay"] == 1


def test_kernel_tiles_find_nothing_to_bench(tmp_path):
    """No hand kernel takes a plan tile: ``((), {})`` on every device, and
    the outcome is banked."""
    path = str(tmp_path / "tune.jsonl")
    ov, times = autotune.tune_kernel_tiles(
        get_smoke("llama3.2-1b"), ServingProfile(**PROF), db=path,
        device="cpu")
    assert ov == () and times == {}
    assert tunedb.TuneDB(path).records("serving")


def test_profile_rules_raise_the_jax_messages():
    from repro.serving.autotune import ServingProfile as JProfile
    for bad in (dict(batch_buckets=(4, 1)), dict(block_sizes=(24,)),
                dict(chunk_sizes=()), dict(fori_segs=(1,)),
                dict(spec_ks=(300,)), dict(max_seq_len=0)):
        with pytest.raises(ValueError) as want:
            JProfile(**bad)
        with pytest.raises(ValueError) as got:
            ServingProfile(**bad)
        assert str(got.value) == str(want.value)


def test_autotune_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="Multi-device"):
        autotune_decode("llama3.2-1b", smoke=True, mesh={"data": 2},
                        device="cpu")


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)


def test_launch_check_all_exits_zero():
    out = _run("repro_torch.launch.check", "--all")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "resnet34" in out.stdout and "FAIL" not in out.stdout


def test_launch_tune_shows_an_autotuned_store(tmp_path, capsys):
    from repro_torch.launch import serve, tune
    path = str(tmp_path / "tune.jsonl")
    serve.main(["--smoke", "--device", "cpu", "--requests", "synthetic:2",
                "--max-batch", "2", "--max-seq-len", "32", "--steps", "2",
                "--prompt-len", "8", "--serving-autotune", "--validate",
                "compile", "--tune-db", path])
    out = capsys.readouterr().out
    assert "serving-autotune[llama3.2-1b x cli]" in out
    assert "serving[2 req]" in out
    assert tune.main(["show", "--db", path]) == 0
    shown = capsys.readouterr().out
    assert "dev=cpu:cpu" in shown and "explore" in shown
