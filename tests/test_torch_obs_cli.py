"""The trace CLI (``repro_torch.launch.obs``, the port's copy of the JAX
package's ``launch/obs.py``): one trace written by the port's
``Engine(trace=True)`` gives the same ``summarize`` dict through both
packages' ``summarize`` (each reading the file with its own
``load_trace``), and ``main`` prints the phase table."""
import numpy as np

from repro.launch import obs as jobs
from repro.obs.trace import load_trace as jload
from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.launch import obs as tobs
from repro_torch.obs.trace import load_trace as tload
from repro_torch.serving import Engine, EngineConfig, synthetic_requests


def test_summarize_matches_jax_on_a_port_trace(tmp_path, capsys):
    cm = tflow.compile("llama3.2-1b", ShapeConfig("serve", "decode", 64, 2),
                       FlowConfig(mode="folded", precision="fp32"),
                       smoke=True, device="cpu")
    eng = Engine(cm, cm.init_params(0), EngineConfig(
        max_batch=2, max_seq_len=32, block_size=8, trace=True, fori_seg=2))
    eng.run(synthetic_requests(5, 256, prompt_len=12, max_new_tokens=6,
                               seed=1))
    for name in ("t.trace.json", "t.jsonl"):
        path = str(tmp_path / name)
        if name.endswith(".json"):
            eng.tracer.to_chrome(path)
        else:
            eng.tracer.to_jsonl(path)
        got = tobs.summarize(tload(path))
        want = jobs.summarize(jload(path))
        assert got == want
        phases = {p for p, _, _ in got["phases"]}
        assert {"admit", "decode"} <= phases and got["total_us"] > 0
        assert np.isclose(got["coverage"], want["coverage"])
    assert tobs.main(["summarize", path]) == 0
    out = capsys.readouterr().out
    assert "(loop coverage)" in out and "admit" in out
