"""``lowering.init_params`` draws each folded leaf one repetition's slice at a
time and copies each slice into the stacked leaf on the device as it is
drawn, at most two draws a worker thread in flight, so the host never holds
a whole stacked leaf (a full deepseek-moe-16b expert leaf is (27, 64, 2048,
1408): 19.9 GB in fp32).  The draw is deterministic from ``(seed, name)``:
the same with 1, 3 or 8 threads, each slice the one ``_init_one`` draws for
its block, and the configurations ported before keep their values (the
digests below were taken from the draw that stacked whole leaves on the
host)."""
import gc
import hashlib
import weakref

import pytest
import torch

from repro_torch import flow as tflow
from repro_torch.configs.base import FlowConfig, ShapeConfig
from repro_torch.core import lowering

DECODE = ShapeConfig("c", "decode", 32, 2)
# sha256 (first 16 hex digits) of every leaf's bytes in sorted key order,
# smoke configs at seed 0, from the whole-leaf draw
DIGESTS = {
    ("llama3.2-1b", "bf16"): "f9c682a7ec99cc35",
    ("llama3.2-1b", "fp32"): "fb6945c5d729adef",
    ("recurrentgemma-2b", "bf16"): "f1333a54cc801fdf",
    ("recurrentgemma-2b", "fp32"): "6896b65d62c56bfa",
    ("resnet34", "bf16"): "48452e775573c786",
    ("resnet34", "fp32"): "ac0092d30c5b071b",
}


def _digest(params):
    h = hashlib.sha256()
    for k in sorted(params):
        for n in sorted(params[k]):
            t = params[k][n].contiguous()
            h.update(f"{k}/{n}".encode())
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t.view(torch.uint8)).numpy().tobytes())
    return h.hexdigest()[:16]


def _plan(arch, prec):
    shape = ShapeConfig("c", "prefill", 64, 2) if arch == "resnet34" \
        else DECODE
    return tflow.compile(arch, shape, FlowConfig(mode="folded",
                                                 precision=prec),
                         smoke=True, device="cpu").plan


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_ported_configs_keep_their_values(key):
    arch, prec = key
    params = lowering.init_params(_plan(arch, prec), 0, torch.device("cpu"))
    assert _digest(params) == DIGESTS[key]


@pytest.mark.parametrize("prec", ["bf16", "fp32"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x7b"])
def test_sliced_draw_is_deterministic_across_threads(arch, prec):
    plan = _plan(arch, prec)
    cpu = torch.device("cpu")
    runs = [lowering.init_params(plan, 7, cpu, workers=w) for w in (1, 3, 8)]
    assert len({_digest(p) for p in runs}) == 1
    assert _digest(runs[0]) != _digest(lowering.init_params(plan, 8, cpu))
    # each repetition's slice of a folded leaf is its block's own draw
    graph = plan.graph
    for unit in plan.units:
        if not unit.folded:
            continue
        gp = runs[0][lowering.unit_key(graph, unit)]
        for r in range(unit.reps):
            for j in range(unit.period):
                blk = graph.blocks[unit.indices[r * unit.period + j]]
                for spec in graph.blocks[unit.indices[j]].param_specs():
                    want = lowering._init_one(7, blk.name + spec.name, spec,
                                              plan.prec.param_dtype)
                    assert torch.equal(gp[f"{j}:{spec.name}"][r], want)


def test_host_holds_a_bounded_number_of_slices(monkeypatch):
    """With 2 workers at most 4 drawn slices (and the one being drawn) are
    alive on the host at any time; each lands on the device and is
    freed."""
    plan = _plan("deepseek-moe-16b", "fp32")
    alive, peak = weakref.WeakSet(), [0]
    draw = lowering._init_one

    def tracked(*a):
        gc.collect()
        x = draw(*a)
        alive.add(x)
        peak[0] = max(peak[0], len(alive))
        return x
    monkeypatch.setattr(lowering, "_init_one", tracked)
    params = lowering.init_params(plan, 0, torch.device("meta"), workers=2)
    n = sum(1 for unit in plan.units for _ in range(
        unit.reps if unit.folded else 1)
        for j in range(unit.period)
        for _ in plan.graph.blocks[unit.indices[j]].param_specs())
    assert n > 10 and 1 <= peak[0] <= 5
    assert all(t.device.type == "meta" for d in params.values()
               for t in d.values())
