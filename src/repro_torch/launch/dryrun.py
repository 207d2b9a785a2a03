"""Multi-pod dry-run: run every (arch x shape) cell's step on the production
mesh with fake tensors over a fake process group (nothing allocated, no
card, no weight drawn), and record the per-device memory, the cost and the
collectives the runtime runs.

The PyTorch counterpart of "lower and compile with ``ShapeDtypeStruct``
stand-ins": a ``fake`` process group of 256 (512 with ``--multi-pod``)
ranks in this one process, the production ``DeviceMesh``
(:func:`repro_torch.launch.mesh.make_production_mesh`), the parameters,
the optimizer state, the serving state and the batch as fake tensors on
the plan's device (the card: a fake CUDA tensor needs none), the
parameters and the state as DTensors with the rules' local shapes; then
the cell's step runs once under the ``FakeTensorMode`` — a train cell the
train step with AdamW (forward, backward, update; parameters and optimizer
state donated: written in place), a prefill cell ``apply(mode="prefill")``,
a decode cell ``apply(mode="decode")`` over the abstract state (donated).
Each hand kernel runs as its shape-only stand-in
(:func:`repro_torch.kernels.registry.fake_kernels`), which counts its
operations and bytes.

The record (:func:`run_cell`) has the JAX package's keys: ``memory`` (the
rank's argument, output, temporary and aliased bytes, ``per_device_bytes``
= argument + output + temp - alias, the budget and whether it fits: the
temporaries are the peak ``MemTracker`` sees beyond the step's outputs;
``parameter_bytes`` is the parameters' part of the arguments),
``cost_analysis`` (``flops``: ``FlopCounterMode``'s count of the ops
outside the kernels plus the stand-ins'; ``bytes accessed``: every op's
inputs and outputs plus the stand-ins'; ``flops_by_kernel``;
``flops_by_scan`` / ``bytes_by_scan``: the part of each inside a scan
costed by its trip count, rwkv6-7b's WKV train recurrence, whose body
runs once for all its chunks), the
estimator's ``model_flops`` and ``est_kernel_bytes``, ``compile_s`` (the
fake step's wall time) and, in place of JAX's HLO parse, ``collectives``:
the c10d operations the runtime ran on this rank, counted by op, and
their bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import flow as tflow
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core import dse
from repro_torch.core.lowering import fake_mode
from repro_torch.distributed.sharding import local_of
from repro_torch.kernels import _fake
from repro_torch.kernels.registry import fake_kernels
from repro_torch.launch.mesh import (MULTI_POD_SPEC, PRODUCTION_SPEC,
                                     make_production_mesh)

DEVICE = "cuda"               # the plan's target: the card


def host_device() -> torch.device:
    """Where the fake tensors stand: the card where this torch has CUDA.
    A CPU-only torch cannot run some ops on fake CUDA tensors (advanced
    indexing, ``index_put_``, ``bmm`` ask for its CUDA runtime), so there
    they stand on the CPU: the plan is still built for the card, and the
    shapes, placements and bytes are the same."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def start_fake_group(world_size: int) -> None:
    """The ``fake`` process group of ``world_size`` ranks in this process
    (this process is rank 0; a collective completes at once and moves
    nothing).  A fake group of another size is replaced (its meshes go
    with it); any other group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import meshspec
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise ValueError("the dry-run needs a fake process group, not "
                             f"the {dist.get_backend()} group already up")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
        meshspec._BUILT.clear()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


# ---------------------------------------------------------------------------
# abstract inputs (fake tensors, DTensors where the rules place them)
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    return dse.abstract_inputs(cfg, shape, host_device())


def abstract_params(cm) -> Dict[str, Any]:
    """The parameters as fake DTensors: each leaf this rank's chunk (the
    rules' local shape) on the model's device; no weight is drawn."""
    rules = cm.rules
    shd = rules.params_shardings(cm.plan)
    with fake_mode():
        return {top: {k: rules.wrap(torch.empty(
                    rules.local_shape(m.shape, shd[top][k].placements),
                    dtype=m.dtype, device=cm.device),
                    shd[top][k].placements, m.shape)
                    for k, m in leaves.items()}
                for top, leaves in cm.param_shapes().items()}


def build_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh=None, flow: Optional[FlowConfig] = None):
    """Build (plan, mesh, step, args, donated) for one cell: ``step()``
    runs the cell's program on ``args`` (fake tensors); ``donated`` are
    the indices of the arguments it writes in place."""
    from repro_torch.optim.adamw import AdamW
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device=host_device())
    flow = flow or FlowConfig(mode="folded")
    cm = tflow.compile(cfg, shape, flow, mesh=mesh, device=DEVICE)
    cm.device = host_device()         # the fake tensors' device
    params = abstract_params(cm)
    batch = input_specs(cfg, shape)
    B = shape.global_batch
    if shape.kind == "train":
        opt = AdamW()
        with fake_mode():
            ostate = opt.init(params)
        step = cm.train_step(opt, microbatches=max(flow.microbatches, 1))
        args = (params, ostate, batch)
        return cm.plan, mesh, lambda: step(*args), args, (0, 1)
    apply = cm.apply
    if shape.kind == "prefill":
        args = (params, batch)
        return cm.plan, mesh, lambda: apply(params, batch,
                                            mode="prefill")[:2], args, ()
    state = cm.init_state(B, abstract=True)
    args = (params, batch, state)
    return cm.plan, mesh, lambda: apply(
        params, batch, state=state, cache_index=shape.seq_len - 1,
        mode="decode")[:2], args, (2,)


# ---------------------------------------------------------------------------
# the accounts: bytes of every op, the collectives
# ---------------------------------------------------------------------------

def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [local_of(tree)] if torch.is_tensor(tree) else []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Account(TorchDispatchMode):
    """Bytes read and written by every op outside the kernels (inputs and
    outputs; views and the ``prim`` metadata queries a fake tensor
    answers, such as ``prim.device``, move nothing), and the c10d
    collectives: count and bytes by op (an all-gather's gathered outputs,
    an all-reduce's tensor).  Inside a scan (``_fake.scan``) an op counts
    its trips."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        n = _fake.trips()
        if func.namespace == "c10d":
            moved = _nbytes(_leaves(args[0])) if args else 0
            c = self.collectives.setdefault(name.split(".")[-1],
                                            {"count": 0, "bytes": 0})
            c["count"] += n
            c["bytes"] += n * moved
        elif not func.is_view and func.namespace != "prim":
            moved = n * (_nbytes(_leaves((args, kwargs)))
                         + _nbytes(_leaves(out)))
            self.bytes += moved
            _fake.tally(0, moved)
        return out


class _Flops(FlopCounterMode):
    """``FlopCounterMode`` whose count of an op inside a scan
    (``_fake.scan``) is taken by its trips."""

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            n = _fake.trips() * self.flop_registry[func_packet](
                *args, **kwargs, out_val=out)
            for par in set(self.mod_tracker.parents):
                self.flop_counts[par][func_packet] += n
            _fake.tally(n, 0)
        return out


def _storages(ts) -> set:
    return {t.untyped_storage()._cdata for t in ts}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, flow: Optional[FlowConfig] = None) -> Dict[str, Any]:
    """One cell's record (the module docstring lists its keys).  ``mesh``
    is a live DeviceMesh of the fake group, a MeshSpec or axis-size dict,
    or a tuple of sizes (``(2, 4)``: data 2, model 4; three sizes lead
    with a pod axis); None is the production mesh.  The fake group is
    started (or resized) for it."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.core.estimator import hbm_bytes_kernel_path, model_flops
    from repro_torch.distributed.meshspec import MeshSpec
    if mesh is None:
        spec = MULTI_POD_SPEC if multi_pod else PRODUCTION_SPEC
    elif isinstance(mesh, tuple) and all(isinstance(n, int) for n in mesh):
        names = ("pod", "data", "model")[-len(mesh):]
        spec = MeshSpec(tuple(zip(names, mesh)))
    else:
        spec = MeshSpec.of(mesh)
    multi_pod = "pod" in spec.names
    start_fake_group(spec.size)
    if not hasattr(mesh, "get_group"):
        # the mesh is made of real tensors: built before the fake mode
        mesh = spec.build(host_device())
    t0 = time.time()
    with fake_kernels() as kcost, fake_mode():
        plan, mesh, step, args, donate = build_cell(
            arch, shape_name, multi_pod=multi_pod, mesh=mesh, flow=flow)
        rules = plan.rules
        batch = args[2] if plan.shape.kind == "train" else args[1]
        # the batch arrives split over dp: the rank's rows are its argument
        batch_local = [rules.local_batch(x) for x in _leaves(batch)]
        param_bytes = _nbytes(_leaves(args[0]))
        arg_bytes = _nbytes(_leaves([a for a in args if a is not batch])) \
            + _nbytes(batch_local)
        donated = _storages(_leaves([args[i] for i in donate]))
        t1 = time.time()
        acct, flops = _Account(), _Flops(display=False)
        mt = MemTracker()
        with mt, flops, acct:
            out = step()
        t2 = time.time()
    out_ts = _leaves(out)
    out_bytes = _nbytes(out_ts)
    alias_bytes = _nbytes([t for t in out_ts
                           if t.untyped_storage()._cdata in donated])
    peak = max((v.get("Total", 0) for v in
                mt.get_tracker_snapshot("peak").values()), default=0)
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": max(peak - (out_bytes - alias_bytes), 0),
           "alias_bytes": alias_bytes}
    per_dev = dse.per_device_bytes(mem)
    budget = dse.budget_bytes(plan.flow.tuning, torch.device(DEVICE))
    mem.update(per_device_bytes=per_dev, budget_bytes=budget,
               fits_budget=bool(per_dev < budget),
               parameter_bytes=param_bytes)
    kflops = sum(c["flops"] for c in kcost.values())
    kbytes = sum(c["bytes"] for c in kcost.values())
    cfg, shape = get_config(arch), SHAPES[shape_name]
    return {
        "arch": arch, "shape": shape_name,
        "mesh": list(mesh.shape), "multi_pod": multi_pod,
        "mode": plan.stream.mode,
        "folds": [[u.reps, u.period] for u in plan.units if u.folded],
        "pass_stats": plan.pass_stats,
        "pass_timings_ms": plan.pass_timings_ms,
        "lower_s": round(t1 - t0, 2),
        "compile_s": round(t2 - t1, 2),
        "memory": mem,
        "cost_analysis": {
            "flops": float(flops.get_total_flops() + kflops),
            "bytes accessed": float(acct.bytes + kbytes),
            "flops_by_kernel": {k: c["flops"] for k, c in kcost.items()},
            "calls_by_kernel": {k: c["calls"] for k, c in kcost.items()},
            "flops_by_scan": {k: c["flops"]
                              for k, c in _fake.SCAN_COST.items()},
            "bytes_by_scan": {k: c["bytes"]
                              for k, c in _fake.SCAN_COST.items()}},
        "collectives": {
            "collective_bytes": sum(c["bytes"]
                                    for c in acct.collectives.values()),
            "by_op": acct.collectives},
        "model_flops": model_flops(cfg, shape),
        "est_kernel_bytes": hbm_bytes_kernel_path(cfg, shape),
    }


def _validator(a: str, s: str, mesh, records: Dict[Any, Any]):
    def validate(flow: FlowConfig) -> Dict[str, Any]:
        records[flow] = run_cell(a, s, mesh=mesh, flow=flow)
        return records[flow]["memory"]
    return validate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--flow-mode", default="folded")
    ap.add_argument("--autotune", action="store_true",
                    help="DSE: pick train-cell microbatch counts so the "
                         "per-device footprint fits the budget")
    ap.add_argument("--explore", action="store_true",
                    help="full DSE: estimator-pruned candidate sweep with "
                         "the dry-run validating the top-k")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="per-device budget in GiB (default: the h100 "
                         "preset's 80 GB)")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for a, s, runnable in cells(include_skipped=True):
            for mp in meshes:
                todo.append((a, s, runnable, mp))
    else:
        todo = [(args.arch, args.shape, True, args.multi_pod)]
    results = []
    for a, s, runnable, mp in todo:
        if not runnable:
            results.append({"arch": a, "shape": s, "multi_pod": mp,
                            "skipped": "full-attention arch: long-context "
                            "decode inapplicable"})
            print(f"SKIP {a} x {s}")
            continue
        try:
            # a mesh's own fake group (256 or 512 ranks), then the mesh
            start_fake_group((MULTI_POD_SPEC if mp
                              else PRODUCTION_SPEC).size)
            mesh = make_production_mesh(multi_pod=mp, device=host_device())
            base_flow = FlowConfig(mode=args.flow_mode)
            if args.hbm_gib is not None:
                base_flow = dataclasses.replace(
                    base_flow, tuning=dataclasses.replace(
                        base_flow.tuning,
                        hbm_bytes=int(args.hbm_gib * 2 ** 30)))
            if args.explore:
                records: Dict[Any, Any] = {}
                from repro_torch.distributed.meshspec import MeshSpec
                with fake_kernels():
                    er = dse.explore(get_config(a), SHAPES[s], base_flow,
                                     devices=MeshSpec.of(mesh).size,
                                     mesh=mesh, device=DEVICE,
                                     validator=_validator(a, s, mesh,
                                                          records))
                print(er.describe())
                r = records.get(er.best.flow) or run_cell(
                    a, s, mesh=mesh, flow=er.best.flow)
                r["dse"] = {"knobs": er.best.knob_str(),
                            "n_enumerated": er.n_enumerated,
                            "validated": len(er.validated),
                            "budget_bytes": er.budget_bytes}
            elif args.autotune and SHAPES[s].kind == "train":
                _, r = dse.autotune_train_cell(a, s, mesh, base_flow)
            else:
                r = run_cell(a, s, mesh=mesh, flow=base_flow)
            gb = r["memory"]["per_device_bytes"] / 2 ** 30
            budget_gb = r["memory"]["budget_bytes"] / 2 ** 30
            fit = "" if r["memory"]["fits_budget"] else " OVER-BUDGET"
            print(f"OK   {a} x {s} pods={1 + mp} compile={r['compile_s']}s "
                  f"mem/dev={gb:.2f}GiB (budget {budget_gb:.2f}GiB{fit}) "
                  f"flops={r['cost_analysis'].get('flops', 0):.3g} "
                  f"collective_bytes="
                  f"{r['collectives']['collective_bytes']:.3g}", flush=True)
        except Exception as e:  # noqa: BLE001 — a failing cell is a report
            r = {"arch": a, "shape": s, "multi_pod": mp,
                 "error": f"{type(e).__name__}: {e}"}
            print(f"FAIL {a} x {s} pods={1 + mp}: {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
        results.append(r)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
