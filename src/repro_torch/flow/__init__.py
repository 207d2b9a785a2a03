"""repro_torch.flow — the public entry point of the compilation flow.

The paper's contract is *frozen model in, compiled inference out*; this
package is that front door for the PyTorch port::

    from repro_torch import flow

    cm = flow.compile("resnet34", ShapeConfig("serve", "prefill", 64, 8))
    params = cm.init_params(seed=0)
    logits, _, _ = cm.prefill(params, {"images": x})   # x: (8, 224, 224, 3)
    print(cm.describe())

``compile()`` runs the pass pipeline for a device (the card unless the
caller asks for the CPU) and returns a :class:`CompiledModel` that owns the
:class:`ExecutionPlan`, ``apply`` / ``prefill``, ``init_params``,
``describe()`` and ``measure()``.  Kernel-backend selection happens behind it
through the :class:`~repro_torch.kernels.registry.KernelRegistry`
(``backend="auto"`` resolves per op: the hand-written CUDA kernel on a
Hopper card, the reference path elsewhere).  Train, decode and generate
arrive with later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core import lowering
from repro_torch.core.plan import ExecutionPlan, _build_plan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TRACER

__all__ = ["compile", "CompiledModel"]


class CompiledModel:
    """The product of :func:`compile`: an ExecutionPlan plus the executable
    surface lowered from it, bound to one device.

    The wall-clock of each stage's first call is recorded in
    ``stats["stages"]``."""

    def __init__(self, plan: ExecutionPlan, device: torch.device,
                 build_s: float = 0.0):
        self.plan = plan
        self.device = device
        self.cfg: ModelConfig = plan.cfg
        self.flow: FlowConfig = plan.flow
        self.shape: ShapeConfig = plan.shape
        self.stats: Dict[str, Any] = {
            "plan_build_s": round(build_s, 4),
            "pass_timings_ms": dict(plan.pass_timings_ms),
            "stages": {},
        }
        self._apply: Optional[Callable] = None

    # -- lowering primitives -------------------------------------------------
    @property
    def apply(self) -> Callable:
        """apply(params, batch, state=None, cache_index=None, mode=...) ->
        (out, new_state, aux) — the lowered program."""
        if self._apply is None:
            self._apply = lowering._make_apply(self.plan)
        return self._apply

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        return lowering.init_params(self.plan, seed, self.device)

    def param_shapes(self) -> Dict[str, Any]:
        return lowering.param_shapes(self.plan)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, params, batch) -> Any:
        """prefill(params, batch) -> (logits, state, aux)."""
        st = self.stats["stages"]
        if "prefill" not in st:
            sp = TRACER.timed("stage.prefill", cat="stage")
            out = self.apply(params, batch, mode="prefill")
            self._sync()
            sp.end()
            st["prefill"] = {"first_call_s": round(sp.elapsed_s, 4)}
            return out
        return self.apply(params, batch, mode="prefill")

    # -- measured time -------------------------------------------------------
    def _measure_inputs(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random images of the cell's shape, from numpy's RandomState."""
        rng = np.random.RandomState(seed)
        c = self.cfg
        x = rng.randn(self.shape.global_batch, c.image_size, c.image_size,
                      c.image_channels).astype(np.float32)
        return {"images": torch.from_numpy(x).to(self.device)}

    def measure(self, stage: Optional[str] = None, iters: int = 10, *,
                seed: int = 0) -> Dict[str, Any]:
        """Time one stage of this compiled cell: one warm-up call, then
        ``iters`` calls.  On the card each call is timed with CUDA events;
        on a CPU model with the wall clock, and the record says ``cpu``."""
        stage = stage if stage is not None else self.shape.kind
        if stage != "prefill":
            raise NotImplementedError(
                f"stage {stage!r} is not ported yet; the CNN slice measures "
                "'prefill'")
        params = self.init_params(seed)
        batch = self._measure_inputs(seed)
        self.prefill(params, batch)                    # warm-up (not timed)
        self._sync()
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        times = []
        for _ in range(max(iters, 1)):
            sp = TRACER.timed("measure.step", cat="measure", stage=stage)
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                self.prefill(params, batch)
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) / 1e3)
            else:
                t = time.perf_counter()
                self.prefill(params, batch)
                times.append(time.perf_counter() - t)
            sp.end()
        B = self.shape.global_batch
        rec = {"stage": stage, "iters": len(times),
               "device": (torch.cuda.get_device_name(self.device)
                          if on_card else "cpu"),
               "timer": "cuda_events" if on_card else "wall_clock",
               "measured_step_s": min(times),
               "mean_step_s": sum(times) / len(times),
               "images_per_s": B / min(times),
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if on_card else None)}
        self.stats.setdefault("measure", {})[stage] = rec
        return rec

    # -- reporting -----------------------------------------------------------
    def describe(self, stats: bool = False) -> str:
        """The flow report: plan summary (passes, units, tiles, kernel
        backends) and, with ``stats``, per-pass and per-stage stats."""
        lines = [self.plan.describe(stats=stats)]
        if stats and self.stats["stages"]:
            parts = [f"{k}={v['first_call_s']}s"
                     for k, v in self.stats["stages"].items()]
            lines.append("  stages: " + " ".join(parts))
        return "\n".join(lines)

    def __repr__(self) -> str:
        return (f"<CompiledModel {self.cfg.name} x {self.shape.name} "
                f"backend={self.flow.kernel_backend} device={self.device}>")


def _resolve_cfg(arch_or_cfg: Union[str, ModelConfig],
                 smoke: bool) -> ModelConfig:
    if isinstance(arch_or_cfg, str):
        return get_smoke(arch_or_cfg) if smoke else get_config(arch_or_cfg)
    return arch_or_cfg


def _resolve_shape(shape: Union[str, ShapeConfig]) -> ShapeConfig:
    if isinstance(shape, str):
        try:
            return SHAPES[shape]
        except KeyError:
            raise KeyError(f"unknown shape {shape!r}; known: "
                           f"{list(SHAPES)}") from None
    return shape


def compile(arch_or_cfg: Union[str, ModelConfig],
            shape: Union[str, ShapeConfig],
            flow: Optional[FlowConfig] = None, *,
            backend: str = "auto",
            smoke: bool = False,
            device: DeviceLike = None) -> CompiledModel:
    """Compile one (model, shape) cell through the whole flow.

    Args:
      arch_or_cfg: registry arch name (``"resnet34"``) or a ModelConfig.
      shape: shape-cell name from ``repro_torch.configs.SHAPES`` or a
        ShapeConfig.
      flow: FlowConfig knobs; defaults to ``FlowConfig(mode="folded")``.
      backend: kernel-backend policy (``auto`` | ``reference`` | ``cuda``).
        A non-``auto`` value overrides the flow's ``kernel_backend``; the
        default keeps the flow's own setting.
      smoke: with a string arch, select the reduced config.
      device: where the model runs; ``None`` means ``"cuda"``, and a CUDA
        request without CUDA raises RuntimeError.  Tests pass ``"cpu"``.
    """
    dev = resolve_device(device)
    cfg = _resolve_cfg(arch_or_cfg, smoke)
    shape = _resolve_shape(shape)
    flow = flow if flow is not None else FlowConfig(mode="folded")
    if backend != "auto" and backend != flow.kernel_backend:
        flow = dataclasses.replace(flow, kernel_backend=backend)
    sp_build = TRACER.timed("flow.build", cat="compile", arch=cfg.name)
    plan = _build_plan(cfg, flow, shape, platform=dev.type)
    sp_build.end()
    return CompiledModel(plan, dev, build_s=sp_build.elapsed_s)
