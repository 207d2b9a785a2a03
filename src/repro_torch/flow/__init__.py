"""repro_torch.flow — the public entry point of the compilation flow.

The paper's contract is *frozen model in, compiled inference out*; this
package is that front door for the PyTorch port::

    from repro_torch import flow

    cm = flow.compile("resnet34", ShapeConfig("serve", "prefill", 64, 8))
    params = cm.init_params(seed=0)
    logits, _, _ = cm.prefill(params, {"images": x})   # x: (8, 224, 224, 3)

    lm = flow.compile("llama3.2-1b", ShapeConfig("serve", "decode", 1024, 8))
    params = lm.init_params(seed=0)
    tokens, state = lm.generate(params, {"tokens": prompt}, steps=32)
    print(lm.describe())

    tm = flow.compile("llama3.2-1b", ShapeConfig("train", "train", 512, 8))
    params = tm.init_params(seed=0)                   # fp32 masters
    opt = AdamW(lr=3e-4)
    step = tm.train_step(opt)
    params, opt_state, metrics = step(params, opt.init(params), batch)

``compile()`` runs the pass pipeline for a device (the card unless the
caller asks for the CPU) and returns a :class:`CompiledModel` that owns the
:class:`ExecutionPlan`, ``apply`` / ``prefill`` / ``decode`` /
``generate``, ``loss_fn`` / ``train_step``, ``init_params`` /
``init_state``, ``describe()`` and ``measure()``.  Kernel-backend
selection happens behind it through the
:class:`~repro_torch.kernels.registry.KernelRegistry` (``backend="auto"``
resolves per op: the hand-written CUDA kernel on a Hopper card, the
reference path elsewhere).  ``generate_fori`` and ``decode_segment`` (the
serving engine's host-free decode segments) queue their whole loop on the
device and read nothing back inside it.  ``train_step`` runs the forward
products on the same kernels as ``prefill`` and the backward through the
reference ops (the hand kernels have no backward of their own).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core import lowering
from repro_torch.core.plan import ExecutionPlan, _build_plan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import TRACER

__all__ = ["compile", "CompiledModel"]

MEASURED_STAGES = ("train", "prefill", "decode")


class CompiledModel:
    """The product of :func:`compile`: an ExecutionPlan plus the executable
    surface lowered from it, bound to one device.

    The wall-clock of each stage's first call is recorded in
    ``stats["stages"]``."""

    def __init__(self, plan: ExecutionPlan, device: torch.device,
                 explore_result=None, build_s: float = 0.0):
        self.plan = plan
        self.device = device
        self.explore_result = explore_result
        self.cfg: ModelConfig = plan.cfg
        self.flow: FlowConfig = plan.flow
        self.shape: ShapeConfig = plan.shape
        self.stats: Dict[str, Any] = {
            "plan_build_s": round(build_s, 4),
            "pass_timings_ms": dict(plan.pass_timings_ms),
            "stages": {},
        }
        self._apply: Optional[Callable] = None
        self._loss_fn: Optional[Callable] = None
        self._train_steps: Dict[Tuple[Any, int], Callable] = {}

    # -- lowering primitives -------------------------------------------------
    @property
    def apply(self) -> Callable:
        """apply(params, batch, state=None, cache_index=None, mode=...) ->
        (out, new_state, aux) — the lowered program."""
        if self._apply is None:
            self._apply = lowering._make_apply(self.plan)
        return self._apply

    @property
    def loss_fn(self) -> Callable:
        """loss_fn(params, batch) -> (loss, metrics): the training loss
        (``lowering.make_loss_fn``), differentiable in ``params``."""
        if self._loss_fn is None:
            self._loss_fn = lowering.make_loss_fn(self.plan)
        return self._loss_fn

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        return lowering.init_params(self.plan, seed, self.device)

    def param_shapes(self) -> Dict[str, Any]:
        return lowering.param_shapes(self.plan)

    def init_state(self, batch_size: int) -> Dict[str, Any]:
        """Empty serving state (KV caches of ``plan.cache_len`` slots, every
        position -1; a hybrid's conv and RG-LRU states zero) for
        ``batch_size`` rows, on this model's device."""
        return lowering.init_state(self.plan, batch_size, self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed_first(self, name: str, fn: Callable) -> Any:
        """Run ``fn``; record the wall-clock of the stage's first call."""
        st = self.stats["stages"]
        if name in st:
            return fn()
        sp = TRACER.timed(f"stage.{name}", cat="stage")
        out = fn()
        self._sync()
        sp.end()
        st[name] = {"first_call_s": round(sp.elapsed_s, 4)}
        return out

    def prefill(self, params, batch) -> Any:
        """prefill(params, batch) -> (logits, state, aux).  For an LM the
        logits are those of the last position, (B, 1, vocab)."""
        return self._timed_first(
            "prefill", lambda: self.apply(params, batch, mode="prefill"))

    def decode(self, params, batch, state, cache_index) -> Any:
        """decode(params, {"tokens": (B, 1)}, state, cache_index) ->
        (logits, state, aux).  Consumes ``state``: the new K/V (and
        recurrent states) are written into its tensors in place and the
        same state comes back (the JAX stage donates its state argument)."""
        return self._timed_first(
            "decode", lambda: self.apply(params, batch, state=state,
                                         cache_index=cache_index,
                                         mode="decode"))

    def train_step(self, opt, microbatches: Optional[int] = None) -> Callable:
        """The train step for ``opt``, made once per (``opt``,
        microbatches): step(params, opt_state, batch) -> (params,
        opt_state, metrics), updating ``params`` and ``opt_state`` in place
        (the JAX step donates them).  ``microbatches`` defaults to the
        flow's.  The first call's wall-clock is recorded in
        ``stats["stages"]``.  The cache is keyed on the optimizer's value
        (a frozen dataclass), not its ``id`` as in JAX: an id can be reused
        by another optimizer once the first is gone."""
        mb = microbatches if microbatches is not None \
            else max(self.flow.microbatches, 1)
        key = (opt, mb)
        fn = self._train_steps.get(key)
        if fn is None:
            from repro_torch.train.trainer import make_train_step
            raw = make_train_step(self.plan, opt, microbatches=mb)
            name = f"train_step[mb={mb}]"

            def fn(params, opt_state, batch):
                return self._timed_first(
                    name, lambda: raw(params, opt_state, batch))
            self._train_steps[key] = fn
        return fn

    # -- generation ----------------------------------------------------------
    @staticmethod
    def _sample(logits: torch.Tensor, gen: Optional[torch.Generator],
                temperature: float) -> torch.Tensor:
        """Greedy ``argmax`` at temperature 0, else one categorical draw a
        row from ``gen``: ``argmax(p / e)`` with ``e ~ Exp(1)``, the draw
        ``torch.multinomial`` makes for one sample, without its host-side
        check of the probabilities (a device-to-host read)."""
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        e = torch.empty_like(probs).exponential_(1.0, generator=gen)
        return torch.argmax(probs / e, dim=-1).to(torch.int32)

    def generate(self, params, batch: Dict[str, Any], steps: int, *,
                 temperature: float = 0.0, seed: int = 0
                 ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill the prompt batch, then decode ``steps`` tokens (a host
        loop).  Greedy by ``argmax`` at ``temperature`` 0 (the first of
        tied maxima, as ``jnp.argmax``); otherwise sampled with a
        ``torch.Generator`` on this device seeded from ``seed``.  Returns
        the (B, steps) int32 tokens and the final state."""
        S = batch["tokens"].shape[1]
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        logits, state, _ = self.prefill(params, batch)
        tok = self._sample(logits[:, -1], gen, temperature)
        out = [tok]
        for t in range(steps - 1):
            lg, state, _ = self.decode(params, {"tokens": tok[:, None]},
                                       state, S + t)
            tok = self._sample(lg[:, -1], gen, temperature)
            out.append(tok)
        return torch.stack(out, dim=1), state

    def generate_fori(self, params, batch: Dict[str, Any],
                      steps: int) -> torch.Tensor:
        """Greedy generation with the whole decode loop queued on the
        device: prefill, then ``steps - 1`` decode steps whose tokens stay
        on the device until the caller reads the (B, steps) int32 result
        (the JAX package's one-program ``fori_loop``)."""
        S = batch["tokens"].shape[1]
        logits, state, _ = self.prefill(params, batch)
        B = logits.shape[0]
        toks = torch.zeros((B, steps), dtype=torch.int32, device=self.device)
        toks[:, 0] = torch.argmax(logits[:, -1], -1)
        for t in range(steps - 1):
            lg, state, _ = self.decode(params, {"tokens": toks[:, t:t + 1]},
                                       state, S + t)
            toks[:, t + 1] = torch.argmax(lg[:, -1], -1)
        return toks

    def decode_segment(self, steps: int, *,
                       temperature: float = 0.0) -> Callable:
        """Host-free multi-tick decode over externally managed state (the
        serving engine's paged KV pool)::

            run(params, state, tok0, pos0, gen) -> (tokens, state, gen)

        ``tok0``/``pos0`` are (B,) int32 device tensors — each row's last
        sampled token and its absolute position; ``tokens`` is (B, steps)
        on the device.  The loop replays the engine's per-tick host loop
        exactly — decode cell, then sample from ``gen`` — so the tokens
        are the ones ``steps`` host ticks give, at any temperature, while
        nothing is read back until the caller reads ``tokens``.  ``state``
        is written in place."""
        def run(params, state, tok0, pos0, gen):
            B = tok0.shape[0]
            toks = torch.zeros((B, steps), dtype=torch.int32,
                               device=tok0.device)
            cur, pos = tok0, pos0
            for t in range(steps):
                lg, state, _ = self.apply(
                    params, {"tokens": cur[:, None],
                             "positions": pos[:, None]}, state=state,
                    cache_index=0, mode="decode")
                cur = self._sample(lg[:, -1], gen, temperature)
                toks[:, t] = cur
                pos = pos + 1
            return toks, state, gen
        return run

    # -- measured time -------------------------------------------------------
    def _measure_inputs(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random inputs of the cell's shape from numpy's RandomState:
        images for a CNN; for an LM, tokens ``randint(0, vocab)`` of
        (B, seq_len), or (B, 1) on a decode-kind shape; on a train-kind
        shape also ``labels``, ``randint(0, vocab)`` of (B,) or (B, S),
        drawn after the inputs (the JAX package's order)."""
        rng = np.random.RandomState(seed)
        c, B = self.cfg, self.shape.global_batch
        train = self.shape.kind == "train"
        if c.family == "cnn":
            x = rng.randn(B, c.image_size, c.image_size,
                          c.image_channels).astype(np.float32)
            out = {"images": x}
            if train:
                out["labels"] = rng.randint(0, c.vocab_size, B)
        else:
            S = self.shape.seq_len if self.shape.kind != "decode" else 1
            out = {"tokens": rng.randint(0, c.vocab_size, (B, S))}
            if train:
                out["labels"] = rng.randint(0, c.vocab_size, (B, S))
        return {k: torch.from_numpy(v if v.dtype == np.float32
                                    else v.astype(np.int64)).to(self.device)
                for k, v in out.items()}

    def measure(self, stage: Optional[str] = None, iters: int = 10, *,
                seed: int = 0, params: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """Time one stage of this compiled cell: one warm-up call, then
        ``iters`` calls.  ``train`` runs the train step of a default
        ``AdamW()`` on the cell's batch with labels, from ``opt.init``,
        updating ``params`` in place step after step; ``prefill`` runs the
        cell's batch; ``decode`` starts from ``init_state(B)`` with
        ``cache_index`` counting up from 0, one token per row and step.
        ``params`` defaults to ``init_params(seed)``.  On the card each call
        is timed with CUDA events and ``peak_bytes`` is the peak of
        allocated device memory over the timed calls; on a CPU model the
        wall clock times them, and the record says ``cpu``."""
        stage = stage if stage is not None else self.shape.kind
        if stage not in MEASURED_STAGES:
            raise NotImplementedError(
                f"stage {stage!r} is not ported yet; the port measures "
                f"{MEASURED_STAGES}")
        lm = self.cfg.family != "cnn"
        if stage == "decode" and not lm:
            raise ValueError("a CNN has no decode stage")
        if stage == "train" and self.shape.kind != "train":
            raise ValueError(f"the train stage needs a train-kind shape "
                             f"(labels), not {self.shape.kind!r}")
        params = params if params is not None else self.init_params(seed)
        batch = self._measure_inputs(seed)
        B = self.shape.global_batch
        if stage == "train":
            from repro_torch.optim.adamw import AdamW
            from repro_torch.train.trainer import make_train_step
            opt = AdamW()
            opt_state = [opt.init(params)]
            train = make_train_step(self.plan, opt,
                                    max(self.flow.microbatches, 1))

            def step(i):
                _, opt_state[0], m = train(params, opt_state[0], batch)
                return m
            per_call = B * (batch["tokens"].shape[1] if lm else 1)
        elif stage == "prefill":
            def step(i):
                return self.prefill(params, batch)
            per_call = B * (batch["tokens"].shape[1] if lm else 1)
        else:
            state = self.init_state(B)
            tok = batch["tokens"][:, :1]

            def step(i):
                return self.decode(params, {"tokens": tok}, state, i)
            per_call = B
        step(0)                                        # warm-up (not timed)
        self._sync()
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        times = []
        for i in range(max(iters, 1)):
            sp = TRACER.timed("measure.step", cat="measure", stage=stage)
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                step(i + 1)
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) / 1e3)
            else:
                t = time.perf_counter()
                step(i + 1)
                times.append(time.perf_counter() - t)
            sp.end()
        rate = per_call / min(times)
        rec = {"stage": stage, "iters": len(times),
               "device": (torch.cuda.get_device_name(self.device)
                          if on_card else "cpu"),
               "timer": "cuda_events" if on_card else "wall_clock",
               "measured_step_s": min(times),
               "mean_step_s": sum(times) / len(times),
               ("tokens_per_s" if lm else "images_per_s"): rate,
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if on_card else None)}
        self.stats.setdefault("measure", {})[stage] = rec
        return rec

    # -- reporting -----------------------------------------------------------
    def describe(self, stats: bool = False) -> str:
        """The flow report: plan summary (passes, units, tiles, kernel
        backends), the DSE outcome when autotuned and, with ``stats``,
        per-pass and per-stage stats."""
        lines = [self.plan.describe(stats=stats)]
        if self.explore_result is not None:
            er = self.explore_result
            lines.append(f"  dse: best=[{er.best.knob_str()}] "
                         f"enumerated={er.n_enumerated} "
                         f"validated={len(er.validated)}")
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
            autotune: bool = False,
            mesh=None,
            validate: str = "compile",
            verify: bool = False,
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
      autotune: run the design-space explorer
        (:func:`repro_torch.core.dse.explore`: estimator-pruned, validated
        on ``device``; results are cached per (cfg, shape, flow, device)
        fingerprint) and compile the winning flow.
      mesh: not ported yet — a mesh raises NotImplementedError (ROADMAP
        Queue 1, "Multi-device").
      validate: with ``autotune``, how the top-k survivors are confirmed:
        ``"compile"`` (build each and record its footprint: a measured step's
        peak of allocated memory on the card, the estimator's on the CPU;
        the estimator's order decides, with no clock) or ``"measure"``
        (time its stage with :meth:`CompiledModel.measure` and rank the
        survivors by the measured step time).
      verify: run the static plan verifier
        (:func:`repro_torch.analysis.verify_plan`) over the built plan
        before any weight is made.  The result is recorded on
        ``plan.verification`` (one ``verify:`` line in ``describe()``); any
        error-severity diagnostic raises
        :class:`~repro_torch.analysis.PlanVerificationError` carrying the
        full diagnostic list.
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
    if validate not in ("compile", "measure"):
        raise ValueError(f"unknown validate mode {validate!r}; "
                         "expected 'compile' | 'measure'")
    if mesh is not None:
        raise NotImplementedError(
            "flow.compile(mesh=) is not ported yet (ROADMAP Queue 1, "
            "\"Multi-device\")")

    explore_result = None
    sp_build = TRACER.timed("flow.build", cat="compile", arch=cfg.name,
                            autotune=autotune)
    if autotune:
        from repro_torch.core import dse
        if validate == "measure":
            validator = dse.measure_validator(cfg, shape, device=dev)
        else:
            validator = dse.compile_validator(cfg, shape, device=dev)
        explore_result = dse.explore(
            cfg, shape, flow, validator=validator,
            rank_measured=validate == "measure", device=dev)
        flow = explore_result.best.flow
        plan = explore_result.plan          # already built for the best flow
    else:
        plan = _build_plan(cfg, flow, shape, platform=dev.type)
    if verify:
        from repro_torch.analysis import PlanVerificationError, verify_plan
        result = verify_plan(plan)
        plan.verification = result
        if not result.ok:                   # gate: no weight for a bad plan
            raise PlanVerificationError(result)
    sp_build.end()
    return CompiledModel(plan, dev, explore_result=explore_result,
                         build_s=sp_build.elapsed_s)
