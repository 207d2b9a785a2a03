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
device and read nothing back inside it.

On the card ``prefill``, ``decode``, ``generate_fori``'s decode loop,
``decode_segment`` and ``train_step`` replay captured CUDA graphs
(:mod:`repro_torch.flow.graphs`, the counterpart of the JAX package's
``jax.jit``): each is captured once a key (the batch's shapes, the
addresses of the parameters, of the state and of the optimizer's state)
and replayed with one host launch.  A prefill hands back a fresh state at
every call (a copy of the graph's), a train step writes the parameters
and the moments in place, as the JAX step donates them.  ``with
flow.disable_graphs():`` (the counterpart of ``jax.disable_jit()``) runs
the eager code; so does a CPU model and a model on a mesh.
``flow.clear_graphs()`` (of ``jax.clear_caches()``) drops every graph.

``train_step`` runs the forward products on the same kernels as
``prefill`` and the backward through the reference ops (the hand kernels
have no backward of their own).

``compile(mesh=...)`` binds the model to a ``DeviceMesh`` over the ranks of
the process group (``{"data": 2, "model": 2}``): the ShardingPass records
the partitioning on the plan, the parameters and the serving state are
DTensors (:mod:`repro_torch.distributed.sharding`), ``prefill`` / ``decode``
return DTensor logits and ``generate`` whole tokens on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map_only, tree_unflatten

from repro_torch.configs import SHAPES, get_config, get_smoke
from repro_torch.configs.base import FlowConfig, ModelConfig, ShapeConfig
from repro_torch.core import lowering, ops_impl
from repro_torch.core.plan import ExecutionPlan, _build_plan
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.meshspec import MeshSpec
from repro_torch.distributed.sharding import full_tensor
from repro_torch.flow import graphs
from repro_torch.flow.graphs import clear_graphs, disable_graphs
from repro_torch.obs import TRACER

__all__ = ["compile", "CompiledModel", "disable_graphs", "clear_graphs"]

MEASURED_STAGES = ("train", "prefill", "decode")


class CompiledModel:
    """The product of :func:`compile`: an ExecutionPlan plus the executable
    surface lowered from it, bound to one device.

    The wall-clock of each stage's first call is recorded in
    ``stats["stages"]``."""

    def __init__(self, plan: ExecutionPlan, device: torch.device,
                 explore_result=None, build_s: float = 0.0, mesh=None):
        self.plan = plan
        self.device = device
        self.mesh = mesh                   # DeviceMesh, or None
        self.rules = plan.rules
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
        # the train steps, held by their callers only: a step holds the
        # model, and a model that held its steps would sit in a cycle
        # (with its graphs' pool) until the collector found it
        self._train_steps: "weakref.WeakValueDictionary[Tuple[Any, int], " \
            "Callable]" = weakref.WeakValueDictionary()
        # the captured stages (made at the first capture)
        self._graphs: Optional[graphs.StageGraphs] = None

    @classmethod
    def from_plan(cls, plan: ExecutionPlan, mesh=None,
                  device: DeviceLike = None) -> "CompiledModel":
        """The CompiledModel of ``plan``'s (cfg, shape, flow) on ``mesh``
        (a MeshSpec, an axis-size dict or a live DeviceMesh) and
        ``device``: the plan is built again for that mesh, as the JAX
        package re-jits a plan inside another mesh."""
        return compile(plan.cfg, plan.shape, plan.flow, mesh=mesh,
                       device=device)

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
        """Random weights from ``seed`` (on a mesh DTensors, each rank
        keeping its chunk of the same draw)."""
        return lowering.init_params(self.plan, seed, self.device,
                                    rules=self.rules)

    def param_shapes(self) -> Dict[str, Any]:
        return lowering.param_shapes(self.plan)

    def init_state(self, batch_size: int,
                   abstract: bool = False) -> Dict[str, Any]:
        """Empty serving state (KV caches of ``plan.cache_len`` slots, every
        position -1; a hybrid's conv and RG-LRU states zero) for
        ``batch_size`` rows, on this model's device; with ``abstract``
        fake tensors of the same shapes and placements, nothing
        allocated (the dry-run's)."""
        return lowering.init_state(self.plan, batch_size, self.device,
                                   rules=self.rules, abstract=abstract)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed_first(self, name: str, fn: Callable) -> Any:
        """Run ``fn``; record the wall-clock of the stage's first call (a
        call inside a CUDA-graph capture, which cannot synchronise, is not
        timed)."""
        st = self.stats["stages"]
        if name in st or graphs.capturing(self.device):
            return fn()
        sp = TRACER.timed(f"stage.{name}", cat="stage")
        out = fn()
        self._sync()
        sp.end()
        st[name] = {"first_call_s": round(sp.elapsed_s, 4)}
        return out

    # -- captured stages -----------------------------------------------------
    def _on_graphs(self) -> bool:
        """Whether a stage runs on a captured CUDA graph: on the card,
        without a mesh (or sharding rules), outside :func:`disable_graphs`
        and outside another capture (whose ops it then joins).  A routing
        hook runs in Python, which a replay skips: with one set, a stage on
        the card raises."""
        if self.device.type != "cuda" or self.mesh is not None \
                or self.rules is not None \
                or not graphs.graphs_enabled() \
                or graphs.capturing(self.device):
            return False
        if ops_impl.ROUTING_HOOK is not None:
            raise RuntimeError("a routing hook (ops_impl.ROUTING_HOOK) would "
                               "run at capture only: call the stage under "
                               "flow.disable_graphs()")
        return True

    @property
    def stage_graphs(self) -> graphs.StageGraphs:
        """The captured stages of this model (their ``stats``: graphs
        captured, capture seconds, replays, pool bytes)."""
        if self._graphs is None:
            self._graphs = graphs.StageGraphs(self.device)
        return self._graphs

    def _replay(self, key, inputs, fn, stage: str, generator=None,
                pure: bool = False) -> Any:
        return self.stage_graphs.run(
            (stage,) + key, inputs, fn, generator=generator, pure=pure,
            first=lambda f: self._timed_first(stage, f))

    @staticmethod
    def _batch_key(batch) -> tuple:
        """What a graph bakes in of a batch: its tensors' shapes and
        dtypes, anything else by value."""
        return tuple((k, (tuple(v.shape), v.dtype) if torch.is_tensor(v)
                      else graphs.signature(v))
                     for k, v in sorted(batch.items()))

    @staticmethod
    def _check_in_place(sig: tuple, new_state) -> None:
        """A graph replays the writes into the state tensors it was
        captured on: a stage whose state out is not the state in (``sig``,
        its :func:`graphs.signature`) cannot be replayed."""
        if graphs.signature(new_state) != sig:
            raise RuntimeError("a decode stage replaced a state tensor "
                               "instead of writing it in place")

    def prefill(self, params, batch) -> Any:
        """prefill(params, batch) -> (logits, state, aux).  For an LM the
        logits are those of the last position, (B, 1, vocab), and the
        state is fresh at every call.  On the card one graph a (batch
        shapes and dtypes, parameters) replays the stage; its outputs are
        copied out, so a second prefill leaves the first one's state as it
        was."""
        if not self._on_graphs():
            return self._timed_first(
                "prefill", lambda: self.apply(params, batch, mode="prefill"))
        return self._replay(
            (self._batch_key(batch), graphs.signature(params)),
            {k: v for k, v in batch.items() if torch.is_tensor(v)},
            lambda st: self.apply(params, {**batch, **st}, mode="prefill"),
            "prefill", pure=True)

    def decode(self, params, batch, state, cache_index) -> Any:
        """decode(params, {"tokens": (B, 1)}, state, cache_index) ->
        (logits, state, aux).  Consumes ``state``: the new K/V (and
        recurrent states) are written into its tensors in place and the
        same state comes back (the JAX stage donates its state argument).
        ``cache_index`` is an int or a 0-d integer tensor on the device.
        On the card one graph per (batch shape, parameters, state) replays
        the step, ``cache_index`` read on the device."""
        if not self._on_graphs():
            return self._timed_first(
                "decode", lambda: self.apply(params, batch, state=state,
                                             cache_index=cache_index,
                                             mode="decode"))

        sig = graphs.signature(state)

        def step(st):
            b = {k: st.get(k, v) for k, v in batch.items()}
            lg, new_state, aux = self.apply(params, b, state=state,
                                            cache_index=st["cache_index"],
                                            mode="decode")
            self._check_in_place(sig, new_state)
            return lg, aux
        inputs = {k: v for k, v in batch.items() if torch.is_tensor(v)}
        lg, aux = self._replay(
            (self._batch_key(batch), graphs.signature(params), sig),
            {**inputs, "cache_index": cache_index}, step, "decode")
        return lg, state, aux

    def train_step(self, opt, microbatches: Optional[int] = None) -> Callable:
        """The train step for ``opt``, made once per (``opt``,
        microbatches) for as long as a caller holds it: step(params,
        opt_state, batch) -> (params, opt_state, metrics), updating
        ``params`` and ``opt_state`` in place (the JAX step donates them).
        ``microbatches`` defaults to the flow's.  The first call's
        wall-clock is recorded in ``stats["stages"]``.  The cache is keyed
        on the optimizer's value (a frozen dataclass), not its ``id`` as in
        JAX: an id can be reused by another optimizer once the first is
        gone."""
        mb = microbatches if microbatches is not None \
            else max(self.flow.microbatches, 1)
        key = (opt, mb)
        fn = self._train_steps.get(key)
        if fn is None:
            from repro_torch.train.trainer import make_train_step
            raw = make_train_step(self.plan, opt, microbatches=mb)
            name = f"train_step[mb={mb}]"

            def fn(params, opt_state, batch):
                if not self._on_graphs():
                    return self._timed_first(
                        name, lambda: raw(params, opt_state, batch))
                return params, opt_state, self._replay(
                    (opt, self._batch_key(batch), graphs.signature(params),
                     graphs.signature(opt_state)),
                    {k: v for k, v in batch.items() if torch.is_tensor(v)},
                    lambda st: self._step_in_place(raw, params, opt_state,
                                                   {**batch, **st}), name)
            self._train_steps[key] = fn
        return fn

    @staticmethod
    def _step_in_place(raw: Callable, params, opt_state, batch):
        """The metrics of ``raw``'s step, which must write every parameter
        and optimizer tensor in place (a graph replays those writes)."""
        sig = graphs.signature((params, opt_state))
        p, o, metrics = raw(params, opt_state, batch)
        if graphs.signature((p, o)) != sig:
            raise RuntimeError("a train step replaced a parameter or "
                               "optimizer tensor instead of writing it in "
                               "place")
        return metrics

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
        ``torch.Generator`` on this device seeded from ``seed``.  The
        batch's other inputs (a multimodal model's ``patches``, an
        encoder-decoder's ``frames``) go to the prefill only.  Returns the
        (B, steps) int32 tokens and the final state.  On the card the
        decode steps run on a state the model keeps for the prefill's
        layout (the prefill's copied in, the final state copied out), so
        every call replays the same decode graph."""
        S = batch["tokens"].shape[1]
        gen = None
        if temperature != 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        logits, state, _ = self.prefill(params, batch)
        held = self._on_graphs()
        if held:
            state = self.stage_graphs.held(state)
        tok = self._sample(full_tensor(logits)[:, -1], gen, temperature)
        out = [tok]
        for t in range(steps - 1):
            lg, state, _ = self.decode(params, {"tokens": tok[:, None]},
                                       state, S + t)
            tok = self._sample(full_tensor(lg)[:, -1], gen, temperature)
            out.append(tok)
        if held:
            state = tree_map_only(torch.Tensor, torch.clone, state)
        return torch.stack(out, dim=1), state

    def generate_fori(self, params, batch: Dict[str, Any],
                      steps: int) -> torch.Tensor:
        """Greedy generation with the whole decode loop queued on the
        device: prefill, then ``steps - 1`` decode steps whose tokens stay
        on the device until the caller reads the (B, steps) int32 result
        (the JAX package's one-program ``fori_loop``).  On the card the
        prefill replays its own graph and the decode loop is one captured
        graph a (prompt shape, steps, parameters), which reads each step's
        token and cache index on the device; the prefill's state is copied
        into the graph's own."""
        S = batch["tokens"].shape[1]
        logits, state, _ = self.prefill(params, batch)
        tok0 = torch.argmax(full_tensor(logits)[:, -1], -1).to(torch.int32)
        B = tok0.shape[0]

        def loop(tok0, state, index):
            toks = torch.zeros((B, steps), dtype=torch.int32,
                               device=tok0.device)
            toks[:, 0] = tok0
            for t in range(steps - 1):
                lg, state, _ = self.apply(
                    params, {"tokens": toks[:, t:t + 1]}, state=state,
                    cache_index=index(t), mode="decode")
                toks[:, t + 1] = torch.argmax(full_tensor(lg)[:, -1], -1)
            return toks
        if steps < 2 or not self._on_graphs():
            return loop(tok0, state, lambda t: S + t)
        leaves, spec = tree_flatten(state)

        def run(st):
            index = S + torch.arange(steps - 1, dtype=torch.int32,
                                     device=self.device)
            return loop(st["tok0"], tree_unflatten(
                [st[f"state{i}"] for i in range(len(leaves))], spec),
                lambda t: index[t])
        return self._replay(
            (S, steps, graphs.signature(params),
             tuple((tuple(x.shape), x.dtype) for x in leaves)),
            {"tok0": tok0, **{f"state{i}": x for i, x in enumerate(leaves)}},
            run, "generate_fori")

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
        is written in place.  On the card the ``steps`` ticks are one
        captured graph a (batch, parameters, state, generator), positions
        advanced on the device; a sampled segment registers ``gen`` with
        it, so each replay draws what the host loop would."""
        def ticks(params, state, tok0, pos0, gen):
            B = tok0.shape[0]
            toks = torch.zeros((B, steps), dtype=torch.int32,
                               device=tok0.device)
            cur, pos = tok0, pos0
            sig = graphs.signature(state)
            for t in range(steps):
                lg, new_state, _ = self.apply(
                    params, {"tokens": cur[:, None],
                             "positions": pos[:, None]}, state=state,
                    cache_index=0, mode="decode")
                self._check_in_place(sig, new_state)
                cur = self._sample(full_tensor(lg)[:, -1], gen, temperature)
                toks[:, t] = cur
                pos = pos + 1
            return toks

        def run(params, state, tok0, pos0, gen):
            if not self._on_graphs():
                return ticks(params, state, tok0, pos0, gen), state, gen
            sampled = temperature != 0.0
            toks = self._replay(
                (steps, temperature, tuple(tok0.shape), tok0.dtype,
                 tuple(pos0.shape), pos0.dtype, graphs.signature(params),
                 graphs.signature(state), id(gen) if sampled else None),
                {"tok0": tok0, "pos0": pos0},
                lambda st: ticks(params, state, st["tok0"], st["pos0"], gen),
                "decode_segment", generator=gen if sampled else None)
            return toks, state, gen
        return run

    # -- measured time -------------------------------------------------------
    def _measure_inputs(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Random inputs of the cell's shape from numpy's RandomState:
        images for a CNN; for an LM, tokens ``randint(0, vocab)`` of
        (B, seq_len), or (B, 1) on a decode-kind shape; on a train-kind
        shape also ``labels``, ``randint(0, vocab)`` of (B,) or (B, S),
        drawn after the inputs; for a multimodal model on a prefill- or
        train-kind shape ``patches``, ``randn`` fp32 of (B, n_patch_tokens,
        d_vision), and for an encoder-decoder ``frames``, ``randn`` fp32 of
        (B, encoder_seq, d_model), drawn last (the JAX package's order)."""
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
            if c.n_patch_tokens and self.shape.kind != "decode":
                out["patches"] = rng.randn(
                    B, c.n_patch_tokens, c.d_vision).astype(np.float32)
            if c.n_encoder_layers and self.shape.kind != "decode":
                out["frames"] = rng.randn(
                    B, c.encoder_seq, c.d_model).astype(np.float32)
        return {k: torch.from_numpy(v if v.dtype == np.float32
                                    else v.astype(np.int64)).to(self.device)
                for k, v in out.items()}

    def measure(self, stage: Optional[str] = None, iters: int = 10, *,
                seed: int = 0, params: Optional[Dict[str, Any]] = None,
                trace_dir: Optional[str] = None) -> Dict[str, Any]:
        """Time one stage of this compiled cell: one warm-up call, then
        ``iters`` calls.  ``train`` runs the train step of a default
        ``AdamW()`` on the cell's batch with labels, from ``opt.init``,
        updating ``params`` in place step after step; ``prefill`` runs the
        cell's batch; ``decode`` starts from ``init_state(B)`` with
        ``cache_index`` counting up from 0, one token per row and step.
        ``params`` defaults to ``init_params(seed)``.  On the card each call
        is timed with CUDA events and ``peak_bytes`` is the peak of
        allocated device memory over the timed calls; on a CPU model the
        wall clock times them, and the record says ``cpu``.

        Each timed call runs inside a ``measure.step`` span of the module
        tracer (:data:`repro_torch.obs.TRACER`) and a
        ``torch.profiler.record_function("measure.step")`` of the same
        name.  ``trace_dir`` runs the timed loop (never the warm-up) under
        ``torch.profiler.profile`` (CPU activity, and CUDA on the card) and
        writes its Chrome trace to ``<trace_dir>/measure_<stage>.json``
        (``measure_<stage>.rank<r>.json`` on a mesh of more than one rank;
        the directory is made if missing); the record then also holds the
        file's path under ``trace``.  The times are then taken under the
        profiler, as the JAX package's are under ``jax.profiler.trace``.
        On the card a profile that recorded no device activity raises
        RuntimeError: no trace of the host alone is written in its
        place."""
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
            opt = AdamW()
            opt_state = [opt.init(params)]
            train = self.train_step(opt)

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
        prof = None
        if trace_dir is not None:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else []))
        with prof if prof is not None else contextlib.nullcontext():
            for i in range(max(iters, 1)):
                sp = TRACER.timed("measure.step", cat="measure", stage=stage)
                with torch.profiler.record_function("measure.step"):
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
        if self.rules is not None and self.rules.spec.size > 1:
            # every rank keeps the slowest rank's times, so a search that
            # ranks by them picks the same winner on every rank
            import torch.distributed as dist
            t = torch.tensor(times, dtype=torch.float64, device=self.device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX)
            times = t.tolist()
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
        if prof is not None:
            rec["trace"] = self._write_trace(prof, trace_dir, stage, on_card)
        self.stats.setdefault("measure", {})[stage] = rec
        return rec

    def _write_trace(self, prof, trace_dir: str, stage: str,
                     on_card: bool) -> str:
        """Export ``prof``'s Chrome trace into ``trace_dir``; on the card
        raise if it holds no device activity."""
        if on_card:
            from torch.autograd import DeviceType
            if not any(e.device_type == DeviceType.CUDA
                       for e in prof.events()):
                raise RuntimeError(
                    "torch.profiler recorded no device activity in "
                    f"measure({stage!r}); no trace written")
        name = f"measure_{stage}"
        if self.rules is not None and self.rules.spec.size > 1:
            import torch.distributed as dist
            name += f".rank{dist.get_rank()}"
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, name + ".json")
        prof.export_chrome_trace(path)
        return path

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


def _rules_for(mesh, flow: FlowConfig):
    """The ShardingRules of a live mesh under the flow's axis roles
    (``split_roles``: a tp axis of one rank carries data parallelism, as
    every axis but tp and pp does)."""
    from repro_torch.core.passes.sharding import split_roles
    from repro_torch.distributed.sharding import ShardingRules
    dp, tp, _pp = split_roles(flow, MeshSpec.of(mesh).axes)
    return ShardingRules(mesh, dp=dp or ("data",), tp=tp)


def _resolve_mesh(mesh, device) -> Tuple[Optional[Any], Optional[MeshSpec]]:
    """(live DeviceMesh, MeshSpec) from any accepted mesh spelling: a spec
    or an axis-size dict is built over the process group's ranks, a live
    mesh passes through."""
    if mesh is None:
        return None, None
    spec = MeshSpec.of(mesh)
    if hasattr(mesh, "get_group"):          # already a live DeviceMesh
        return mesh, spec
    return spec.build(device), spec


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
      mesh: the device mesh — a :class:`MeshSpec`, an axis-size dict
        (``{"data": 2, "model": 2}``), or a live ``DeviceMesh``.  The
        factorization is recorded on the flow (``mesh_split``), the
        ShardingPass writes the partitioning decisions onto the plan, and
        the runtime binds them via ShardingRules (``model`` TP, other axes
        DP, ``flow.pp_axis`` PP).  A spec is built over the ranks of the
        process group (a one-rank mesh starts a group of its own; a larger
        one needs :func:`repro_torch.device.init_process_group` first).
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
    mesh_obj, mesh_spec = _resolve_mesh(mesh, dev)
    if mesh_spec is not None and flow.mesh_split != mesh_spec.axes:
        flow = dataclasses.replace(flow, mesh_split=mesh_spec.axes)

    explore_result = None
    sp_build = TRACER.timed("flow.build", cat="compile", arch=cfg.name,
                            autotune=autotune)
    if autotune:
        from repro_torch.core import dse
        n_dev = mesh_spec.size if mesh_spec is not None else 1
        if validate == "measure":
            validator = dse.measure_validator(cfg, shape, mesh=mesh_obj,
                                              device=dev)
        else:
            validator = dse.compile_validator(cfg, shape, device=dev)
        explore_result = dse.explore(
            cfg, shape, flow, devices=n_dev, validator=validator,
            rank_measured=validate == "measure", device=dev)
        flow = explore_result.best.flow
    rules = None
    mesh_axes: Tuple[str, ...] = ()
    if mesh_obj is not None:
        rules = _rules_for(mesh_obj, flow)
        mesh_axes = mesh_spec.names
    if explore_result is not None and mesh_obj is None:
        plan = explore_result.plan          # already built for the best flow
    else:
        plan = _build_plan(cfg, flow, shape, mesh_axes=mesh_axes,
                           rules=rules, platform=dev.type)
    if verify:
        from repro_torch.analysis import PlanVerificationError, verify_plan
        result = verify_plan(plan)
        plan.verification = result
        if not result.ok:                   # gate: no weight for a bad plan
            raise PlanVerificationError(result)
    sp_build.end()
    return CompiledModel(plan, dev, explore_result=explore_result,
                         build_s=sp_build.elapsed_s, mesh=mesh_obj)
