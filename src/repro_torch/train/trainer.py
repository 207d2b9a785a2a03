"""Training loop: the train step with microbatched gradient accumulation,
checkpoint/restart, failure injection + automatic recovery (the JAX
package's ``train/trainer.py``).

The step is the loss in train mode (the forward products on the kernels the
plan selects, the backward through the reference ops, with the plan's remat
policy), ``torch.autograd.grad`` for every parameter, then the in-place AdamW
update.  :class:`Trainer` runs it through its compiled model's ``train_step``:
on the card one captured CUDA graph a (batch, parameters, optimizer state)
replays the whole step.  On a mesh (``plan.rules``) the parameters and the
moments are DTensors: the step differentiates the rank's local chunks (the FSDP
gathers, tp splits and the loss's dp sum are explicit collectives with their
backward, :mod:`repro_torch.distributed`), sums each gradient over the dp axes
its parameter is replicated on, and updates the chunks in place, so the loss
and the update are the single-device ones over the global batch.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import lowering
from repro_torch.core.plan import ExecutionPlan
from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt_lib


@dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    async_ckpt: bool = False
    log_every: int = 10
    # fault-tolerance test hooks
    fail_at_step: Optional[int] = None        # inject a failure once
    max_restarts: int = 2


def _grads(loss_fn: Callable, params, batch):
    """(loss, metrics, grads): the gradient of every parameter, zeros for
    one the loss does not reach (BatchNorm's running mean and variance in
    train mode), as ``jax.grad`` gives it."""
    leaves = tree_leaves(params)
    live = {id(p): p.detach().requires_grad_(True) for p in leaves}
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_map(lambda p: live[id(p)], params),
                                batch)
        gs = torch.autograd.grad(loss, [live[id(p)] for p in leaves],
                                 allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, gs)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        tree_map(lambda p: by_id[id(p)], params)


def make_train_step(plan: ExecutionPlan, opt: AdamW, microbatches: int = 1):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` and the optimizer state are updated in place and returned
    (the JAX step donates them).  With ``microbatches`` > 1 the batch's
    leading axis is cut into that many equal slices, their gradients summed
    in fp32 and averaged, and the metrics are ``loss`` (the mean of the
    slices' losses) and the optimizer's; with one, the loss function's
    metrics and the optimizer's.  On a mesh ``params`` and the moments are
    DTensors and ``batch`` the global batch on every rank."""
    loss_fn = lowering.make_loss_fn(plan)
    if plan.rules is not None:
        return _mesh_train_step(plan, opt, microbatches, loss_fn)

    def train_step(params, opt_state: AdamWState, batch):
        if microbatches == 1:
            loss, metrics, grads = _grads(loss_fn, params, batch)
        else:
            def mb_slice(i):
                return {k: x[i * (x.shape[0] // microbatches):
                             (i + 1) * (x.shape[0] // microbatches)]
                        for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = 0.0
            for i in range(microbatches):
                lo, _, g = _grads(loss_fn, params, mb_slice(i))
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
                loss = loss + lo
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {}
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _mesh_train_step(plan: ExecutionPlan, opt: AdamW, microbatches: int,
                     loss_fn: Callable):
    from repro_torch.distributed.sharding import local_of
    rules = plan.rules
    shardings = rules.params_shardings(plan)

    def train_step(params, opt_state: AdamWState, batch):
        local = tree_map(local_of, params)
        n = max(microbatches, 1)
        grads, loss, metrics = None, 0.0, {}
        for i in range(n):
            mb = batch if n == 1 else {
                k: x[i * (x.shape[0] // n):(i + 1) * (x.shape[0] // n)]
                for k, x in batch.items()}
            lo, metrics, g = _grads(loss_fn, local, mb)
            g = rules.reduce_grads(g, shardings)
            grads = tree_map(lambda a: a.float(), g) if grads is None \
                else tree_map(lambda a, b: a.add_(b.float()), grads, g)
            loss = loss + lo
        if n > 1:
            grads = tree_map(lambda g: g / n, grads)
            loss, metrics = loss / n, {}
        grads = tree_map(lambda g, p: rules.wrap(g, p.placements, p.shape),
                         grads, params)
        params, opt_state, om = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


class Trainer:
    """``Trainer(model, opt, tcfg)``: ``model`` is a
    :class:`repro_torch.flow.CompiledModel` (its plan, device and mesh) or
    an :class:`ExecutionPlan` (on the device of the platform it was
    resolved for).  ``mesh`` / ``rules`` train on a mesh (a compiled
    model's own by default): the parameters and moments are DTensors,
    checkpoints hold whole arrays and restore onto the rules' placements.

    The step is the compiled model's ``train_step`` (a model is made for a
    plan, or for another mesh): on the card it replays a captured graph
    keyed on the parameters' and the moments' addresses, so a restore,
    which hands back new tensors, captures a new one."""

    def __init__(self, model, opt: AdamW, tcfg: TrainerConfig, mesh=None,
                 rules=None):
        from repro_torch.flow import CompiledModel, _rules_for
        if isinstance(model, CompiledModel):
            self.plan, self.device = model.plan, model.device
            mesh = mesh if mesh is not None else model.mesh
        else:
            self.plan, self.device = model, torch.device(model.platform)
            model = None
        if rules is None and mesh is not None:
            rules = self.plan.rules if self.plan.rules is not None \
                else _rules_for(mesh, self.plan.flow)
        if rules is not None and self.plan.rules is not rules:
            self.plan = copy.copy(self.plan)
            self.plan.rules = rules
        if model is None or model.plan is not self.plan \
                or model.mesh is not mesh:
            model = CompiledModel(self.plan, self.device, mesh=mesh)
        self.model = model
        self.mesh, self.rules = mesh, rules
        self.opt, self.tcfg = opt, tcfg
        self.step_fn: Optional[Callable] = None
        self._restarts = 0

    # -- setup ----------------------------------------------------------------
    def init(self, seed: int = 0) -> tuple:
        params = lowering.init_params(self.plan, seed, self.device,
                                      rules=self.rules)
        return params, self.opt.init(params)

    def compile_step(self, microbatches: int = 1) -> Callable:
        self.step_fn = self.model.train_step(self.opt, microbatches)
        return self.step_fn

    def _batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- main loop with restart-on-failure -------------------------------------
    def fit(self, data, seed: int = 0):
        """Train ``tcfg.steps`` steps on ``data.get(step)`` from
        ``init(seed)``, or from the latest checkpoint in ``ckpt_dir``.  A
        ``RuntimeError`` in a step (an injected failure, or the step's own:
        a capture that failed, the card out of memory) restores the latest
        checkpoint and goes on, at most ``max_restarts`` times in all; the
        next one raises.  Returns
        (params, opt_state, [(step, loss), ...] every ``log_every``)."""
        tcfg = self.tcfg
        params, opt_state = self.init(seed)
        start = 0
        if tcfg.ckpt_dir:
            last = ckpt_lib.latest_step(tcfg.ckpt_dir)
            if last is not None:
                params, opt_state = self.restore(last, params, opt_state)
                start = last
        if self.step_fn is None:
            self.compile_step(max(self.plan.flow.microbatches, 1))
        history = []
        step = start
        while step < tcfg.steps:
            try:
                batch = self._batch(data.get(step))
                if (tcfg.fail_at_step is not None and step == tcfg.fail_at_step
                        and self._restarts == 0):
                    raise RuntimeError("injected node failure")
                params, opt_state, metrics = self.step_fn(
                    params, opt_state, batch)
                if step % tcfg.log_every == 0:
                    history.append((step, float(metrics["loss"])))
                if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
                    ckpt_lib.save(tcfg.ckpt_dir, step + 1,
                                  {"params": params, "opt": opt_state},
                                  wait=not tcfg.async_ckpt)
                step += 1
            except RuntimeError:
                # a failure: restore from the last checkpoint and continue;
                # every one counts, so that a step that always fails raises
                self._restarts += 1
                if self._restarts > tcfg.max_restarts or not tcfg.ckpt_dir:
                    raise
                last = ckpt_lib.latest_step(tcfg.ckpt_dir)
                if last is None:
                    params, opt_state = self.init(seed)
                    step = 0
                else:
                    params, opt_state = self.restore(last, params, opt_state)
                    step = last
        return params, opt_state, history

    def restore(self, step: int, params_like, opt_like):
        shardings = None
        if self.rules is not None:
            psh = self.rules.params_shardings(self.plan)
            shardings = {"params": psh, "opt": AdamWState(
                None, psh, psh, None if opt_like.err is None else psh)}
        tree = ckpt_lib.restore(self.tcfg.ckpt_dir, step,
                                {"params": params_like, "opt": opt_like},
                                shardings)
        return tree["params"], tree["opt"]
