"""AdamW over the port's nested dicts of tensors (the JAX package's
``optim/adamw.py``).

Every quirk of the JAX optimizer is kept, so one step gives the same
numbers: fp32 moments; the global-norm clip over every gradient leaf; the
learning rate taken at ``state.step`` *before* the increment (so the first
step's rate is 0) with bias correction at ``step + 1``; weight decay on
every leaf with ``ndim >= 2``, which includes a folded unit's stacked
``(reps, d)`` norm scales; and the optional int8 gradient compression with
error feedback (round half to even, clip to +-127), the quantization a
compressed all-reduce would introduce, with the error carried forward so the
sequence of updates stays unbiased.

The update runs under ``torch.no_grad()`` and writes the parameters, the
moments and the error buffers in place: it consumes its arguments, as the
jitted JAX step donates them.

On a mesh the leaves are DTensors: the moments take their parameter's
placements, each update runs on the rank's local chunks (elementwise, no
collective), and the clip's global norm sums every element once (the
local sums all-reduced over the mesh dims a leaf is sharded on).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (the same keys in each)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts in the JAX package's order (keys sorted,
    as ``jax.tree.leaves`` orders a dict)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


class AdamWState(NamedTuple):
    step: torch.Tensor             # 0-d int32, on the parameters' device
    mu: Any
    nu: Any
    err: Optional[Any] = None      # error-feedback buffers (compression)


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress: Optional[str] = None           # None | "int8_ef"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1

    def init(self, params) -> AdamWState:
        def zero(x):
            if isinstance(x, DTensor):
                loc = torch.zeros(x._local_tensor.shape, dtype=torch.float32,
                                  device=x._local_tensor.device)
                return DTensor.from_local(loc, x.device_mesh, x.placements,
                                          run_check=False, shape=x.shape,
                                          stride=x.stride())
            return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

        def z(p):
            return tree_map(zero, p)
        dev = _local(tree_leaves(params)[0]).device
        err = z(params) if self.compress else None
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          z(params), z(params), err)

    def schedule(self, step) -> torch.Tensor:
        """Linear warm-up, then a cosine from ``lr`` to ``min_lr_frac *
        lr`` at ``total_steps``; fp32, on ``step``'s device."""
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - self.warmup_steps) /
                        max(self.total_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    @torch.no_grad()
    def compress_grads(self, grads, err):
        """int8 quantize (per-tensor scale) with error feedback: returns the
        dequantized gradients; ``err`` is overwritten with the new error."""
        def one(g, e):
            gf = g.float() + e
            scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
            q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
            deq = q.float() * scale
            e.copy_(gf - deq)
            return deq
        return tree_map(one, grads, err), err

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """One step: ``params``, ``state.mu``, ``state.nu`` (and
        ``state.err``) are written in place and returned, with the new step
        count and ``{"grad_norm", "lr"}`` (0-d tensors, not read back)."""
        out_params = params
        if any(isinstance(g, DTensor) for g in tree_leaves(grads)):
            from repro_torch.distributed.sharding import global_sq_sum
            gsq = global_sq_sum(tree_leaves(grads))
            if self.compress:
                raise NotImplementedError(
                    "int8 gradient compression over DTensor gradients")
            grads, params = tree_map(_local, grads), tree_map(_local, params)
            mu, nu = tree_map(_local, state.mu), tree_map(_local, state.nu)
            err = None
        else:
            grads = tree_map(lambda g: g.float(), grads)
            err = state.err
            if self.compress == "int8_ef":
                grads, err = self.compress_grads(grads, err)
            gsq = sum(torch.sum(torch.square(g)) for g in tree_leaves(grads))
            mu, nu = state.mu, state.nu
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0) \
            if self.grad_clip else 1.0
        step = state.step + 1
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()
        lr = self.schedule(state.step.float())

        def upd(p, g, m, v):
            g = g * scale
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * torch.square(g))
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.weight_decay and p.ndim >= 2:
                delta = delta + self.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))

        tree_map(upd, params, tree_map(lambda g: g.float(), grads), mu, nu)
        return out_params, AdamWState(step, state.mu, state.nu, err), \
            {"grad_norm": gnorm, "lr": lr}
