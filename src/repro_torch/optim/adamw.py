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
moments, the error buffers and the step count in place: it consumes its
arguments, as the jitted JAX step donates them (a captured CUDA graph of
the step replays those writes).

On a mesh the leaves are DTensors: the moments and the error buffers take
their parameter's placements, each update runs on the rank's local chunks
(elementwise, no collective), the clip's global norm sums every element
once (the local sums all-reduced over the mesh dims a leaf is sharded on),
and the compression's per-tensor scale is the whole tensor's (the local
maxima all-reduced the same way); no gradient is gathered.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


def _like(x, loc):
    """``loc`` as a DTensor with ``x``'s mesh, placements and global shape
    when ``x`` is one (no collective), else ``loc``."""
    if not isinstance(x, DTensor):
        return loc
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


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
            loc = _local(x)
            return _like(x, torch.zeros(loc.shape, dtype=torch.float32,
                                        device=loc.device))

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
        dequantized gradients; ``err`` is overwritten with the new error.
        A DTensor leaf is quantized on the rank's chunk with the whole
        tensor's scale (:func:`~repro_torch.distributed.sharding.global_amax`
        of ``g + e``), and its dequantized gradient is a DTensor with the
        gradient's placements."""
        from repro_torch.distributed.sharding import global_amax
        gf = tree_map(lambda g, e: _like(g, _local(g).float() + _local(e)),
                      grads, err)
        leaves = tree_leaves(gf)
        amax = dict(zip(map(id, leaves), global_amax(leaves)))

        def one(x, e):
            loc = _local(x)
            scale = torch.clamp(amax[id(x)], min=1e-12) / 127.0
            q = torch.clamp(torch.round(loc / scale), -127, 127) \
                .to(torch.int8)
            deq = q.float() * scale
            _local(e).copy_(loc - deq)
            return _like(x, deq)
        return tree_map(one, gf, err), err

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """One step: ``params``, ``state.mu``, ``state.nu`` (and
        ``state.err``) are written in place and returned, ``state.step``
        advanced in place, with ``{"grad_norm", "lr"}`` (0-d tensors, not
        read back).
        The clip's norm is taken of the dequantized gradients when
        compressing, as in the JAX package."""
        from repro_torch.distributed.sharding import global_sq_sum
        out_params = params
        err = state.err
        if self.compress == "int8_ef":
            grads, err = self.compress_grads(grads, err)
        gsq = global_sq_sum(tree_leaves(grads))
        grads, params = tree_map(_local, grads), tree_map(_local, params)
        mu, nu = tree_map(_local, state.mu), tree_map(_local, state.nu)
        gnorm = torch.sqrt(gsq)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0) \
            if self.grad_clip else 1.0
        lr = self.schedule(state.step.float())
        step = state.step.add_(1)
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()

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
