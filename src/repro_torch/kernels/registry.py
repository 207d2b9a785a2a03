"""KernelRegistry — pluggable per-op kernel-backend selection.

The paper's flow emits one accelerator per network; end-to-end compilers that
followed it put a *registry* between the op layer and the kernel
implementations: each op may have several implementations, keyed by backend,
each guarded by a capability predicate, and the flow resolves the pair at
plan-build time.

This module is that seam for the port:

* implementations register under ``(op, backend)`` with backends drawn from
  ``{"ref", "cuda"}``;
* every op in :data:`repro_torch.core.ops_impl.OPS` implicitly owns a ``ref``
  entry (the plain-PyTorch op *is* the reference backend);
* ``resolve(op, "auto", platform)`` picks per op: the hand-written CUDA
  kernel where one exists, the platform is ``cuda`` and the card is a Hopper
  (:func:`repro_torch.device.hopper_ok`), the reference path elsewhere.  The
  platform is the compiled model's device, handed down by
  :func:`repro_torch.flow.compile`;
* the resolution for a whole plan (:meth:`KernelRegistry.resolve_all`) is
  recorded on the ``ExecutionPlan`` by the ``kernels`` pass and shows up in
  ``plan.describe()``.

Call-site capability predicates (facts only known with concrete operands)
are checked at dispatch time by :func:`plan_kernel`; a failing predicate
takes the reference path with a machine-readable reason
(``DISPATCH_REJECTIONS`` counts them, as does the
``kernels.dispatch.rejections`` metric).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

from repro_torch.obs import METRICS

_ALIASES = {"reference": "ref", "ref": "ref", "cuda": "cuda", "auto": "auto"}


def canon_backend(name: str) -> str:
    """Canonical backend name (``reference`` → ``ref``)."""
    try:
        return _ALIASES[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel backend {name!r}; expected one of "
            f"{sorted(set(_ALIASES))}") from None


@dataclass(frozen=True)
class KernelImpl:
    """One registered kernel implementation.

    ``rejects`` is the call-site capability predicate: it receives the
    keyword facts the op layer passes to :func:`plan_kernel` and returns
    ``None`` (accepted) or a reason string.  (The static ``KernelContract``
    of the JAX registry joins with the plan verifier, ROADMAP Queue 1,
    "Static verifier".)"""
    op: str
    backend: str
    fn: Callable
    rejects: Optional[Callable[..., Optional[str]]] = None

    def reject_reason(self, **facts) -> Optional[str]:
        """``None`` when this impl can serve the call-site facts, else the
        machine-readable reason dispatch takes the reference path."""
        return self.rejects(**facts) if self.rejects is not None else None

    def __repr__(self) -> str:
        return f"<KernelImpl {self.op}/{self.backend}>"


class KernelRegistry:
    """Maps ``(op, backend)`` → :class:`KernelImpl` and resolves backends."""

    def __init__(self):
        self._impls: Dict[Tuple[str, str], KernelImpl] = {}

    # -- registration -------------------------------------------------------
    def register(self, op: str, backend: str, fn: Callable, *,
                 rejects: Optional[Callable[..., Optional[str]]] = None
                 ) -> Callable:
        """Register ``fn`` as the ``backend`` implementation of ``op``."""
        backend = canon_backend(backend)
        if backend == "auto":
            raise ValueError("'auto' is a resolution policy, not a backend")
        self._impls[(op, backend)] = KernelImpl(op, backend, fn,
                                                rejects=rejects)
        return fn

    # -- lookup -------------------------------------------------------------
    def _ref_ops(self) -> Dict[str, Callable]:
        from repro_torch.core.ops_impl import OPS
        return OPS

    def ops(self) -> Tuple[str, ...]:
        """All ops the registry can resolve (reference table ∪ registered)."""
        names = set(self._ref_ops()) | {op for op, _ in self._impls}
        return tuple(sorted(names))

    def accelerated_ops(self) -> Tuple[str, ...]:
        """Ops with at least one non-reference implementation."""
        return tuple(sorted({op for (op, b) in self._impls if b != "ref"}))

    def get(self, op: str, backend: str) -> KernelImpl:
        """The registered (non-reference) implementation of ``op``."""
        impl = self._impls.get((op, canon_backend(backend)))
        if impl is None:
            raise KeyError(f"no {backend!r} implementation registered for "
                           f"op {op!r}")
        return impl

    # -- resolution ---------------------------------------------------------
    def resolve(self, op: str, backend: str, platform: str) -> str:
        """Plan-time backend choice for one op on ``platform``
        (``"cpu"`` | ``"cuda"``).

        ``auto`` → the CUDA kernel where one exists, the platform is
        ``cuda`` and the card is a Hopper; reference elsewhere.  An explicit
        ``cuda`` request degrades to ``ref`` for ops with no CUDA kernel; on
        a CPU model it reaches the kernel wrappers, which run their plain
        versions on CPU tensors."""
        from repro_torch.device import hopper_ok
        backend = canon_backend(backend)
        has_cuda = (op, "cuda") in self._impls
        if backend == "auto":
            if has_cuda and platform == "cuda" and hopper_ok():
                return "cuda"
            return "ref"
        if backend == "cuda":
            return "cuda" if has_cuda else "ref"
        return "ref"

    def resolve_all(self, backend: str, platform: str) -> Dict[str, str]:
        """Resolution table for every known op (recorded on the plan)."""
        return {op: self.resolve(op, backend, platform) for op in self.ops()}


REGISTRY = KernelRegistry()

# dispatch-time fall-throughs to ref, keyed by (op, machine-readable reason).
DISPATCH_REJECTIONS: Dict[Tuple[str, str], int] = {}


def plan_kernel(plan, op: str, **facts) -> Optional[Callable]:
    """Dispatch helper for the op layer.

    Returns the kernel wrapper when the plan resolves ``op`` to ``cuda`` and
    its capability predicate accepts the call-site ``facts``; ``None`` means
    take the reference path (the reject reason is recorded in
    :data:`DISPATCH_REJECTIONS`)."""
    resolved = plan.kernels.get(op) if plan.kernels else None
    if resolved is None:
        resolved = REGISTRY.resolve(op, plan.flow.kernel_backend,
                                    plan.platform)
    if resolved != "cuda":
        return None
    impl = REGISTRY.get(op, "cuda")
    reason = impl.reject_reason(**facts)
    if reason is not None:
        key = (op, reason)
        DISPATCH_REJECTIONS[key] = DISPATCH_REJECTIONS.get(key, 0) + 1
        METRICS.counter("kernels.dispatch.rejections").inc()
        return None
    return impl.fn


# ---------------------------------------------------------------------------
# Built-in CUDA registrations (the kernels/ package)
# ---------------------------------------------------------------------------

def _matmul_reject(x=None, w=None, **kw) -> Optional[str]:
    if x is None or w is None:
        return "matmul operands not provided to the dispatch predicate"
    if not (x.ndim >= 2 and w.ndim == 2):
        return (f"operand ranks (x.ndim={x.ndim}, w.ndim={w.ndim}) need "
                "x.ndim >= 2 and w.ndim == 2")
    return None


def _attention_reject(window=None, cross=False, **kw) -> Optional[str]:
    # window == 0 is a degenerate cell some configs use to disable the
    # flash path; cross-attention caches K/V outside the kernel
    if window == 0:
        return "window=0 disables the flash path"
    if cross:
        return "cross-attention caches K/V outside the kernel"
    return None


def _conv2d_reject(groups=1, **kw) -> Optional[str]:
    if groups != 1:
        return f"grouped conv (groups={groups}) has no CUDA path"
    return None


def _register_builtin():
    from repro_torch.kernels.attention import flash_attention
    from repro_torch.kernels.conv2d import conv2d_fused
    from repro_torch.kernels.decode_attention import (
        copy_block, decode_attention, paged_decode_attention)
    from repro_torch.kernels.lru_scan import lru_scan
    from repro_torch.kernels.matmul_fused import matmul_fused

    REGISTRY.register("matmul", "cuda", matmul_fused, rejects=_matmul_reject)
    REGISTRY.register("glu_matmul", "cuda", matmul_fused,
                      rejects=_matmul_reject)
    REGISTRY.register("attention", "cuda", flash_attention,
                      rejects=_attention_reject)
    REGISTRY.register("decode_attention", "cuda", decode_attention)
    REGISTRY.register("paged_decode_attention", "cuda",
                      paged_decode_attention)
    REGISTRY.register("copy_block", "cuda", copy_block)
    REGISTRY.register("conv2d", "cuda", conv2d_fused, rejects=_conv2d_reject)
    REGISTRY.register("rg_lru", "cuda", lru_scan)


_register_builtin()
