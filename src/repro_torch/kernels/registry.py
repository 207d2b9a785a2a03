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
``kernels.dispatch.rejections`` metric).  The static verifier
(:mod:`repro_torch.analysis`) reads each impl's declared
:class:`KernelContract` and surfaces the statically-decidable rejections as
``K204`` diagnostics.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

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
class KernelContract:
    """The statically-checkable contract a kernel impl declares; consumed by
    :mod:`repro_torch.analysis` (``verify_plan``) without launching anything.

    * ``workingset`` — ``(plan, ecfg) -> [(call, schedule, bytes), ...]``:
      the shared memory a block of the hand kernel asks for, under the
      schedule its ``_schedule`` picks at each distinct call the plan makes
      (:mod:`repro_torch.kernels.workingset`); checked against 227 KiB a
      block or ``flow.vmem_budget_bytes`` if that is smaller (K202).  A
      ``lib=`` keyword (the loaded kernel library) reads the bytes from the
      library's queries instead of the mirror;
    * ``donation_safe`` — whether the kernel may write into a donated
      (in-place) state buffer (a donation-unsafe kernel under
      ``cache.donate_state`` is K203);
    * ``index_space`` — ``"block_table"`` marks a gather through the paged
      pool's block table, whose indices must stay inside the pool (K205
      checks the pool geometry on the serving side);
    * ``static_reject`` — the statically-decidable part of the capability
      predicate, ``(op_attrs, cfg) -> Optional[reason]``: a reason means
      dispatch will take the reference op (surfaced as K204);
    * ``tile_key`` / ``tile_candidates`` — the ``plan.tiles`` entry a
      kernel takes its blocks from (on a card plan the tiling pass's
      Hopper target) and ``(cfg, shape, flow=None) -> tiles`` to search:
      the Hopper tiles the kernel takes at the cell's shapes and the flow's
      precision (bf16 without a flow), which the serving autotune's
      ``tune_kernel_tiles`` benches through ``FlowConfig.tile_overrides``.
      matmul declares its key without candidates, as in JAX."""
    workingset: Optional[Callable[[Any, Any],
                                  List[Tuple[str, str, int]]]] = None
    donation_safe: bool = True
    index_space: Optional[str] = None
    static_reject: Optional[Callable[[Dict[str, Any], Any],
                                     Optional[str]]] = None
    tile_key: Optional[str] = None
    tile_candidates: Optional[Callable[[Any, Any],
                                       Tuple[Any, ...]]] = None


@dataclass(frozen=True)
class KernelImpl:
    """One registered kernel implementation.

    ``rejects`` is the call-site capability predicate: it receives the
    keyword facts the op layer passes to :func:`plan_kernel` and returns
    ``None`` (accepted) or a reason string.  ``contract`` is the declared
    static contract the verifier checks (see :class:`KernelContract`).
    ``fake`` is the kernel's shape-only stand-in (same signature, outputs
    unfilled, its work counted in :mod:`repro_torch.kernels._fake`), which
    :func:`plan_kernel` hands out inside :func:`fake_kernels`."""
    op: str
    backend: str
    fn: Callable
    rejects: Optional[Callable[..., Optional[str]]] = None
    contract: Optional[KernelContract] = None
    fake: Optional[Callable] = None

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
                 rejects: Optional[Callable[..., Optional[str]]] = None,
                 contract: Optional[KernelContract] = None,
                 fake: Optional[Callable] = None) -> Callable:
        """Register ``fn`` as the ``backend`` implementation of ``op``
        (``fake``: its shape-only stand-in, see :class:`KernelImpl`)."""
        backend = canon_backend(backend)
        if backend == "auto":
            raise ValueError("'auto' is a resolution policy, not a backend")
        self._impls[(op, backend)] = KernelImpl(op, backend, fn,
                                                rejects=rejects,
                                                contract=contract, fake=fake)
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

    def has(self, op: str, backend: str) -> bool:
        backend = canon_backend(backend)
        if backend == "ref":
            return (op, "ref") in self._impls or op in self._ref_ops()
        return (op, backend) in self._impls

    def get(self, op: str, backend: str) -> KernelImpl:
        """The ``backend`` implementation of ``op``; ``ref`` falls back to
        the reference op table."""
        backend = canon_backend(backend)
        impl = self._impls.get((op, backend))
        if impl is None and backend == "ref":
            fn = self._ref_ops().get(op)
            if fn is not None:
                impl = KernelImpl(op, "ref", fn)
        if impl is None:
            raise KeyError(f"no {backend!r} implementation registered for "
                           f"op {op!r} (have: {self.backends(op)})")
        return impl

    def backends(self, op: str) -> Tuple[str, ...]:
        out = {b for (o, b) in self._impls if o == op}
        if op in self._ref_ops():
            out.add("ref")
        return tuple(sorted(out))

    # -- resolution ---------------------------------------------------------
    def resolve(self, op: str, backend: str, platform: str) -> str:
        """Plan-time backend choice for one op on ``platform``
        (``"cpu"`` | ``"cuda"``).

        ``auto`` → the CUDA kernel where one exists, the platform is
        ``cuda`` and the card is a Hopper (inside :func:`fake_kernels` the
        plan's target is taken for one, and no device is asked);
        reference elsewhere.  An explicit
        ``cuda`` request degrades to ``ref`` for ops with no CUDA kernel; on
        a CPU model it reaches the kernel wrappers, which run their plain
        versions on CPU tensors."""
        from repro_torch.device import hopper_ok
        backend = canon_backend(backend)
        has_cuda = (op, "cuda") in self._impls
        if backend == "auto":
            if has_cuda and platform == "cuda" and (_FAKE[0] or hopper_ok()):
                return "cuda"
            return "ref"
        if backend == "cuda":
            return "cuda" if has_cuda else "ref"
        return "ref"

    def resolve_all(self, backend: str, platform: str) -> Dict[str, str]:
        """Resolution table for every known op (recorded on the plan)."""
        return {op: self.resolve(op, backend, platform) for op in self.ops()}


REGISTRY = KernelRegistry()

# whether plan_kernel hands out the stand-ins (fake_kernels is entered)
_FAKE = [False]


@contextlib.contextmanager
def fake_kernels():
    """Inside, :func:`plan_kernel` returns each kernel's shape-only
    stand-in (``KernelImpl.fake``) instead of its wrapper, and ``auto``
    resolves for a ``cuda`` platform as on a Hopper card without asking
    the device: the dry-run's program on fake tensors, which no wrapper
    can launch on.  Yields :data:`repro_torch.kernels._fake.COST`, emptied
    on entry, which the stand-ins fill.  Nothing on the card's launch path
    changes outside it."""
    from repro_torch.kernels import _fake
    prev = _FAKE[0]
    _FAKE[0] = True
    _fake.COST.clear()
    try:
        yield _fake.COST
    finally:
        _FAKE[0] = prev

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
    if _FAKE[0]:
        if impl.fake is None:
            raise NotImplementedError(f"{op}: no shape-only stand-in")
        return impl.fake
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


# ---------------------------------------------------------------------------
# working sets: each hand kernel's shared bytes at the calls a plan makes
# ---------------------------------------------------------------------------

def _mops(plan, op: str):
    for block in plan.graph.blocks:
        for mop in block.ops:
            if mop.op == op:
                yield mop


def _lm_rows(plan) -> Tuple[int, ...]:
    """Rows of the plan's products: B x S for a prefill or train cell; a
    decode cell also prefills prompts of up to its S tokens, then B a step."""
    sh = plan.shape
    if plan.cfg.family == "cnn":
        return (sh.global_batch,)
    if sh.kind == "decode":
        return (sh.global_batch * sh.seq_len, sh.global_batch)
    return (sh.global_batch * sh.seq_len,)


def _hopper_tile(plan, key: str):
    """The plan's ``key`` tile where the kernels take it (a card plan: the
    tiling pass's Hopper target); None (the kernels' default) on a CPU
    plan, whose table is the TPU's and whose wrappers run their plain
    versions."""
    return plan.tiles.get(key) if plan.platform == "cuda" else None


def _matmul_ws(op: str):
    """The working sets of the plan's ``op`` (``matmul`` or
    ``glu_matmul``) calls: (M, K, N) at each row count."""
    def calls(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
        from repro_torch.kernels import workingset as ws
        dt, out = plan.prec.compute_dtype, {}
        tile = _hopper_tile(plan, "matmul")
        for mop in _mops(plan, op):
            K, N = mop.params[0].shape
            for M in _lm_rows(plan):
                out[(M, K, N)] = ws.matmul(M, K, N, dt, op == "glu_matmul",
                                           lib=lib, tile=tile)
        return [(f"{M}x{K}x{N}", s, b) for (M, K, N), (s, b) in out.items()]
    return calls


def _attention_ws(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
    from repro_torch.kernels import workingset as ws
    a = plan.cfg.attention
    if a is None or not any(_mops(plan, "attention")):
        return []
    s, b = ws.flash_attention(a.head_dim, plan.prec.compute_dtype, lib=lib,
                              tile=_hopper_tile(plan, "attention"))
    return [(f"D={a.head_dim}", s, b)]


def _decode_ws(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
    """The rolling-cache kernel at the plan's batch and cache slots."""
    from repro_torch.kernels import workingset as ws
    a = plan.cfg.attention
    if a is None or not any(_mops(plan, "attention")):
        return []
    G = a.n_heads // a.n_kv_heads
    B, C = plan.shape.global_batch, plan.cache_len
    s, b = ws.decode_attention(a.head_dim, G, plan.prec.compute_dtype, B, C,
                               a.n_kv_heads, lib=lib)
    return [(f"D={a.head_dim} G={G} B={B} C={C}", s, b)]


def _paged_ws(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
    """The paged kernel at the serving envelope: ``ecfg``'s block size,
    sequence cap and widest tick (chunk or verify cell), or the plan's
    sequence length in blocks of 16 and one query a row without one."""
    from repro_torch.kernels import workingset as ws
    a = plan.cfg.attention
    if a is None or not any(_mops(plan, "attention")):
        return []
    if ecfg is not None:
        bs, nblk = ecfg.block_size, ecfg.blocks_per_slot
        sq = max(ecfg.tick_buckets)
    else:
        bs, sq = 16, 1
        nblk = -(-plan.shape.seq_len // bs)
    G = a.n_heads // a.n_kv_heads
    s, b = ws.paged_decode_attention(a.head_dim, plan.prec.compute_dtype,
                                     sq, G, nblk, bs, lib=lib)
    return [(f"D={a.head_dim} Sq={sq} G={G} blocks={nblk}x{bs}", s, b)]


def _conv2d_ws(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
    from repro_torch.kernels import workingset as ws
    dt, out = plan.prec.compute_dtype, {}
    tile = _hopper_tile(plan, "conv2d")
    for mop in _mops(plan, "conv2d"):
        if _conv2d_reject(groups=mop.attrs.get("groups", 1)):
            continue
        kh, kw, CI, CO = mop.params[0].shape
        st = mop.attrs.get("stride", 1)
        out[(kh, kw, CI, CO, st)] = ws.conv2d(kh, kw, CI, CO, st, dt,
                                              lib=lib, tile=tile)
    return [(f"{kh}x{kw} s{st} {CI}->{CO}", s, b)
            for (kh, kw, CI, CO, st), (s, b) in out.items()]


def _lru_ws(plan, ecfg=None, lib=None) -> List[Tuple[str, str, int]]:
    """The scan as ``op_rg_lru`` hands it: fp32 a and b, B x S x W."""
    from repro_torch.kernels import workingset as ws
    sh, out = plan.shape, {}
    for mop in _mops(plan, "rg_lru"):
        W = mop.params[0].shape[0]
        out[W] = ws.lru_scan(sh.global_batch, sh.seq_len, W, torch.float32,
                             lib=lib)
    return [(f"{sh.global_batch}x{sh.seq_len}x{W}", s, b)
            for W, (s, b) in out.items()]


def _attention_tile_candidates(cfg, shape, flow=None) -> Tuple[Any, ...]:
    """The (bq, bk) tiles flash attention takes at the cfg's head width and
    the flow's precision whose working set fits the 232,448 shared bytes a
    block may opt in to (not (128, 64) in fp32 at head width 256); none at
    the ``simt`` widths, which take no tile, or without attention."""
    from repro_torch.core.passes.tiling import compute_dtype
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import workingset as ws
    a = cfg.attention
    if a is None or a.head_dim not in ka.TILED_HEAD_DIMS:
        return ()
    dt = compute_dtype(flow)
    return tuple(t for t in ka.TILES
                 if ws.flash_attention(a.head_dim, dt, tile=t)[1]
                 <= ws.BLOCK_SHARED)


def _conv2d_tile_candidates(cfg, shape, flow=None) -> Tuple[Any, ...]:
    """The (bm, bn) tiles the conv kernels take; none for a model without
    a conv (the overrides would time a program that never reads them)."""
    from repro_torch.kernels import conv2d as kc
    return kc.TILES if cfg.family == "cnn" else ()


def _register_builtin():
    from repro_torch.kernels.attention import (flash_attention,
                                               flash_attention_fake)
    from repro_torch.kernels.conv2d import conv2d_fused, conv2d_fused_fake
    from repro_torch.kernels.decode_attention import (
        copy_block, copy_block_fake, copy_block_plain, decode_attention,
        decode_attention_fake, paged_decode_attention,
        paged_decode_attention_fake, paged_decode_attention_plain)
    from repro_torch.kernels.lru_scan import lru_scan, lru_scan_fake
    from repro_torch.kernels.matmul_fused import (matmul_fused,
                                                  matmul_fused_fake)

    REGISTRY.register("matmul", "cuda", matmul_fused, rejects=_matmul_reject,
                      contract=KernelContract(workingset=_matmul_ws("matmul"),
                                              tile_key="matmul"),
                      fake=matmul_fused_fake)
    REGISTRY.register(
        "glu_matmul", "cuda", matmul_fused, rejects=_matmul_reject,
        contract=KernelContract(workingset=_matmul_ws("glu_matmul"),
                                tile_key="matmul"),
        fake=matmul_fused_fake)
    REGISTRY.register(
        "attention", "cuda", flash_attention, rejects=_attention_reject,
        contract=KernelContract(
            workingset=_attention_ws,
            static_reject=lambda attrs, cfg: _attention_reject(
                window=attrs.get("window"), cross=attrs.get("cross", False)),
            tile_key="attention",
            tile_candidates=_attention_tile_candidates),
        fake=flash_attention_fake)
    REGISTRY.register("decode_attention", "cuda", decode_attention,
                      contract=KernelContract(workingset=_decode_ws),
                      fake=decode_attention_fake)
    # the serving path: the kernel gathers pool blocks through the block
    # table; the explicit ref entry is its plain version, which the serving
    # autotune's benches run off the card.  index_space declares the
    # gather-bounds contract the serving verifier checks against the pool
    # geometry (K205).
    paged = KernelContract(workingset=_paged_ws, index_space="block_table")
    REGISTRY.register("paged_decode_attention", "cuda",
                      paged_decode_attention, contract=paged,
                      fake=paged_decode_attention_fake)
    REGISTRY.register("paged_decode_attention", "ref",
                      paged_decode_attention_plain,
                      contract=KernelContract(index_space="block_table"))
    # prefix-cache copy-on-write fork: one pool block copied over another in
    # place; safe under donated state because the fork always copies src to
    # a freshly allocated dst (never aliased)
    copy = KernelContract(index_space="block_table", donation_safe=True)
    REGISTRY.register("copy_block", "cuda", copy_block, contract=copy,
                      fake=copy_block_fake)
    REGISTRY.register("copy_block", "ref", copy_block_plain, contract=copy)
    REGISTRY.register(
        "conv2d", "cuda", conv2d_fused, rejects=_conv2d_reject,
        contract=KernelContract(
            workingset=_conv2d_ws,
            static_reject=lambda attrs, cfg:
                _conv2d_reject(groups=attrs.get("groups", 1)),
            tile_key="conv2d", tile_candidates=_conv2d_tile_candidates),
        fake=conv2d_fused_fake)
    REGISTRY.register("rg_lru", "cuda", lru_scan,
                      contract=KernelContract(workingset=_lru_ws),
                      fake=lru_scan_fake)


_register_builtin()


# ---------------------------------------------------------------------------
# The wrappers' launch counters
# ---------------------------------------------------------------------------

# each wrapper's counters: ints, or dicts by schedule (their keys stay at 0
# on a reset) or by tile and shape (their keys go)
COUNTER_ATTRS = ("launches", "retiled", "base_launches", "schedule_launches",
                 "schedules", "base_schedule_launches", "tiles", "shapes")
_KEYED_BY_SCHEDULE = ("schedule_launches", "schedules",
                      "base_schedule_launches")


def kernel_wrappers() -> Dict[str, Callable]:
    """Every hand-kernel wrapper by its kernel's name; each counts its
    launches in the attributes of :data:`COUNTER_ATTRS` it has."""
    from repro_torch.kernels import attention, conv2d, lru_scan, matmul_fused
    from repro_torch.kernels import decode_attention as dec
    return {"conv2d_fused": conv2d.conv2d_fused,
            "matmul_fused": matmul_fused.matmul_fused,
            "flash_attention": attention.flash_attention,
            "decode_attention": dec.decode_attention,
            "paged_decode_attention": dec.paged_decode_attention,
            "copy_block": dec.copy_block, "lru_scan": lru_scan.lru_scan}


def snapshot_counts() -> Dict[Tuple[str, str], Any]:
    """Every counter of every wrapper, {(kernel, attribute): value}, and
    :data:`DISPATCH_REJECTIONS` under ``("dispatch", "rejections")``, the
    dicts copied."""
    out = {(name, a): (dict(v) if isinstance(v, dict) else v)
           for name, fn in kernel_wrappers().items()
           for a in COUNTER_ATTRS if hasattr(fn, a)
           for v in (getattr(fn, a),)}
    out[("dispatch", "rejections")] = dict(DISPATCH_REJECTIONS)
    return out


def count_delta(before: Dict[Tuple[str, str], Any],
                after: Dict[Tuple[str, str], Any]
                ) -> Dict[Tuple[str, str], Any]:
    """What the counters moved from ``before`` to ``after`` (two
    snapshots): the counters and dict keys that changed, by how much."""
    out: Dict[Tuple[str, str], Any] = {}
    for key, v in after.items():
        b = before.get(key, {} if isinstance(v, dict) else 0)
        if isinstance(v, dict):
            d = {k: n - b.get(k, 0) for k, n in v.items()
                 if n != b.get(k, 0)}
            if d:
                out[key] = d
        elif v != b:
            out[key] = v - b
    return out


def add_counts(delta: Dict[Tuple[str, str], Any], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`count_delta`) to the counters;
    a tile or shape key that falls to 0 goes, as after a reset."""
    fns = kernel_wrappers()
    for (name, attr), d in delta.items():
        if not isinstance(d, dict):
            setattr(fns[name], attr, getattr(fns[name], attr) + times * d)
            continue
        cur = DISPATCH_REJECTIONS if name == "dispatch" \
            else getattr(fns[name], attr)
        for k, n in d.items():
            cur[k] = cur.get(k, 0) + times * n
            if cur[k] == 0 and attr not in _KEYED_BY_SCHEDULE:
                del cur[k]


def reset_counts() -> None:
    """Every wrapper's counter to 0: the ints, the dicts by schedule (their
    keys kept); the dicts by tile and shape emptied.
    :data:`DISPATCH_REJECTIONS` is kept (its readers clear it)."""
    fns = kernel_wrappers()
    for (name, attr), v in snapshot_counts().items():
        if name == "dispatch":
            continue
        if isinstance(v, dict):
            v = dict.fromkeys(v, 0) if attr in _KEYED_BY_SCHEDULE else {}
        else:
            v = 0
        setattr(fns[name], attr, v)
