"""Captured CUDA graphs of the flow's stages: the port's counterpart of the
JAX package's jitted programs.

``jax.jit`` compiles a stage once and replays it; a CUDA graph does the same
on the card: the first call of a stage at a key runs eagerly (the warm-up,
on a side stream), the stage is then captured once, and every later call
copies its inputs into the graph's static buffers and replays every kernel
of the stage with one host launch.  The key holds what the graph baked in:
the stage, the inputs' shapes and dtypes, and the addresses, shapes,
strides and dtypes of the parameters' and the state's tensors, which the
graph reads and writes where they lie.

* A replay hands back copies of the graph's outputs (JAX returns fresh
  arrays), so logits kept from one step survive the next replay.  A pure
  stage (``pure=True``: a prefill, which reads and writes nothing but its
  inputs and outputs) hands back a replay's copies at its first call too:
  its warm-up's outputs are dropped before the capture, so that the
  capture never allocates beside them.  A stage that writes state in
  place runs once a call, so its first call hands back the warm-up's
  outputs (copying any on a static input's storage, which the next call
  refills).
* The wrappers' launch counters tick in Python, at capture only: the
  counters a capture moved are taken back and added again at each replay
  (:func:`repro_torch.kernels.registry.add_counts`), so every count is what
  the eager run would count.
* :func:`disable_graphs` (the counterpart of ``jax.disable_jit()``) runs
  the eager code on the card; :func:`clear_graphs` (of
  ``jax.clear_caches()``) drops every graph.  A stage called while another capture is in
  progress runs its ops into that capture.
* A capture or a replay that fails raises; nothing falls back to the eager
  code.
* A graph keeps its temporaries and outputs in the pool for as long as it
  lives (XLA's executables borrow theirs a call).  The graphs of one
  model share one pool, which goes back to the device only when none of
  them is left; so a new capture that would not leave the card the memory
  its warm-up just took (the device memory the warm-up reserved, plus
  its outputs, which a replay copies out) drops every graph of its model
  first, then of the other models on the card while that is still short,
  and captures into a new pool; a pure stage whose warm-up runs out of
  memory drops them all and runs it once more.
"""
from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Any, Callable, Dict, Hashable, Iterator, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map_only

from repro_torch.kernels import registry

__all__ = ["disable_graphs", "clear_graphs", "graphs_enabled", "capturing",
           "signature", "StageGraphs"]

_DISABLED = [0]
# every live StageGraphs, whose pools a capture short of room may drop
_RUNNERS: "weakref.WeakSet[StageGraphs]" = weakref.WeakSet()


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Inside, every stage runs its eager code on the card (it nests)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def clear_graphs() -> None:
    """Drop every model's graphs and held states, and give their pools
    back to the device (the counterpart of ``jax.clear_caches()``): for a
    large eager run beside models whose graphs it does not need."""
    for runner in list(_RUNNERS):
        runner._drop()
    torch.cuda.empty_cache()


def graphs_enabled() -> bool:
    return _DISABLED[0] == 0


def capturing(device: torch.device) -> bool:
    """Whether a CUDA-graph capture is in progress on ``device``'s current
    stream (never on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def signature(tree, addresses: bool = True) -> tuple:
    """(address, shape, stride, dtype) of every tensor of a nested
    dict / list / tuple, in key order; anything else by value.  Without
    ``addresses``, what two trees whose tensors could stand in for each
    other share."""
    if torch.is_tensor(tree):
        meta = (tuple(tree.shape), tree.stride(), tree.dtype)
        return (tree.data_ptr(),) + meta if addresses else meta
    if isinstance(tree, dict):
        return tuple((k, signature(tree[k], addresses))
                     for k in sorted(tree, key=str))
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v, addresses) for v in tree)
    return (tree,)


def _static(x, device: torch.device) -> torch.Tensor:
    """A static buffer for input ``x``: a tensor's copy, an int's 0-d int32
    tensor (filled on the device, no host-to-device copy)."""
    if torch.is_tensor(x):
        return x.detach().to(device, copy=True)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _fill(buf: torch.Tensor, x) -> None:
    if torch.is_tensor(x):
        buf.copy_(x)
    else:
        buf.fill_(int(x))


def _unaliased(out, static: Dict[str, torch.Tensor]):
    """``out`` with a copy of each tensor on a static buffer's storage:
    the next call refills that buffer."""
    held = {b.untyped_storage().data_ptr() for b in static.values()}
    return tree_map_only(
        torch.Tensor, lambda t: t.clone()
        if t.untyped_storage().data_ptr() in held else t, out)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _nbytes(tree) -> int:
    """The bytes of a tree's tensors."""
    return sum(t.numel() * t.element_size()
               for t in tree_flatten(tree)[0] if torch.is_tensor(t))


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "counts", "keep")

    def __init__(self, graph, inputs, outputs, counts, keep):
        self.graph = graph
        self.inputs = inputs            # name -> static buffer
        self.outputs = outputs          # the tree the capture returned
        self.counts = counts            # the counters one replay adds
        self.keep = keep                # objects the graph reads (a generator)


class StageGraphs:
    """The captured graphs of one CompiledModel, all allocating from one
    memory pool (replays run one after another on the current stream, so
    the graphs' temporaries may share it), and the states a stage keeps
    for them (:meth:`held`).

    ``stats``: graphs ``captured``, the wall seconds of the captures
    (``capture_s``), ``replays``, graphs ``evicted`` (dropped to make room
    for a capture), ``pool_bytes``, the device memory the current pool's
    captures reserved, and ``held_bytes``, the held states'."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None
        self._side: Optional[torch.cuda.Stream] = None
        self._graphs: Dict[Hashable, _Graph] = {}
        self._held: Dict[tuple, Any] = {}
        self.stats: Dict[str, Any] = {"captured": 0, "capture_s": 0.0,
                                      "replays": 0, "evicted": 0,
                                      "pool_bytes": 0, "held_bytes": 0}
        _RUNNERS.add(self)

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, inputs: Dict[str, Any],
            fn: Callable[[Dict[str, torch.Tensor]], Any], *,
            first: Callable[[Callable[[], Any]], Any] = lambda f: f(),
            generator: Optional[torch.Generator] = None,
            pure: bool = False) -> Any:
        """``fn(static)`` on the graph of ``key``: ``static`` holds a device
        buffer per entry of ``inputs`` (a tensor, or an int as a 0-d int32
        tensor), refilled from ``inputs`` at every call.  The first call
        of a key runs ``first(lambda: fn(static))`` eagerly (the warm-up),
        then captures ``fn``; later calls replay and return copies of the
        captured outputs.  The first call returns the warm-up's result, or,
        when ``fn`` is ``pure`` (it writes nothing but its outputs), drops
        it before the capture and returns a replay's copies.
        ``generator`` is a ``torch.Generator`` the stage draws from,
        registered with the graph so that each replay advances it as the
        eager draws would."""
        entry = self._graphs.get(key)
        if entry is not None:
            for name, x in inputs.items():
                _fill(entry.inputs[name], x)
            return self._replay(entry, count=True)
        static = {name: _static(x, self.device) for name, x in inputs.items()}
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            try:
                out = first(lambda: fn(static))
                short = False
            except torch.OutOfMemoryError:
                if not pure:
                    raise
                short = True
            if short:
                # a pure stage's warm-up can run again: first with the
                # card's graphs dropped (outside the handler, whose
                # traceback holds the failed call's tensors)
                self._make_room(None)
                reserved = torch.cuda.memory_reserved(self.device)
                out = first(lambda: fn(static))
        cur.wait_stream(side)
        need = torch.cuda.memory_reserved(self.device) - reserved \
            + _nbytes(out)
        if pure:
            out = None
        else:
            tree_map_only(torch.Tensor, lambda t: t.record_stream(cur), out)
            out = _unaliased(out, static)
        self._make_room(need)
        graph, outputs, counts = self._capture(static, fn, generator)
        entry = self._graphs[key] = _Graph(graph, static, outputs, counts,
                                           (generator,))
        # the warm-up counted the launches of this call
        return self._replay(entry, count=False) if pure else out

    def _replay(self, entry: _Graph, count: bool) -> Any:
        entry.graph.replay()
        if count:
            registry.add_counts(entry.counts)
            self.stats["replays"] += 1
        return tree_map_only(torch.Tensor, torch.clone, entry.outputs)

    def _make_room(self, need: Optional[int]) -> None:
        """Before a capture: as ``torch.cuda.graph`` does, collect (so that
        no collection inside the capture destroys a dropped graph, whose
        freed pool would invalidate it) and give the cached blocks back;
        then, while the card has less than ``need`` bytes free (``None``:
        whatever it has), drop every graph and held state of this runner,
        then of the other models' runners on this device, so that their
        pools go back too."""
        gc.collect()
        torch.cuda.empty_cache()
        others = [r for r in _RUNNERS if r is not self
                  and r.device.type == "cuda"
                  and _index(r.device) == _index(self.device)]
        for runner in [self] + others:
            if need is not None and \
                    torch.cuda.mem_get_info(self.device)[0] >= need:
                return
            if runner._graphs or runner._held:
                runner._drop()
                torch.cuda.empty_cache()

    def _drop(self) -> None:
        self.stats["evicted"] += len(self._graphs)
        self.stats["pool_bytes"] = self.stats["held_bytes"] = 0
        self._graphs.clear()
        self._held.clear()
        self.pool = None

    def held(self, like) -> Any:
        """A tree of tensors of ``like``'s layout that this runner keeps
        (one a layout) until it drops its graphs, ``like`` copied in: a
        stage whose graph keys on its state's addresses replays on it at
        every call."""
        key = signature(like, addresses=False)
        tree = self._held.get(key)
        if tree is None:
            tree = self._held[key] = tree_map_only(
                torch.Tensor, torch.empty_like, like)
            self.stats["held_bytes"] += _nbytes(tree)
        for dst, src in zip(tree_flatten(tree)[0], tree_flatten(like)[0]):
            dst.copy_(src)
        return tree

    def _stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _abandon(self, graph) -> None:
        """Leave a capture that failed (the caller raises its error): end
        it, and release the pool from the capture stream's allocations,
        which ``capture_end`` skips when the capture was invalidated.  The
        next capture takes a new pool and a new side stream."""
        try:
            graph.capture_end()
        except Exception:
            with contextlib.suppress(Exception):
                torch._C._cuda_endAllocateToPool(_index(self.device),
                                                 graph.pool())
        self.pool, self._side = None, None

    def _capture(self, static, fn, generator):
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = registry.snapshot_counts()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        side = self._stream()
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            graph.capture_begin(pool=self.pool)
            try:
                outputs = fn(static)
            except BaseException:
                self._abandon(graph)
                registry.add_counts(registry.count_delta(
                    before, registry.snapshot_counts()), -1)
                raise
            graph.capture_end()
        counts = registry.count_delta(before, registry.snapshot_counts())
        registry.add_counts(counts, -1)       # the capture launched nothing
        self.stats["captured"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        self.stats["pool_bytes"] += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)
        return graph, outputs, counts
