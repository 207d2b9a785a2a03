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
  arrays), so logits kept from one step survive the next replay.
* The wrappers' launch counters tick in Python, at capture only: the
  counters a capture moved are taken back and added again at each replay
  (:func:`repro_torch.kernels.registry.add_counts`), so every count is what
  the eager run would count.
* :func:`disable_graphs` (the counterpart of ``jax.disable_jit()``) runs
  the eager code on the card.  A stage called while another capture is in
  progress runs its ops into that capture.
* A capture or a replay that fails raises; nothing falls back to the eager
  code.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Callable, Dict, Hashable, Iterator, Optional

import torch
from torch.utils._pytree import tree_map_only

from repro_torch.kernels import registry

__all__ = ["disable_graphs", "graphs_enabled", "capturing", "signature",
           "StageGraphs", "MAX_GRAPHS"]

# the graphs one CompiledModel keeps; the least recently replayed goes first
MAX_GRAPHS = 32

_DISABLED = [0]


@contextlib.contextmanager
def disable_graphs() -> Iterator[None]:
    """Inside, every stage runs its eager code on the card (it nests)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def graphs_enabled() -> bool:
    return _DISABLED[0] == 0


def capturing(device: torch.device) -> bool:
    """Whether a CUDA-graph capture is in progress on ``device``'s current
    stream (never on the CPU)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def signature(tree) -> tuple:
    """(address, shape, stride, dtype) of every tensor of a nested
    dict / list / tuple, in key order; anything else by value."""
    if torch.is_tensor(tree):
        return (tree.data_ptr(), tuple(tree.shape), tree.stride(), tree.dtype)
    if isinstance(tree, dict):
        return tuple((k, signature(tree[k])) for k in sorted(tree, key=str))
    if isinstance(tree, (list, tuple)):
        return tuple(signature(v) for v in tree)
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


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "counts", "keep")

    def __init__(self, graph, inputs, outputs, counts, keep):
        self.graph = graph
        self.inputs = inputs            # name -> static buffer
        self.outputs = outputs          # the tree the capture returned
        self.counts = counts            # the counters one replay adds
        self.keep = keep                # objects the graph reads (a generator)


class StageGraphs:
    """The captured graphs of one CompiledModel, at most ``MAX_GRAPHS``,
    all allocating from one memory pool (replays run one after another on
    the current stream, so the graphs' temporaries may share it).

    ``stats``: graphs ``captured``, the wall seconds of the captures
    (``capture_s``), ``replays``, graphs ``evicted``, and ``pool_bytes``, the
    device memory the captures reserved."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = None
        self._side: Optional[torch.cuda.Stream] = None
        self._graphs: "collections.OrderedDict[Hashable, _Graph]" = \
            collections.OrderedDict()
        self.stats: Dict[str, Any] = {"captured": 0, "capture_s": 0.0,
                                      "replays": 0, "evicted": 0,
                                      "pool_bytes": 0}

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: Hashable, inputs: Dict[str, Any],
            fn: Callable[[Dict[str, torch.Tensor]], Any], *,
            first: Callable[[Callable[[], Any]], Any] = lambda f: f(),
            generator: Optional[torch.Generator] = None) -> Any:
        """``fn(static)`` on the graph of ``key``: ``static`` holds a device
        buffer per entry of ``inputs`` (a tensor, or an int as a 0-d int32
        tensor), refilled from ``inputs`` at every call.  The first call
        of a key runs ``first(lambda: fn(static))`` eagerly and returns its
        result, then captures ``fn``; later calls replay and return copies
        of the captured outputs.  ``generator`` is a ``torch.Generator`` the
        stage draws from, registered with the graph so that each replay
        advances it as the eager draws would."""
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            for name, x in inputs.items():
                _fill(entry.inputs[name], x)
            entry.graph.replay()
            registry.add_counts(entry.counts)
            self.stats["replays"] += 1
            return tree_map_only(torch.Tensor, torch.clone, entry.outputs)
        static = {name: _static(x, self.device) for name, x in inputs.items()}
        cur = torch.cuda.current_stream(self.device)
        side = self._stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = first(lambda: fn(static))
        cur.wait_stream(side)
        tree_map_only(torch.Tensor, lambda t: t.record_stream(cur), out)
        graph, outputs, counts = self._capture(static, fn, generator)
        self._graphs[key] = _Graph(graph, static, outputs, counts,
                                   (generator,))
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
            self.stats["evicted"] += 1
        return out

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
            dev = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            with contextlib.suppress(Exception):
                torch._C._cuda_endAllocateToPool(dev, graph.pool())
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
