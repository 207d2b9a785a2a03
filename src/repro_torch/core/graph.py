"""Layer-graph IR — the Relay analogue of the compilation flow.

Two levels:

* **Block graph** — an ordered list of :class:`Block` nodes (embedding, decoder
  layers, final head, …).  The folding pass (paper: *parameterized kernels*)
  groups isomorphic blocks here; the streaming pass assigns blocks to pipeline
  stages here.

* **Micro-op list** — each block carries a small SSA-style program of
  :class:`MicroOp` over named tensors.  The fusion pass (paper: *loop fusion*)
  and the precision pass rewrite at this level; lowering interprets it.

Blocks communicate through the reserved value name ``"h"`` (hidden states).
Encoder–decoder graphs additionally thread ``"cross"`` (encoder output).
Stateful ops (attention KV caches, recurrence states) declare state slots via
``state_specs``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple


# Dimension roles understood by the sharding solver / estimator.
# "heads"    — projection *output* dim (H·Dh): column-parallel over tp.
# "heads_in" — projection *contraction* dim (out-proj input): NOT tp-sharded,
#              so the out-projection is row-local and the residual costs one
#              bf16 all-gather instead of an f32 psum (§Perf iteration 2).
ROLES = (
    "d_model", "d_ff", "vocab", "heads", "heads_in", "kv_heads", "head_dim",
    "layers", "expert", "seq", "batch", "conv_k", "channels", "lora", "none",
)


@dataclass(frozen=True)
class ParamSpec:
    name: str
    shape: Tuple[int, ...]
    roles: Tuple[str, ...]           # semantic role per dim (drives sharding)
    init: str = "normal"             # normal | zeros | ones | lecun | embed
    init_scale: Optional[float] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.roles), (self.name, self.shape, self.roles)
        for r in self.roles:
            assert r in ROLES, r


@dataclass
class MicroOp:
    out: str
    op: str
    ins: Tuple[str, ...]
    params: Tuple[ParamSpec, ...] = ()
    attrs: Dict[str, Any] = field(default_factory=dict)

    def sig(self) -> str:
        p = [(ps.name, ps.shape, ps.roles, ps.init) for ps in self.params]
        a = {k: v for k, v in sorted(self.attrs.items()) if k != "state_key"}
        return json.dumps([self.out, self.op, list(self.ins), p, a], default=str)


@dataclass
class Block:
    name: str
    kind: str                        # embed | layer | head | encoder_layer | ...
    ops: List[MicroOp] = field(default_factory=list)
    attrs: Dict[str, Any] = field(default_factory=dict)

    # -- construction helpers -------------------------------------------------
    def add(self, out: str, op: str, *ins: str,
            params: Sequence[ParamSpec] = (), **attrs) -> str:
        self.ops.append(MicroOp(out, op, tuple(ins), tuple(params), dict(attrs)))
        return out

    # -- analysis -------------------------------------------------------------
    def signature(self) -> str:
        """Structural signature: blocks with equal signatures are isomorphic
        (same ops, same param shapes) and can be folded into one scan."""
        payload = json.dumps([self.kind, [op.sig() for op in self.ops]])
        return hashlib.sha1(payload.encode()).hexdigest()[:16]

    def param_specs(self) -> List[ParamSpec]:
        out: List[ParamSpec] = []
        for op in self.ops:
            out.extend(op.params)
        return out

    def param_count(self) -> int:
        n = 0
        for ps in self.param_specs():
            c = 1
            for d in ps.shape:
                c *= d
            n += c
        return n

    def stateful_ops(self) -> List[MicroOp]:
        return [op for op in self.ops if op.attrs.get("state_key")]


@dataclass
class Graph:
    name: str
    blocks: List[Block]
    meta: Dict[str, Any] = field(default_factory=dict)

    def __iter__(self):
        return iter(self.blocks)

    def block(self, name: str) -> Block:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def param_count(self) -> int:
        return sum(b.param_count() for b in self.blocks)

    def validate(self) -> None:
        names = [b.name for b in self.blocks]
        assert len(names) == len(set(names)), "duplicate block names"
        pnames = set()
        for b in self.blocks:
            defined = {"h", "cross", "positions"}
            for op in b.ops:
                for i in op.ins:
                    assert i in defined, f"{b.name}: op {op.op} reads undefined {i!r}"
                defined.add(op.out)
                for ps in op.params:
                    key = (b.name, ps.name)
                    assert key not in pnames, f"duplicate param {key}"
                    pnames.add(key)
            assert b.ops and b.ops[-1].out == "h", (
                f"block {b.name} must end by writing 'h'")


def iso_groups(blocks: List[Block]) -> List[Tuple[List[int], int]]:
    """Maximal runs of *consecutive* isomorphic blocks, as (indices, period).

    Detects repeating super-block patterns (e.g. (rec, rec, attn) × 8): a run
    whose signatures form a repeating cycle of length p is reported as one
    group with period p — the folding pass scans over the super-block.
    Returned groups partition ``range(len(blocks))``; a group of length 1 has
    period 1.  Only whole repetitions are grouped (reps × p indices).
    """
    sigs = [b.signature() for b in blocks]
    groups: List[Tuple[List[int], int]] = []
    i = 0
    n = len(blocks)
    while i < n:
        # try periods from 1 upward; prefer the period giving the longest run
        best_len, best_p = 1, 1
        for p in range(1, min(8, n - i) + 1):
            j = i + p
            while j < n and sigs[j] == sigs[j - p]:
                j += 1
            reps = (j - i) // p
            if reps >= 2 and reps * p > best_len:
                best_len, best_p = reps * p, p
        groups.append((list(range(i, i + best_len)), best_p))
        i += best_len
    return groups
