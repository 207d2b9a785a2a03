"""Sharding pass — partitioning as a compilation decision (paper §IV-J,
grown across devices).

The paper's factor selection chooses hardware parallelism factors per layer;
on a multi-device system the dominant factors are the mesh axes the model is
split over (dp / tp / pp).  This pass makes that a *plan* decision instead of
launch wiring: it consumes the flow's mesh factorization
(``FlowConfig.mesh_split``, normally set by ``repro_torch.flow.compile(mesh=...)``
or by the DSE), runs the divisibility-aware solver over every parameter of
the (post-folding) plan, assigns pipeline stages when a pp axis is present,
and records the result as a :class:`ShardingPlan` on the ``ExecutionPlan``
(``plan.sharding``, shown in ``plan.describe()``).

The runtime (``ShardingRules``, not ported yet: ROADMAP Queue 1,
"Multi-device") binds
these recorded decisions to a live device mesh; the solver itself lives
here so the explorer can search mesh factorizations without touching a
device.

Solver policy (moved from ``distributed/sharding.py``):

* **tp ("model")** — d_ff (Megatron column/row FFN), vocab (embedding/head),
  expert (EP, when num_experts divides the axis), heads (storage sharding of
  attention projections; compute-level attention parallelism is context
  parallelism over the sequence, which works for every head count).
* **fsdp (dp axes)** — the largest remaining divisible dim (d_model first):
  ZeRO-3-style parameter + optimizer-state sharding; XLA inserts the
  all-gathers at use and reduce-scatters the gradients.

Every assignment checks divisibility — jit rejects uneven shards — and never
uses a mesh axis twice in one spec.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


from repro_torch.core.passmanager import Pass, PlanContext
from repro_torch.distributed.meshspec import MeshSpec


class P(tuple):
    """A partition spec: one mesh-axis entry (a name, a tuple of names, or
    None) per tensor dim.  A plain tuple with ``PartitionSpec``'s repr, so
    the recorded plan reads the same as the JAX package's."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"

# role -> priority order for the tp axis (first divisible wins).
# "heads_in" is deliberately absent: the attention out-projection stays
# row-local (its input is already sequence-sharded by context parallelism).
TP_ROLES = ("expert", "d_ff", "vocab", "heads")
# role -> priority for fsdp
FSDP_ROLES = ("d_model", "heads", "heads_in", "d_ff", "vocab", "expert",
              "layers")

ACT_ROLE_AXES = {
    "batch": "__dp__",
    "seq_cp": "__tp__",      # context-parallel sequence sharding
    "kv_len": "__tp__",      # decode: KV cache length over tp
    "vocab": "__tp__",
    "d_ff": "__tp__",
    "expert": "__tp__",
    "heads": "__tp__",
    "gather": None,          # force replication (KV all-gather)
    "none": None,
    "seq": None,
}


# ---------------------------------------------------------------------------
# pure solver (no mesh, no devices)
# ---------------------------------------------------------------------------

def _entry_size(entry, axis_sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= axis_sizes.get(a, 1)
        return n
    return axis_sizes.get(entry, 1)


def solve_param_pspec(roles: Tuple[str, ...], shape: Tuple[int, ...],
                      dp_axes: Tuple[str, ...], tp_axis: Optional[str],
                      axis_sizes: Dict[str, int]) -> P:
    """The divisibility-aware role -> mesh-axis assignment for one param."""
    assert len(roles) == len(shape), (roles, shape)
    entries: list = [None] * len(roles)
    tp_size = axis_sizes.get(tp_axis, 1) if tp_axis else 1
    dp_size = 1
    for a in dp_axes:
        dp_size *= axis_sizes.get(a, 1)
    used_tp = tp_axis is None
    for want in TP_ROLES:
        if used_tp:
            break
        for i, r in enumerate(roles):
            if r == want and shape[i] % tp_size == 0:
                entries[i] = tp_axis
                used_tp = True
                break
    dp_ent = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    if dp_ent is not None:
        for want in FSDP_ROLES:
            done = False
            for i, r in enumerate(roles):
                if (r == want and entries[i] is None
                        and shape[i] % dp_size == 0):
                    entries[i] = dp_ent
                    done = True
                    break
            if done:
                break
    return P(*entries)


def solve_act_pspec(roles: Tuple[str, ...], shape: Tuple[int, ...],
                    dp_axes: Tuple[str, ...], tp_axis: Optional[str],
                    axis_sizes: Dict[str, int]) -> P:
    """Role -> mesh-axis assignment for one activation/state tensor."""
    entries = []
    used: set = set()
    dp_ent = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)
    for i, r in enumerate(roles):
        ax = ACT_ROLE_AXES.get(r)
        if ax == "__dp__":
            ent, flat = dp_ent, dp_axes
        elif ax == "__tp__":
            ent, flat = tp_axis, (tp_axis,) if tp_axis else ()
        else:
            ent, flat = None, ()
        if ent is not None and (set(flat) & used
                                or shape[i] % _entry_size(ent, axis_sizes)
                                != 0):
            ent, flat = None, ()
        used |= set(flat)
        entries.append(ent)
    return P(*entries)


# ---------------------------------------------------------------------------
# the recorded decision
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingPlan:
    """Partitioning decisions recorded on the ExecutionPlan: the mesh
    factorization, the axis roles, every parameter's PartitionSpec, and the
    pipeline-stage assignment.  ``distributed.sharding.ShardingRules`` binds
    these to a live mesh; ``plan.describe()`` reports them."""
    mesh: MeshSpec
    dp_axes: Tuple[str, ...]
    tp_axis: Optional[str]
    pp_axis: Optional[str]
    # flat "<unit key>/<param key>" -> PartitionSpec for every param leaf
    param_specs: Dict[str, P] = field(default_factory=dict)
    n_stages: int = 1
    stage_of_layer: Tuple[int, ...] = ()   # stage per folded-unit layer (rep)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return self.mesh.shape

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh.axis_size(a)
        return n

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp_axis) if self.tp_axis else 1

    @property
    def pp_size(self) -> int:
        return self.mesh.axis_size(self.pp_axis) if self.pp_axis else 1

    def param_pspec(self, key: str) -> Optional[P]:
        return self.param_specs.get(key)

    def act_pspec(self, roles: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
        return solve_act_pspec(roles, shape, self.dp_axes, self.tp_axis,
                               self.axis_sizes)

    def spec_counts(self) -> Dict[str, int]:
        """tp- / fsdp- / replicated param-tensor counts (describe line)."""
        tp = fsdp = repl = 0
        dp_flat = set(self.dp_axes)
        for ps in self.param_specs.values():
            axes: set = set()
            for e in ps:
                if e is None:
                    continue
                axes |= set(e) if isinstance(e, tuple) else {e}
            if self.tp_axis in axes:
                tp += 1
            elif axes & dp_flat:
                fsdp += 1
            else:
                repl += 1
        return {"tp": tp, "fsdp": fsdp, "repl": repl}

    def describe_line(self) -> str:
        c = self.spec_counts()
        tp = f"{self.tp_axis}:{self.tp_size}" if self.tp_axis else "-"
        pp = (f"{self.pp_axis}:{self.n_stages}" if self.pp_axis
              and self.n_stages > 1 else "-")
        dp = "+".join(self.dp_axes) + f":{self.dp_size}" if self.dp_axes \
            else "-"
        line = (f"  sharding: mesh={{{self.mesh.describe()}}} dp={dp} "
                f"tp={tp} pp={pp} "
                f"params[tp={c['tp']} fsdp={c['fsdp']} repl={c['repl']}]")
        if self.n_stages > 1:
            per = len(self.stage_of_layer) // self.n_stages
            line += f" stages={self.n_stages}x{per}L"
        return line


# ---------------------------------------------------------------------------
# DSE dimensions: mesh factorizations + viability (uneven-shard rejection)
# ---------------------------------------------------------------------------

def enumerate_mesh_splits(devices: int, *, dp_axis: str = "data",
                          tp_axis: Optional[str] = "model",
                          pp_axis: Optional[str] = None,
                          ) -> Tuple[Tuple[Tuple[str, int], ...], ...]:
    """All dp/tp(/pp) factorizations of ``devices`` over the flow's own axis
    names, deterministic order: pure data parallelism (the default) first,
    then decreasing dp.  The tp/pp dimensions are enumerated only when the
    flow names those axes."""
    out: List[Tuple[Tuple[str, int], ...]] = []
    pps = [p for p in range(1, devices + 1) if devices % p == 0] \
        if pp_axis else [1]
    for pp in pps:
        rest = devices // pp
        dps = sorted((d for d in range(1, rest + 1) if rest % d == 0),
                     reverse=True) if tp_axis else [rest]
        for dp in dps:
            split: Tuple[Tuple[str, int], ...] = ()
            if pp > 1:
                split += ((pp_axis, pp),)
            split += ((dp_axis, dp),)
            if tp_axis:
                split += ((tp_axis, rest // dp),)
            out.append(split)
    return tuple(out)


def split_roles(flow, split: Tuple[Tuple[str, int], ...]
                ) -> Tuple[Tuple[str, ...], Optional[str], Optional[str]]:
    """(dp_axes, tp_axis, pp_axis) of a mesh split under the flow's axis-role
    convention.  A size-1 tp/pp axis degenerates to None; every other axis
    carries data parallelism (matching the launcher's historical wiring)."""
    sizes = dict(split)
    tp = flow.tp_axis if sizes.get(flow.tp_axis, 0) > 1 else None
    pp = flow.pp_axis if sizes.get(flow.pp_axis, 0) > 1 else None
    dp = tuple(a for a, _ in split if a not in (tp, pp))
    return dp, tp, pp


def split_rejection_reason(cfg, shape, flow,
                           split: Tuple[Tuple[str, int], ...]
                           ) -> Optional[str]:
    """Divisibility screen (the paper's rule 2, across devices): returns the
    rejection reason (truthy => reject), or None when the split yields even
    shards.  Used by the explorer to prune *searched* candidates before
    estimator scoring; pinned meshes bypass it.

    The rule itself lives in :mod:`repro_torch.analysis.rules` (shared with the
    static verifier's M401/M402/M403 diagnostics); this is the
    string-returning legacy surface."""
    from repro_torch.analysis.rules import mesh_split_rejection
    hit = mesh_split_rejection(cfg, shape, flow, split)
    return hit[1] if hit is not None else None


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

class ShardingPass(Pass):
    name = "sharding"
    paper = "partitioning (§IV-J factors across the mesh)"
    reads = ("graph", "units")
    writes = ("sharding",)

    def _split_for(self, ctx: PlanContext
                   ) -> Optional[Tuple[Tuple[str, int], ...]]:
        if ctx.flow.mesh_split is not None:
            return ctx.flow.mesh_split
        if ctx.rules is not None:           # legacy path: rules built first
            m = ctx.rules.mesh
            return tuple((a, int(m.shape[a])) for a in m.axis_names)
        return None

    def run(self, ctx: PlanContext) -> None:
        split = self._split_for(ctx)
        if split is None:
            ctx.stats[self.name] = {"applied": False}
            return
        spec = MeshSpec.of(split)
        dp_axes, tp_axis, pp_axis = split_roles(ctx.flow, split)
        axis_sizes = spec.shape
        graph, units = ctx.graph, ctx.artifacts["units"]

        # key format is lowering's param-pytree layout: "<unit key>/<leaf>"
        # with folded leaves "<j>:<name>" (see lowering.param_shapes)
        from repro_torch.core.lowering import unit_key
        param_specs: Dict[str, P] = {}
        for unit in units:
            ukey = unit_key(graph, unit)
            if not unit.folded:
                b = graph.blocks[unit.indices[0]]
                for s in b.param_specs():
                    param_specs[f"{ukey}/{s.name}"] = solve_param_pspec(
                        s.roles, s.shape, dp_axes, tp_axis, axis_sizes)
            else:
                for j in range(unit.period):
                    proto = graph.blocks[unit.indices[j]]
                    for s in proto.param_specs():
                        param_specs[f"{ukey}/{j}:{s.name}"] = \
                            solve_param_pspec(
                                ("layers",) + s.roles,
                                (unit.reps,) + s.shape,
                                dp_axes, tp_axis, axis_sizes)

        # pipeline-stage assignment: contiguous equal runs of the single
        # folded layer group over the pp axis (the GPipe layout
        # distributed/pipeline_parallel.py executes)
        n_stages, stage_of_layer = 1, ()
        note = None
        if pp_axis is not None:
            folded = [u for u in units if u.folded]
            pp = axis_sizes[pp_axis]
            if len(folded) == 1 and folded[0].reps % pp == 0:
                reps = folded[0].reps
                n_stages = pp
                per = reps // pp
                stage_of_layer = tuple(r // per for r in range(reps))
            else:
                note = "pp_unassigned: needs one folded group with reps % pp == 0"
                pp_axis = None

        sp = ShardingPlan(mesh=spec, dp_axes=dp_axes, tp_axis=tp_axis,
                          pp_axis=pp_axis, param_specs=param_specs,
                          n_stages=n_stages, stage_of_layer=stage_of_layer)
        ctx.artifacts["sharding"] = sp
        counts = sp.spec_counts()
        st: Dict[str, Any] = {
            "applied": True,
            "mesh": spec.describe(),
            "dp": sp.dp_size, "tp": sp.tp_size, "pp": sp.n_stages,
            "params_tp": counts["tp"], "params_fsdp": counts["fsdp"],
            "params_repl": counts["repl"],
        }
        if note:
            st["note"] = note
        ctx.stats[self.name] = st

    def tunable_space(self, cfg, flow, shape):
        # an explicit mesh (compile(mesh=...)) is a user constraint — pinned,
        # like a pinned kernel backend.  Otherwise the pass exposes every
        # dp/tp/pp factorization of the explorer's device count.
        if flow.mesh_split is not None:
            return {"mesh_split": (flow.mesh_split,)}
        n = flow.tuning.mesh_devices
        if n and n > 1:
            return {"mesh_split": enumerate_mesh_splits(
                n, dp_axis=flow.dp_axes[0] if flow.dp_axes else "data",
                tp_axis=flow.tp_axis, pp_axis=flow.pp_axis)}
        return {}
