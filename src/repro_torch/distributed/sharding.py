"""Runtime binding of the plan's sharding decisions to a torch DeviceMesh.

The *solver* (role -> mesh-axis assignment with divisibility checks) lives
in :mod:`repro_torch.core.passes.sharding` — partitioning is a compilation
decision the ``ShardingPass`` records on the ``ExecutionPlan``
(``plan.sharding``).  ``ShardingRules`` here turns those decisions into
DTensor placements on a live mesh: when the plan carries a ``ShardingPlan``
whose factorization matches the mesh, the recorded per-param
``PartitionSpec``s are used verbatim; otherwise (legacy plans, ad-hoc
meshes) the same solver is run on the fly, so both paths make identical
decisions.

Storage is sharded (``DTensor``: a rank holds only its chunk at rest);
compute runs on local tensors with explicit collectives
(:mod:`repro_torch.distributed.collectives`): the lowering gathers a
dp-sharded parameter at its use (FSDP), keeps the tp chunk for the ops that
compute on it (the products, the unembed, the MoE experts) and gathers it
for the rest.  Activations run in one canonical layout — the batch split
over the dp axes, whole over tp — and :meth:`ShardingRules.constrain_act`
cuts a tp-sharded dim to this rank's chunk where an op computes on the
chunk (attention's query sequence, the decode caches' length).  A
``PartitionSpec`` entry naming axis *a* on dim *i* is ``Shard(i)`` on mesh
dim *a*; a tuple of dp axes is ``Shard(i)`` on each of them, in mesh order;
every other mesh dim is ``Replicate()``.

The rules also work on a ``MeshSpec`` (names and sizes, no ranks): the
placements and specs are pure, only the runtime helpers need a live mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.graph import ParamSpec
from repro_torch.core.passes.sharding import (  # noqa: F401  (re-exported: the
    ACT_ROLE_AXES, FSDP_ROLES, P, TP_ROLES,  # tables' historical home is here)
    solve_act_pspec, solve_param_pspec)
from repro_torch.distributed import collectives as col
from repro_torch.distributed.meshspec import MeshSpec


def local_of(x):
    """A DTensor's local chunk (its own storage, so in-place writes land in
    the DTensor), or ``x`` itself."""
    return x._local_tensor if isinstance(x, DTensor) else x


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements_of(spec, names: Tuple[str, ...]) -> tuple:
    """The DTensor placements (one per mesh dim ``names``) of a
    PartitionSpec: ``Shard(i)`` where dim i's entry names the axis, else
    ``Replicate()``.  A tuple entry must list its axes in mesh order (the
    first is the major split, as DTensor orders its shards)."""
    out = []
    for name in names:
        pl = Replicate()
        for i, e in enumerate(spec):
            if name in _entry_axes(e):
                pl = Shard(i)
        out.append(pl)
    for e in spec:
        ax = _entry_axes(e)
        if list(ax) != sorted(ax, key=names.index):
            raise ValueError(f"spec entry {e!r} is not in mesh order {names}")
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a PartitionSpec (the JAX ``NamedSharding``), with the
    DTensor placements they mean."""
    mesh: Any
    spec: P

    @cached_property
    def placements(self) -> tuple:
        return placements_of(self.spec, MeshSpec.of(self.mesh).names)


@dataclass
class ShardingRules:
    mesh: Any                                   # DeviceMesh or MeshSpec
    dp: Tuple[str, ...] = ("data",)
    tp: Optional[str] = "model"
    spec: MeshSpec = field(init=False, repr=False)

    def __post_init__(self):
        self.spec = MeshSpec.of(self.mesh)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= self.spec.axis_size(a)
        return n

    @property
    def tp_size(self) -> int:
        return self.spec.axis_size(self.tp) if self.tp else 1

    @property
    def _axis_sizes(self) -> Dict[str, int]:
        return self.spec.shape

    # -- parameters ---------------------------------------------------------
    def param_pspec(self, spec: ParamSpec, shape: Tuple[int, ...],
                    stacked: bool) -> P:
        roles = (("layers",) + spec.roles) if stacked else spec.roles
        return solve_param_pspec(roles, shape, self.dp, self.tp,
                                 self._axis_sizes)

    def param_sharding(self, spec: ParamSpec, shape: Tuple[int, ...],
                       stacked: bool) -> NamedSharding:
        return NamedSharding(self.mesh, self.param_pspec(spec, shape, stacked))

    def param_placements(self, spec: ParamSpec, shape: Tuple[int, ...],
                         stacked: bool) -> tuple:
        return self.param_sharding(spec, shape, stacked).placements

    # -- activations --------------------------------------------------------
    def act_pspec(self, roles: Tuple[str, ...],
                  shape: Tuple[int, ...]) -> P:
        return solve_act_pspec(roles, shape, self.dp, self.tp,
                               self._axis_sizes)

    def act_tp_dims(self, x: torch.Tensor, roles) -> List[int]:
        """The dims of canonical ``x`` (batch local, the rest whole) that
        the solved spec puts on tp (the batch dim is dp's alone, so its
        local size decides nothing here)."""
        if not self.tp or self.tp_size == 1:
            return []
        if len(roles) != x.ndim:
            roles = tuple(roles[: x.ndim]) + ("none",) * (x.ndim - len(roles))
        ps = self.act_pspec(tuple(roles), tuple(x.shape))
        return [i for i, e in enumerate(ps) if self.tp in _entry_axes(e)]

    def constrain_act(self, x: torch.Tensor, roles) -> torch.Tensor:
        """``x`` in the canonical layout (batch local over dp, the rest
        whole) -> this rank's chunk of every dim the solved spec puts on
        tp (backward: the all-gather).  The dp entries hold by
        construction: every activation's batch is the rank's rows."""
        for i in self.act_tp_dims(x, roles):
            x = col.split(x, i, self.tp_group)
        return x

    def gather_act(self, x: torch.Tensor, dims: List[int]) -> torch.Tensor:
        """The inverse of :meth:`constrain_act` over the ``dims`` it cut
        (:meth:`act_tp_dims` of the canonical tensor): all-gather over tp
        (backward: this rank's chunk)."""
        for i in dims:
            x = col.gather(x, i, self.tp_group)
        return x

    # -- whole-tree helpers ---------------------------------------------------
    def _plan_specs(self, plan) -> Optional[Dict[str, P]]:
        """The ShardingPass's recorded per-param specs, when they were solved
        for this mesh's factorization (else None -> solve on the fly)."""
        sp = getattr(plan, "sharding", None)
        if sp is None or not sp.param_specs:
            return None
        if dict(sp.mesh.axes) != self._axis_sizes:
            return None                     # plan solved for another mesh
        return sp.param_specs

    def params_shardings(self, plan) -> Dict[str, Any]:
        """Sharding tree matching the params tree of ``plan`` — read from
        the plan's recorded ShardingPlan when available."""
        from repro_torch.core.lowering import param_shapes, param_specs_tree
        shapes = param_shapes(plan)
        specs = param_specs_tree(plan)
        recorded = self._plan_specs(plan) or {}

        def one(top, leaf):
            ps = recorded.get(f"{top}/{leaf}")
            if ps is None:                 # not recorded: solve on the fly
                sv, sh = specs[top][leaf], shapes[top][leaf]
                ps = self.param_pspec(sv[0], tuple(sh.shape), sv[1])
            return NamedSharding(self.mesh, ps)

        return {top: {leaf: one(top, leaf) for leaf in leaves}
                for top, leaves in shapes.items()}

    def batch_is_split(self, B: int) -> bool:
        """Whether a global batch of ``B`` rows splits over dp (else every
        dp rank runs all of it, as the solver replicates it)."""
        return B % self.dp_size == 0

    def batch_sharding(self, batch_shapes: Dict[str, Any]) -> Dict[str, Any]:
        """The placement of each global batch leaf: rows over dp when they
        split (:meth:`batch_is_split`), else replicated; the rows that
        :meth:`local_batch` hands this rank."""
        ent = self.dp if len(self.dp) > 1 else self.dp[0]
        return {k: NamedSharding(self.mesh, P(
                    ent if self.batch_is_split(v.shape[0]) else None))
                for k, v in batch_shapes.items()}

    def state_sharding(self, plan, batch_size: int) -> Any:
        """The serving state's placements, the tree of
        :func:`repro_torch.core.lowering.state_shardings` (each leaf placed
        by the roles of its op: batch over dp, a cache's length over
        tp)."""
        from repro_torch.core.lowering import state_shardings
        return state_shardings(plan, batch_size, self)

    # -- the live mesh ------------------------------------------------------
    def group(self, axis: str):
        """The process group of one mesh axis (None on a one-rank axis)."""
        if self.spec.axis_size(axis) == 1:
            return None
        return self.mesh.get_group(mesh_dim=axis)

    @property
    def tp_group(self):
        return self.group(self.tp) if self.tp else None

    @property
    def dp_groups(self) -> List[Any]:
        return [self.group(a) for a in self.dp]

    @property
    def tp_rank(self) -> int:
        return col.group_rank(self.tp_group)

    def tp_dim(self, placements) -> Optional[int]:
        """The tensor dim ``placements`` split over a tp axis of more than
        one rank (None when whole over tp)."""
        if not self.tp or self.tp_size == 1:
            return None
        p = placements[self.spec.names.index(self.tp)]
        return p.dim if isinstance(p, Shard) else None

    def local_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor (all rows when the
        batch does not split over dp)."""
        if not self.batch_is_split(x.shape[0]):
            return x
        return col.split_over(x, 0, self.dp_groups)

    def local_slices(self, shape, placements) -> Tuple[slice, ...]:
        """This rank's index range of each dim of a tensor of ``shape``
        under ``placements`` (``torch.chunk``'s split, nested over the mesh
        dims in mesh order, as DTensor cuts it)."""
        idx = [range(n) for n in shape]     # host ints: no tensor is made
        for name, pl in zip(self.spec.names, placements):
            if isinstance(pl, Shard):
                g = self.group(name)
                n, r = col.group_size(g), col.group_rank(g)
                size = -(-len(idx[pl.dim]) // n)
                idx[pl.dim] = idx[pl.dim][r * size:(r + 1) * size]
        return tuple(slice(i.start, i.stop) if len(i) else slice(0, 0)
                     for i in idx)

    def local_shape(self, shape, placements) -> Tuple[int, ...]:
        """The shape of this rank's chunk (:meth:`local_slices`)."""
        return tuple(len(range(n)[c]) for n, c in
                     zip(shape, self.local_slices(shape, placements)))

    def local_chunk(self, full: torch.Tensor, placements) -> torch.Tensor:
        """This rank's chunk of a whole tensor under ``placements`` (a
        view of ``full``)."""
        return full[self.local_slices(full.shape, placements)]

    def place(self, full: torch.Tensor, sharding, device=None,
              dtype=None) -> DTensor:
        """A DTensor holding this rank's chunk of ``full`` under
        ``sharding.placements`` (a :class:`NamedSharding`'s, or a
        DTensor's).  The chunk is cut where ``full`` lies (the host, for a
        leaf read or drawn there) and only the chunk moves to ``device``
        and ``dtype`` (``full``'s by default); it is a copy when it is not
        all of ``full``, so the whole tensor can go."""
        pl = sharding.placements
        local = self.local_chunk(full, pl)
        out = local.to(device=device or full.device,
                       dtype=dtype or full.dtype).contiguous()
        if local.numel() != full.numel() and \
                out.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr():
            out = out.contiguous().clone()
        return self.wrap(out, pl, full.shape)

    def wrap(self, local: torch.Tensor, placements, shape) -> DTensor:
        """A DTensor over this rank's ``local`` chunk of a tensor of the
        global ``shape`` (contiguous strides)."""
        shape = tuple(shape)
        stride = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            stride[i] = stride[i + 1] * shape[i + 1]
        return DTensor.from_local(local, self.mesh, tuple(placements),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))

    def distribute(self, tree, shardings, device=None) -> Any:
        """A tree of whole tensors -> the same tree of DTensors, each rank
        keeping its chunk (moved to ``device`` when one is given)."""
        if isinstance(tree, dict):
            return {k: self.distribute(v, shardings[k], device)
                    for k, v in tree.items()}
        return self.place(tree, shardings, device)

    def materialize(self, x, sharding: NamedSharding
                    ) -> Tuple[torch.Tensor, Optional[int]]:
        """A parameter's compute view on this rank: its local chunk
        (``x`` a DTensor, or the local tensor itself) all-gathered over the
        dp axes it is sharded on (the FSDP gather, whose backward
        reduce-scatters), its tp chunk kept.  Returns the view and the dim
        split over tp (None when whole)."""
        local = local_of(x)
        pl = sharding.placements
        names = self.spec.names
        for name, p in reversed(list(zip(names, pl))):
            if name in self.dp and isinstance(p, Shard):
                local = col.fsdp_gather(local, p.dim, self.group(name))
        return local, self.tp_dim(pl)

    @torch.no_grad()
    def reduce_grads(self, grads, shardings):
        """Sum each local gradient over the dp axes its parameter is
        replicated on (a dp-sharded parameter's was summed by its FSDP
        gather's backward): the dp mean of the train step, each rank's
        part of the loss already carrying its 1/global-count."""
        if isinstance(grads, dict):
            return {k: self.reduce_grads(v, shardings[k])
                    for k, v in grads.items()}
        names = self.spec.names
        groups = [self.group(n) for n, p in zip(names, shardings.placements)
                  if n in self.dp and not isinstance(p, Shard)]
        return col.all_reduce_(grads.contiguous(), groups)


def _shard_key(x) -> Optional[tuple]:
    """(mesh, the names of the mesh dims of more than one rank a DTensor is
    sharded on), or None where each rank holds every element (a plain
    tensor, a replicated DTensor, any DTensor on a one-rank mesh)."""
    if not isinstance(x, DTensor):
        return None
    spec = MeshSpec.of(x.device_mesh)
    sharded = tuple(n for n, p in zip(spec.names, x.placements)
                    if isinstance(p, Shard) and spec.axis_size(n) > 1)
    return (x.device_mesh, sharded) if sharded else None


def _reduce_over(t: torch.Tensor, key: tuple, op=None) -> torch.Tensor:
    mesh, axes = key
    return col.all_reduce_(t, [mesh.get_group(mesh_dim=a) for a in axes],
                           op)


def global_sq_sum(leaves) -> torch.Tensor:
    """Sum of squares over every element of the leaves, DTensor or not: a
    DTensor's local sums are all-reduced over the mesh dims it is sharded
    on (each element counted once), leaves grouped by those dims so a
    group costs one all-reduce an axis."""
    total = None
    groups: Dict[Any, torch.Tensor] = {}
    for x in leaves:
        s = torch.sum(torch.square(local_of(x).float()))
        key = _shard_key(x)
        if key is None:
            total = s if total is None else total + s
        else:
            groups[key] = groups[key] + s if key in groups else s
    for key, s in groups.items():
        s = _reduce_over(s.clone(), key)
        total = s if total is None else total + s
    return total


def global_amax(leaves) -> List[torch.Tensor]:
    """The largest ``|x|`` of each leaf over all its elements, DTensor or
    not (0-d tensors, one a leaf): a DTensor's local maxima are all-reduced
    with MAX over the mesh dims it is sharded on, the leaves grouped by
    those dims so a group costs one all-reduce an axis.  Nothing is
    gathered."""
    import torch.distributed as dist
    out = []
    groups: Dict[Any, List[int]] = {}
    for i, x in enumerate(leaves):
        loc = local_of(x)
        out.append(loc.abs().amax() if loc.numel() else
                   torch.zeros((), dtype=loc.dtype, device=loc.device))
        key = _shard_key(x)
        if key is not None:
            groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        m = _reduce_over(torch.stack([out[i] for i in idx]), key,
                         dist.ReduceOp.MAX)
        for j, i in enumerate(idx):
            out[i] = m[j]
    return out


@torch.no_grad()
def full_tensor(x):
    """A DTensor gathered whole on every rank (the chunks all-gathered over
    each mesh dim it is sharded on, the innermost first); a plain tensor
    as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    spec = MeshSpec.of(mesh)
    local = x._local_tensor
    for name, pl in reversed(list(zip(spec.names, x.placements))):
        if isinstance(pl, Shard) and spec.axis_size(name) > 1:
            local = col._all_gather(local, pl.dim,
                                    mesh.get_group(mesh_dim=name))
    return local
