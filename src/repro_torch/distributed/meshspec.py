"""MeshSpec — the device-mesh topology as a compile-time value.

The mesh used to be a hard-coded shape in ``launch/mesh.py`` and the
partitioning decisions a side effect of launch wiring; ``MeshSpec`` makes
the topology a first-class input of the compilation flow.  It is a frozen,
hashable (axis name, size) tuple, so it can live on ``FlowConfig``
(``mesh_split``), participate in DSE fingerprints, and be recorded on the
``ExecutionPlan`` — independent of any live device mesh.

``MeshSpec.of`` normalizes every accepted spelling of a mesh:

* a ``MeshSpec`` (identity),
* an axis-size dict ``{"data": 2, "model": 2}`` (insertion order kept),
* a ``(("data", 2), ("model", 2))`` tuple,
* a live ``torch.distributed.DeviceMesh`` (``mesh_dim_names`` + sizes),
* any mesh object with ``axis_names`` and a name -> size ``shape``.

``build()`` binds the spec to the ranks of the default process group
(``init_device_mesh``) — the only place a device is touched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple


@dataclass(frozen=True)
class MeshSpec:
    axes: Tuple[Tuple[str, int], ...]          # ordered (axis name, size)

    def __post_init__(self):
        names = [a for a, _ in self.axes]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate mesh axis names: {names}")
        for a, n in self.axes:
            if n < 1:
                raise ValueError(f"mesh axis {a!r} has non-positive size {n}")

    # -- constructors -------------------------------------------------------
    @classmethod
    def of(cls, mesh) -> "MeshSpec":
        """Normalize a MeshSpec | axis-size dict | (name, size) tuple |
        mesh object into a MeshSpec."""
        if isinstance(mesh, MeshSpec):
            return mesh
        if isinstance(mesh, Mapping):
            return cls(tuple((str(k), int(v)) for k, v in mesh.items()))
        if isinstance(mesh, tuple):
            return cls(tuple((str(k), int(v)) for k, v in mesh))
        dim_names = getattr(mesh, "mesh_dim_names", None)
        if dim_names is not None:                  # a torch DeviceMesh
            return cls(tuple((str(a), int(n))
                             for a, n in zip(dim_names, mesh.shape)))
        axis_names = getattr(mesh, "axis_names", None)
        shape = getattr(mesh, "shape", None)       # Mesh.shape: name -> size
        if axis_names is not None and shape is not None:
            return cls(tuple((a, int(shape[a])) for a in axis_names))
        raise TypeError(
            f"cannot interpret {type(mesh).__name__} as a mesh spec; pass a "
            "MeshSpec, an axis-size dict, a ((name, size), ...) tuple, a "
            "DeviceMesh or a mesh object")

    # -- views --------------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(n for _, n in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return dict(self.axes).get(name, 1)

    def describe(self) -> str:
        return ",".join(f"{a}:{n}" for a, n in self.axes)

    # -- device binding -----------------------------------------------------
    def build(self, device=None):
        """Bind to the ranks of the default process group:
        ``init_device_mesh(device_type, sizes, mesh_dim_names=names)``,
        made once per (device type, axes) in a process.  ``device`` is the
        entry points' (``None`` is the card).  With no group up, a
        one-rank mesh starts one (:func:`repro_torch.device.
        init_process_group`); a larger mesh needs the group started by the
        caller, and a group whose size is not the mesh's raises
        ValueError.  On the dry-run's ``fake`` group the mesh is built for
        ``device``'s type whether or not such a device is present
        (:func:`repro_torch.device.fake_group`)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.device import init_process_group, resolve_device
        dev = resolve_device(device)
        if not dist.is_initialized():
            _BUILT.clear()                 # meshes of a group now gone
            if self.size != 1:
                raise ValueError(
                    f"a mesh of {self.size} ranks needs the process group "
                    "started first (repro_torch.device.init_process_group)")
            init_process_group(1, 0, dev)
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {{{self.describe()}}} has {self.size} "
                             f"ranks but the process group has {world}")
        key = (dev.type, self.axes)
        mesh = _BUILT.get(key)
        if mesh is None:
            mesh = init_device_mesh(dev.type, self.sizes,
                                    mesh_dim_names=self.names)
            _BUILT[key] = mesh
        return mesh


#: the DeviceMeshes built in this process, by (device type, axes): building
#: one makes a process group per axis, a collective call on every rank
_BUILT: Dict[Tuple[str, Tuple[Tuple[str, int], ...]], object] = {}
