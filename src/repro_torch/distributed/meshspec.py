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
* any mesh object with ``axis_names`` and a name -> size ``shape``.

Binding a spec to devices is multi-device work that the port has not taken
on yet (ROADMAP Queue 1, item 11).
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
        axis_names = getattr(mesh, "axis_names", None)
        shape = getattr(mesh, "shape", None)       # Mesh.shape: name -> size
        if axis_names is not None and shape is not None:
            return cls(tuple((a, int(shape[a])) for a in axis_names))
        raise TypeError(
            f"cannot interpret {type(mesh).__name__} as a mesh spec; pass a "
            "MeshSpec, an axis-size dict, a ((name, size), ...) tuple, or a "
            "mesh object")

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
