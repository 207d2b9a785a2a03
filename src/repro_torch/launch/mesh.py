"""Production mesh construction — thin wrappers over :class:`MeshSpec`.

The topology lives in the spec constants (compile-time values the flow and
the DSE consume); only ``build()`` touches the process group, so importing
this module starts nothing.  Single pod: (16, 16) = 256 ranks, axes (data,
model).  Multi-pod: (2, 16, 16) = 512 ranks, axes (pod, data, model); the
pod axis carries either extra data parallelism (default) or the pipeline
dimension (``FlowConfig.pp_axis="pod"``: GPipe stages, activations sent
stage to stage, :mod:`repro_torch.distributed.pipeline_parallel`).
"""
from __future__ import annotations

from repro_torch.distributed.meshspec import MeshSpec

PRODUCTION_SPEC = MeshSpec((("data", 16), ("model", 16)))
MULTI_POD_SPEC = MeshSpec((("pod", 2), ("data", 16), ("model", 16)))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production DeviceMesh; the process group must have 256 (512 with
    ``multi_pod``) ranks."""
    return (MULTI_POD_SPEC if multi_pod else PRODUCTION_SPEC).build(device)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None):
    """A small mesh for multi-rank tests (the process group started with
    ``prod(shape)`` ranks, gloo on the CPU)."""
    return MeshSpec(tuple(zip(axes, shape))).build(device)
