"""Mesh construction for the production pods and local runs — the port of
``repro/launch/mesh.py`` over ``torch.distributed.device_mesh``.

Functions, not module-level constants: importing this module touches no
process-group state.  A ``DeviceMesh`` needs a process group of its size, so
the production meshes (256 and 512 ranks) exist only where that many ranks
run; the dry-run reads their axis sizes alone (``production_shape``), and
every function here that reads a mesh's axis sizes goes through
``nn.module.mesh_shape``, which takes a ``DeviceMesh`` or anything with a
``.shape`` mapping (``MeshShape``).
"""

from __future__ import annotations

from typing import Any

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.nn.module import MeshShape, mesh_shape


def _mk(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the default process group's ranks,
    its dims named ``axes`` (rank r sits at the row-major position r)."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axis sizes: 16x16 ``(data, model)`` or
    2x16x16 ``(pod, data, model)``."""
    if multi_pod:
        return MeshShape(pod=2, data=16, model=16)
    return MeshShape(data=16, model=16)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 dual-pod (512 ranks) mesh.

    Axes: ``data`` (+ ``pod``) carry data parallelism; ``model`` carries
    tensor/expert parallelism.  Needs a process group of that world size;
    the dry-run uses ``production_shape`` instead.
    """
    shape = production_shape(multi_pod=multi_pod).shape
    return _mk(tuple(shape.values()), tuple(shape), device_type)


def make_local_mesh(n_model: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """``(data, model)`` mesh over the default process group's ranks."""
    n = dist.get_world_size()
    if n % n_model:
        raise ValueError(f"{n} ranks not divisible by model={n_model}")
    return _mk((n // n_model, n_model), ("data", "model"), device_type)


def dp_axis_names(mesh: Any) -> tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def dp_size(mesh: Any) -> int:
    shape = mesh_shape(mesh)
    out = 1
    for a in dp_axis_names(mesh):
        out *= shape[a]
    return out
