"""Mesh construction over ``torch.distributed``.

Single pod: (16, 16) = 256 ranks, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 ranks, axes ("pod", "data", "model") — the
"pod" axis carries pure data parallelism; FSDP stays inside a pod
("data"), tensor/expert parallelism inside a 16-rank ring ("model").

These are FUNCTIONS, so importing this module touches no process group:
the caller starts one (``torchrun`` sets its rendezvous; a test gives
``init_method`` itself) before building a mesh.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_mesh_compat(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``mesh_dim_names`` ``axes`` over the
    started process group, whose world size must be the mesh's size."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != size:
        raise RuntimeError(f"the production mesh {shape} needs {size} ranks; the process "
                           f"group has {world}")
    return make_mesh_compat(shape, axes, device_type)


def make_smoke_mesh(n_data: int = 2, n_model: int = 4, device_type: str = "cuda"):
    """Small mesh for integration tests (gloo on CPU ranks: ``device_type="cpu"``)."""
    return make_mesh_compat((n_data, n_model), ("data", "model"), device_type)
