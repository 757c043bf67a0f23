"""Meshes of the port. FUNCTIONS (not module-level constants), so importing
this module starts no process group.

The production meshes keep the reference's shapes and axis names. A run on
real ranks starts its process group first (``torch.distributed`` with
``nccl`` or ``gloo``); the dry-run starts a ``"fake"`` process group of 256
or 512 ranks, which moves no data, and traces rank 0's local program.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 (data, model) single pod; 2x16x16 (pod, data, model) for the
    two-pod deployment. Needs an initialised process group of 256 / 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cpu", *, model: int = 1):
    """The ranks that exist, as a (data, model) mesh with ``model`` ranks on
    the model axis (1: a 1D data-parallel layout, as the reference's)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not divide into a model axis of {model}")
    return init_device_mesh(device_type, (n // model, model), mesh_dim_names=("data", "model"))
