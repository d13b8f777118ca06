"""Mesh construction.

Functions, not module-level constants: importing this module touches
no device and no process group.

  make_production_mesh  (16, 16) data x model, or (2, 16, 16) pod x
                        data x model, over an initialised world of
                        that size;
  make_host_mesh        the initialised world (one rank made on the
                        spot when there is none) as (world, 1);
  make_placement_mesh   an ``AbstractMesh``: shape only.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import AbstractMesh
from repro_torch.kernels.common import resolve_device


def _device_mesh(dev: torch.device, shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model) — DP
    across pods, FSDP within a pod, TP/EP on model.  Needs an
    initialised process group of exactly that many ranks; runs on CUDA
    unless ``device`` names the CPU."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(f"the production mesh {shape} needs an "
                           f"initialised world of {n} ranks, found {world}")
    return _device_mesh(resolve_device(device), shape, axes)


def make_host_mesh(device=None):
    """The initialised world laid out as a (world, 1) (data, model)
    mesh on ``device`` (CUDA unless the caller names the CPU).  With no
    process group, a one-rank group is made on the spot through a
    ``HashStore`` (NCCL on CUDA, gloo on the CPU; no TCP port): the
    caller owns it and ends it with ``dist.destroy_process_group()``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return _device_mesh(dev, (dist.get_world_size(), 1), ("data", "model"))


def make_placement_mesh(n_hosts: int, *, model: int = 1) -> AbstractMesh:
    """An abstract (data, model) mesh describing an ``n_hosts``-wide
    data axis *without touching any device or process group* — the
    serving runtime's ``PlacementMap.from_mesh`` reads shard residency
    off it, so a simulated multi-host topology and a real deployment
    configure placement the same way."""
    return AbstractMesh((int(n_hosts), int(model)), ("data", "model"))
