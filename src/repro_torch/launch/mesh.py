"""Meshes of ranks (PyTorch port of ``repro.launch.mesh``) and the card's
data-sheet constants for the roofline terms.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, over the
ranks of the default process group; ``make_abstract_mesh`` gives the axis
names and sizes alone (no process group), which is all that rule
resolution needs. Nothing here runs at import.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import as_device


class AbstractMesh:
    """Axis names and sizes only: ``axis_names`` and ``shape`` (name →
    size), as JAX's ``AbstractMesh`` exposes them."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_abstract_mesh(shape, axes) -> AbstractMesh:
    return AbstractMesh(shape, axes)


def mesh_shape(mesh) -> dict:
    """Axis name → size of an ``AbstractMesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def ensure_process_group(device="cuda") -> None:
    """Start a one-process default group if none exists: ``nccl`` on the
    card, ``gloo`` on the CPU, rendezvous through an in-process
    ``HashStore``. A group that exists already is left as it is."""
    dev = as_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, **kw)


def _mesh(shape, axes, device) -> DeviceMesh:
    dev = as_device(device)
    ranks = torch.arange(math.prod(shape)).reshape(tuple(shape))
    return DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production geometry: ``(data=16, model=16)``, or ``(pod=2,
    data=16, model=16)`` with ``multi_pod``. Needs a default group of
    exactly that many ranks (a ``torchrun`` job, or the dry-run's fake
    group), and raises otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks; the world has {world}")
    return _mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 4, device="cuda"):
    """A small ``(data, model)`` mesh over the ranks that exist, clamped
    as the JAX package clamps it to its devices: one rank on one card.
    Starts a one-process group first if there is none."""
    ensure_process_group(device)
    n = dist.get_world_size()
    data = min(data, max(1, n // model)) if n >= model else 1
    model = min(model, n)
    return _mesh((data, model), ("data", "model"), device)


# NVIDIA H100 SXM5 80GB data sheet values (per card) for the roofline
# terms: dense bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 (900 GB/s
# both directions, 450 GB/s each way).
HW = dict(
    name="NVIDIA H100 SXM5 80GB (data sheet)",
    peak_flops_bf16=989e12,   # FLOP/s
    hbm_bw=3.35e12,           # B/s
    link_bw=450e9,            # B/s a direction
)
