"""Process groups and device meshes of the port.

Port of ``repro/launch/mesh.py``. A JAX mesh spans the devices one
controller sees; here every device is driven by a process of its own
(``torch.distributed``, one rank a device), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks with dims
``("data", "model")``, or ``("pod", "data", "model")`` (:func:`mesh_ctx`
gives the trainer's ``ShardCtx``; the engine takes either mesh).
Functions only: importing this module touches no device and no process
group.

The caller names the backend, which is never picked by trying one:
``"nccl"`` on CUDA (one rank a card, ``cuda:<local rank>``) or ``"gloo"``
on the CPU (or for CUDA tensors of several ranks on one card, which NCCL
refuses; :mod:`repro_torch.distributed.collectives` stages what gloo
cannot move). Under ``torchrun`` the rank, world size and address come
from the environment; otherwise pass them (``init_method=
"tcp://localhost:<port>"`` or a ``store``).
"""
from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config import MeshConfig
from repro_torch.distributed.sharding import ShardCtx, shard_ctx

BACKENDS = ("nccl", "gloo")


def init_process_group(backend: str, rank: Optional[int] = None,
                       world_size: Optional[int] = None, init_method: Optional[str] = None,
                       store: Any = None, device: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    ``rank`` / ``world_size`` default to the ``RANK`` / ``WORLD_SIZE`` of
    the environment (``torchrun``), ``init_method`` to ``env://`` when no
    ``store`` is given. ``nccl`` binds the rank to ``cuda:<LOCAL_RANK>``
    (``LOCAL_RANK``, else the rank); ``gloo`` runs on the CPU unless
    ``device`` names another."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (want one of {BACKENDS})")
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device or "cpu")
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size)
    return dev


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call repro_torch.launch.mesh.init_process_group "
                           "(naming its backend) before building a mesh")
    return dist.get_world_size()


def make_mesh(cfg: MeshConfig) -> DeviceMesh:
    """The mesh of an explicit :class:`MeshConfig` over every rank of the
    default group, ranks laid out row-major (rank = data · model_size +
    model index on the two-axis mesh; ``("pod", "data", "model")`` when
    ``cfg.pod > 1``, the data-parallel ranks then pod × data). A mesh has
    axes only: :func:`mesh_ctx` adds ``cfg.fsdp``. ``cfg.pp_stages > 0``
    raises: pipeline stages over the pod axis train nowhere, in JAX either
    (``distributed.pipeline`` is the forward schedule alone)."""
    if cfg.pp_stages > 0:
        raise NotImplementedError(
            f"pp_stages={cfg.pp_stages}: no trainer runs pipeline stages over the pod axis (the "
            "JAX launch/train.py never reads it); repro_torch.distributed.pipeline."
            "pipeline_forward is the forward schedule")
    n = _world()
    if cfg.n_devices != n:
        raise ValueError(f"mesh {cfg.shape} needs {cfg.n_devices} ranks, the group has {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(cfg.shape),
                      mesh_dim_names=cfg.axis_names)


def mesh_ctx(cfg: MeshConfig) -> ShardCtx:
    """The training context of ``cfg``: :func:`make_mesh`'s mesh with the
    batch over its ("pod", "data") axes, "model" tensor parallel and
    ``cfg.fsdp`` (``sharding.shard_ctx``)."""
    return shard_ctx(make_mesh(cfg), fsdp=cfg.fsdp)


def auto_mesh(model_axis: int = 1, pod: int = 1) -> DeviceMesh:
    """A ("data", "model") mesh over every rank, or ("pod", "data",
    "model") with ``pod`` > 1: data takes what the model and pod axes do
    not. On one rank it is (1, 1) and drives the same code path as a
    larger mesh."""
    n = _world()
    if model_axis < 1 or pod < 1 or n % (model_axis * pod) != 0:
        raise ValueError(f"model_axis {model_axis} x pod {pod} must divide device count {n}")
    return make_mesh(MeshConfig(pod=pod, data=n // (model_axis * pod), model=model_axis))


def describe_mesh(mesh: DeviceMesh) -> str:
    """One-line topology summary for launcher logs."""
    dims = " x ".join(f"{k}={v}" for k, v in zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return f"{dims} ({mesh.mesh.numel()} ranks, {dist.get_backend()}, {mesh.device_type})"
