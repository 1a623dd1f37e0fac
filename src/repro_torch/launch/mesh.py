"""Device meshes of the port: torch ``DeviceMesh``es over the ranks of
the default process group.

Functions, not module-level constants, so importing this module never
touches device or process-group state.  ``make_debug_mesh`` starts a
one-process group itself when none exists, from an in-process
``HashStore``: it opens no port and reads no ``MASTER_ADDR`` or
``MASTER_PORT``, so any number of test processes can each hold one.

``fake_group`` opens the dry run's stand-in for a job of 256 or 512
cards: a default group over the ``fake`` backend, in which this process
is rank 0 and every collective returns at once without moving data.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device


def _ensure_group(device: torch.device) -> None:
    """A default process group that serves ``device``: a one-process
    group (``gloo`` for the CPU, with ``nccl`` for the card) when none
    exists yet."""
    if not dist.is_initialized():
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif device.type == "cuda" and "nccl" not in dist.get_backend():
        raise RuntimeError(
            f"the default process group's backend is "
            f"{dist.get_backend()!r}, which has no nccl for a mesh on the "
            f"card: destroy it first")


def device_count() -> int:
    """Cards in the job: the default process group's world size (one
    process per card), or the cards this process sees when no group
    exists."""
    return (dist.get_world_size() if dist.is_initialized()
            else torch.cuda.device_count())


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks over the ``fake``
    backend for the body of the ``with``, destroyed on exit.  This
    process is rank 0; collectives complete at once and move nothing, so
    it serves tracing only.  Raises if a default group exists."""
    if dist.is_initialized():
        raise RuntimeError(
            f"a default process group of world size "
            f"{dist.get_world_size()} exists: destroy it before opening a "
            f"fake one")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The production mesh over the ranks of the default process group:
    (16, 16) over ("data", "model"), or (2, 16, 16) with "pod", of the
    card's device type unless ``device`` names another."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    found = device_count()
    if found < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {found}; start one "
            f"process per card with torch.distributed before building it")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device: DeviceLike = None) -> DeviceMesh:
    """Small mesh over the default process group's ranks (tests), on the
    card unless ``device`` names another."""
    device = resolve_device(device)
    _ensure_group(device)
    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs {n} ranks; the process group has "
            f"world size {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DeviceMesh(device.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))
