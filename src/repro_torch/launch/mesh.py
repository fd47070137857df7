"""Production mesh construction (port of ``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module never starts a
process group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the process group that is up.  The dry-run (and only the dry-run) brings up
PyTorch's fake process group of 256 or 512 ranks with :func:`fake_world`, the
twin of the reference's 512 placeholder host devices: collectives on it move
no data, and the dry-run's tensors live on the ``meta`` device.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def fake_world(n: int, *, rank: int | None = None) -> None:
    """Bring up a fake process group of ``n`` ranks in this process, as rank
    ``rank`` (default the last: the rank whose causal attention does the most
    work in the sequence-parallel prefill).  A group that is already up is
    replaced unless it is a fake one of the same size and rank."""
    try:  # a private module of PyTorch's test utilities: imported here only
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("this PyTorch has no fake process group "
                           "(torch.testing._internal.distributed.fake_pg); the dry-run "
                           "needs it to stand up a world of placeholder ranks") from e
    rank = n - 1 if rank is None else rank
    if dist.is_initialized():
        if (dist.get_backend() == "fake" and dist.get_world_size() == n
                and dist.get_rank() == rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16x16 = 256 ranks (single pod) or 2x16x16 = 512 ranks (two pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh_for(shape: tuple[int, ...], axes: tuple[str, ...], *,
                  device_type: str | None = None):
    """Arbitrary mesh (elastic re-plans, tests) over the first prod(shape) ranks."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str | None):
    from torch.distributed.device_mesh import DeviceMesh

    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {have}: the dry-run brings up a fake "
            f"world of that many ranks first (launch.mesh.fake_world, as launch/dryrun.py "
            f"does); a real run starts that many processes")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)
