"""Production mesh construction, as ``repro.launch.mesh``.

A FUNCTION (not a module-level constant), so importing this module starts
no process group.  The production meshes are ``DeviceMesh`` objects over
a ``"fake"`` process group of 256 or 512 ranks (this process is rank 0):
collectives return at once and nothing reaches a device, which is all the
dry-run needs.  The group is made only if none exists; a mesh takes the
group's first ranks, so a 512-rank group carries both.
"""

from __future__ import annotations

import torch.distributed as dist


def _ensure_group(world_size: int):
    """A group of at least ``world_size`` ranks: the existing one, or a
    fake one made now.  An existing group too small raises (it is the
    caller's, and meshes made on it would go stale if it were replaced)."""
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"a mesh of {world_size} needs at least that many")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _mesh(shape, axes):
    """A mesh over the first prod(shape) ranks of the group."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    _ensure_group(n)
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod mesh (256 ranks) or 2x16x16 multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_debug_mesh(data: int = 1, model: int = 1):
    """A small ("data", "model") mesh; 1x1 is the unsharded step."""
    return _mesh((data, model), ("data", "model"))
