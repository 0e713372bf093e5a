"""Logical-axis sharding annotations, as ``repro.sharding.annotations``.

Model code annotates intermediates with *logical* axis names
(``shard(q, "batch", "seq", None)``); the launcher binds logical names to
physical mesh axes with :func:`axis_rules`.  Outside any binding (every
training and serving path of the port) an annotation returns its input
and costs one Python call.

A spec is the JAX package's ``PartitionSpec`` as a plain tuple, one entry
a tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
names.  :func:`spec_to_placements` turns it into ``DTensor`` placements on
a ``DeviceMesh`` (one placement a mesh dim).  Inside a binding,
:func:`shard` redistributes a ``DTensor`` to those placements; a plain
tensor passes through.

Logical axes used across the framework:

    batch    — data-parallel batch                -> ("pod","data") / ("data",)
    seq      — attention-query sequence (SP)      -> ("model",) when enabled
    heads    — attention q-head axis              -> ("model",)
    kv_heads — attention kv-head axis             -> ("model",) when divisible
    kv_seq   — decode KV-cache sequence axis      -> ("model",) (split-KV)
    ff       — MLP hidden                          -> ("model",)
    expert   — MoE expert axis (EP)               -> ("model",)
    vocab    — embedding/vocab axis               -> ("model",)
    embed    — d_model axis of weights (FSDP)     -> ("data",) under fsdp_tp
    clients  — federated client axis              -> ("pod","data") / ("data",)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: dict, mesh):
    """Bind logical axis names to physical mesh axes within the context."""
    prev_r, prev_m = _rules(), current_mesh()
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev_r, prev_m


def logical_to_spec(*axes) -> tuple:
    """Translate logical axis names to a spec under the current rules."""
    rules = _rules() or {}
    parts = []
    for ax in axes:
        phys = rules.get(ax) if ax is not None else None
        if not phys:
            parts.append(None)
        elif len(phys) == 1:
            parts.append(phys[0])
        else:
            parts.append(tuple(phys))
    return tuple(parts)


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or of anything with
    ``axis_names`` and ``devices.shape`` (a JAX ``Mesh``, a test stand-in)."""
    if hasattr(mesh, "axis_names"):
        return dict(zip(mesh.axis_names, mesh.devices.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_axis_names(mesh) -> tuple:
    return tuple(mesh_axis_sizes(mesh))


def spec_to_placements(spec, mesh) -> list:
    """``DTensor`` placements (one a mesh dim) of a spec: a tensor dim
    sharded over several mesh axes takes ``Shard(d)`` on each of them, in
    mesh order; a mesh axis no dim names replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dims of {spec}")
            out[i] = Shard(d)
    return out


def shard(x, *axes):
    """Redistribute a ``DTensor`` to the logical axes' placements when a
    mesh binding is active; otherwise (or for a plain tensor) return ``x``.

    ``axes`` are logical names (or None) for each tensor dimension.
    """
    mesh = getattr(_state, "mesh", None)
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or _rules() is None:
        return x
    # redistributed even when the placements already match: the backward
    # then moves the gradient to them too, as a JAX sharding constraint
    # constrains the cotangent
    return x.redistribute(mesh, spec_to_placements(logical_to_spec(*axes),
                                                   mesh))


def write_at(buf, dim: int, index: int, value):
    """``buf.select(dim, index).copy_(value)`` in place.  For a ``DTensor``
    ``buf`` whose ``dim`` is sharded, the write is the rank's own: the rank
    whose shard holds ``index`` copies its slice of ``value`` there and
    every other rank writes nothing, as a sharded dynamic-update-slice does
    (``DTensor`` would gather the whole dim to write one position)."""
    if not hasattr(buf, "placements"):
        buf.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = buf.device_mesh
    shape, offset = compute_local_shape_and_global_offset(
        buf.shape, mesh, buf.placements)
    lo = offset[dim]
    if not lo <= index < lo + shape[dim]:
        return
    placements = []
    for pl in buf.placements:
        if isinstance(pl, Shard) and pl.dim == dim:
            placements.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dim:
            placements.append(Shard(pl.dim - 1))
        else:
            placements.append(pl)
    if hasattr(value, "placements"):
        value = value.redistribute(mesh, placements).to_local()
    buf.to_local().select(dim, index - lo).copy_(value)
