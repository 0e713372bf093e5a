"""Parameter / cache / optimizer-state sharding rules, as
``repro.sharding.rules``.

Megatron-style TP on head/ff/expert/vocab axes over "model", optional
ZeRO-3/FSDP sharding of the complementary weight axis over the DP axes.
Matched by parameter *path* (regex over the "/"-joined key path of the
nested dict) with the rank of the leaf; unmatched leaves are replicated.
The port's trees have the JAX pytrees' layout, so the paths, and the
specs, are the JAX package's.

A spec is a tuple (``repro.sharding.annotations``);
:func:`to_placements` turns a spec tree into ``DTensor`` placements.
A mesh is a ``DeviceMesh`` or anything with ``axis_names`` and
``devices.shape``.
"""

from __future__ import annotations

import re

from repro_torch.sharding.annotations import (mesh_axis_names,
                                              mesh_axis_sizes,
                                              spec_to_placements)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(path)


# (regex, axis-pattern) — axis pattern entries: "tp" -> model, "fsdp" -> dp
# axes, None -> replicated.  Patterns are aligned to the *trailing* dims of
# the leaf (stacked leading R dims are always unsharded).
_LM_RULES = [
    (r"embed/table$",              ("tp", "fsdp")),
    (r"head/w$",                   ("fsdp", "tp")),
    (r"attn/w[qkv]/w$",            ("fsdp", "tp")),
    (r"attn/w[qkv]/b$",            ("tp",)),
    (r"attn/wo/w$",                ("tp", "fsdp")),
    (r"attn/wo/b$",                (None,)),
    (r"(mlp|shared)/w[gi]/w$",     ("fsdp", "tp")),
    (r"(mlp|shared)/wo/w$",        ("tp", "fsdp")),
    (r"moe/router/w$",             ("fsdp", None)),
    (r"moe/w[gi]$",                ("tp", "fsdp", None)),
    (r"moe/wo$",                   ("tp", None, "fsdp")),
    (r"mamba/in_proj/w$",          ("fsdp", "tp")),
    (r"mamba/out_proj/w$",         ("tp", "fsdp")),
    (r"mamba/conv/w$",             (None, "tp")),
    (r"mamba/conv/b$",             ("tp",)),
    (r"mamba/(A_log|dt_bias|D_skip)$", ("tp",)),
    (r"mamba/norm/scale$",         ("tp",)),
]

# Device-phase (federated) variant: vocab-sharded table, NO fsdp axis on
# d_model — the tied auxiliary head (h @ table^T) then contracts over a
# local D and yields vocab-sharded logits.
_DEVICE_RULES = [(r"embed/table$", ("tp", None))] + [
    r for r in _LM_RULES if not r[0].startswith(r"embed")]

# cache leaves carry a leading stacked-repetition dim R:
#   k/v:  (R, B, Smax, Hkv, hd)   ssm: (R, B, H, P, N)   conv: (R, B, W-1, C)
_CACHE_RULES = [
    (r"/(k|v)$",                   (None, "dp_batch", "kv_seq", None, None)),
    (r"/ssm$",                     (None, "dp_batch", "tp", None, None)),
    (r"/conv$",                    (None, "dp_batch", None, "tp")),
]


def _axis(entry, *, tp, fsdp, dp_batch, kv_seq):
    if entry == "tp":
        return tp
    if entry == "fsdp":
        return fsdp
    if entry == "dp_batch":
        return dp_batch
    if entry == "kv_seq":
        return kv_seq
    return None


def _spec_from_pattern(pattern, ndim, **ax):
    tail = [_axis(e, **ax) for e in pattern]
    lead = [None] * (ndim - len(tail))
    return tuple(lead + tail)


def _canon(entry):
    """A spec entry as ``PartitionSpec`` holds it: one axis name bare, no
    axes ``None``."""
    if isinstance(entry, tuple):
        return None if not entry else (entry[0] if len(entry) == 1
                                       else entry)
    return entry


def _divisible(dim: int, axes, mesh) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return dim % n == 0


def param_specs(params, mesh, *, strategy: str = "fsdp_tp",
                rules=None, cache: bool = False,
                kv_seq_axes=("model",), batch_axes=None):
    """Spec tree for a parameter (or cache, or optimizer-state) tree.

    Dims whose size is not divisible by the assigned mesh axes fall back to
    replicated for that dim.  ``kv_seq_axes`` / ``batch_axes`` override the
    decode-cache layout — long-context batch=1 decode shards the KV
    sequence over ("data", "model") instead of the batch.  A leaf that is
    not a tensor (an optimizer's step count) gets ``()``.
    """
    all_axes = mesh_axis_names(mesh)
    multi_pod = "pod" in all_axes
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    if strategy == "dp_only":
        # pure ZeRO-DP: every weight axis that can shard takes the full
        # mesh; no tensor parallelism
        fsdp, tp_axis = all_axes, None
    elif strategy == "tp_only":
        fsdp, tp_axis = None, "model"
    else:  # fsdp_tp
        fsdp, tp_axis = dp_axes, "model"
    dp_batch = batch_axes if batch_axes is not None else (
        all_axes if strategy == "dp_only" else dp_axes)
    table = rules or (_CACHE_RULES if cache else _LM_RULES)
    kv_seq = (kv_seq_axes if kv_seq_axes and len(kv_seq_axes) > 1
              else (kv_seq_axes[0] if kv_seq_axes else None))

    def leaf_spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return ()
        ps = _path_str(path)
        for rx, pattern in table:
            if re.search(rx, ps):
                spec = _spec_from_pattern(
                    pattern, len(leaf.shape), tp=tp_axis, fsdp=fsdp,
                    dp_batch=dp_batch or None, kv_seq=kv_seq)
                # drop non-divisible shardings (e.g. mamba2's 50280 vocab
                # replicates instead of sharding 16-way)
                return tuple(None if ax is not None
                             and not _divisible(d, ax, mesh) else _canon(ax)
                             for d, ax in zip(leaf.shape, spec))
        return ()

    return _map_with_path(leaf_spec, params)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def to_placements(specs, mesh):
    """Placements tree (a list a leaf) of a spec tree on ``mesh``."""
    if isinstance(specs, dict):
        return {k: to_placements(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list) or (isinstance(specs, tuple)
                                   and not _is_spec(specs)):
        return type(specs)(to_placements(v, mesh) for v in specs)
    return spec_to_placements(specs, mesh)


def batch_spec(mesh, extra_dims: int = 1):
    dp = ("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",)
    return (_canon(dp),) + (None,) * extra_dims


def default_axis_rules(mesh, *, sequence_sharding: bool = True,
                       strategy: str = "fsdp_tp"):
    """Logical-axis bindings for :func:`repro_torch.sharding.shard`."""
    names = mesh_axis_names(mesh)
    dp = ("pod", "data") if "pod" in names else ("data",)
    if strategy == "dp_only":
        return {"batch": names, "clients": names}
    rules = {
        "batch": dp,
        "clients": dp,
        "heads": ("model",),
        "ff": ("model",),
        "expert": ("model",),
        "vocab": ("model",),
        "kv_seq": ("model",),
    }
    if sequence_sharding:
        rules["seq"] = ("model",)
    return rules
