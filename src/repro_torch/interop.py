"""Parameter trees between numpy and torch.

``repro`` keeps params as nested dicts/lists of jnp arrays; the port keeps
the same nesting with tensors.  Both directions go through numpy (the
JAX -> numpy step is ``jax.tree.map(np.asarray, tree)`` on the caller's
side), leaf for leaf, with no renaming.  dtypes keep their names
(``"float32"``, ``"bfloat16"``, ... as in ``models.layers.dt``); numpy has
no native bfloat16, so such leaves travel as ``ml_dtypes.bfloat16``
arrays, the type JAX hands out.
"""

from __future__ import annotations

import numpy as np
import torch


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of a nested dict/list/tuple, zipping any
    further trees of the same structure (``None`` subtrees stay ``None``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _leaf_to_torch(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf_to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_tree(tree, device="cpu"):
    """numpy (or array-like) leaves -> tensors on ``device``, dtype kept."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def to_numpy_tree(tree):
    """tensor leaves -> numpy arrays on the host, dtype kept."""
    return tree_map(_leaf_to_numpy, tree)

