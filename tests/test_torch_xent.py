"""Port fused cross-entropy against the JAX package.

On CPU the port's ``cross_entropy`` runs the kernels' plain versions; it
is held to both JAX paths, ``repro.kernels.xent.kernel.fused_xent_pallas``
(Pallas, interpret mode) and the blockwise ``cross_entropy(impl="xla")``,
loss and grad, on every ``XENT_CASES`` row of ``tests/test_kernels.py``;
plus the masked mean and the tied (transposed-view) head.  Tolerances are the reference's: 1e-5 on
per-token losses, rtol 1e-4 / atol 1e-5 on grads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xent import ops as jx_ops
from repro.kernels.xent.kernel import fused_xent_pallas
from repro_torch.kernels.xent import kernel as K
from repro_torch.kernels.xent import ops as tx_ops
from repro_torch.kernels.xent.ref import cross_entropy_ref

XENT_CASES = [
    (24, 32, 100, 0.0), (16, 64, 53, 30.0), (33, 48, 257, 0.0),
    (8, 32, 17, 10.0), (64, 16, 1000, 0.0),
]


def _inputs(T, D, V, seed=0):
    rng = np.random.default_rng(seed + T + D + V)
    h = rng.normal(0, 1, (T, D)).astype(np.float32)
    w = (rng.normal(0, 1, (D, V)) / np.sqrt(D)).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    return h, w, lab


def _jax_per_token(jax_impl, h, w, lab, cap):
    if jax_impl == "kernel":
        return fused_xent_pallas(h, w, lab, cap)
    return jx_ops.cross_entropy(h, w, lab, softcap=cap, impl="xla",
                                block=16)[1]


@pytest.mark.parametrize("case", XENT_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("jax_impl", ["kernel", "xla"])
def test_xent_matches_jax(case, jax_impl):
    T, D, V, cap = case
    h, w, lab = _inputs(T, D, V)

    jh, jw, jl = jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab)
    per_j = _jax_per_token(jax_impl, jh, jw, jl, cap)
    gj = jax.grad(lambda h, w: jnp.mean(_jax_per_token(jax_impl, h, w, jl,
                                                       cap)),
                  argnums=(0, 1))(jh, jw)

    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss, per_t = tx_ops.cross_entropy(th, tw, torch.tensor(lab), softcap=cap)
    gt = torch.autograd.grad(loss, (th, tw))

    np.testing.assert_allclose(per_t.detach().numpy(), np.asarray(per_j),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("jax_impl", ["kernel", "xla"])
def test_xent_mask(jax_impl):
    T, D, V = 16, 8, 40
    rng = np.random.default_rng(3)
    h = rng.normal(0, 1, (T, D)).astype(np.float32)
    w = rng.normal(0, 1, (D, V)).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    mask = rng.integers(0, 2, (T,)).astype(np.float32)
    jargs = (jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab),
             jnp.asarray(mask))
    l_ref, _ = jx_ops.cross_entropy(
        *jargs, impl="pallas" if jax_impl == "kernel" else "xla", block=8)
    l_got, _ = tx_ops.cross_entropy(torch.tensor(h), torch.tensor(w),
                                    torch.tensor(lab), torch.tensor(mask))
    np.testing.assert_allclose(float(l_got), float(l_ref), rtol=1e-5)


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_xent_tied_head_view(cap):
    """The aux head passes ``table.t()``, a strided (D, V) view of the
    (V, D) table: loss and the table gradient match JAX's
    ``jnp.transpose(table)`` path, and the kernel path's dW comes back in
    the table's layout."""
    T, D, V = 20, 16, 90
    rng = np.random.default_rng(5)
    h = rng.normal(0, 1, (T, D)).astype(np.float32)
    table = (rng.normal(0, 1, (V, D)) / np.sqrt(D)).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)

    def jloss(h, t):
        return jnp.mean(fused_xent_pallas(h, jnp.transpose(t),
                                          jnp.asarray(lab), cap))
    lj = jloss(jnp.asarray(h), jnp.asarray(table))
    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(table))

    th = torch.tensor(h, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    lt, _ = tx_ops.cross_entropy(th, tt.t(), torch.tensor(lab), softcap=cap)
    gt = torch.autograd.grad(lt, (th, tt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("case", XENT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_versions_match_oracle(case):
    """xent_fwd_plain / xent_bwd_plain against the materializing oracle and
    its autograd (fp32, 1e-5 / 1e-4)."""
    T, D, V, cap = case
    h, w, lab = (torch.tensor(a) for a in _inputs(T, D, V, seed=1))
    loss, lse = K.xent_fwd_plain(h, w, lab, softcap=cap)
    h_, w_ = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
    _, per = cross_entropy_ref(h_, w_, lab, softcap=cap)
    np.testing.assert_allclose(loss.numpy(), per.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    g = torch.tensor(np.random.default_rng(2).random(T), dtype=torch.float32)
    dh, dw = K.xent_bwd_plain(h, w, lab, lse, g, softcap=cap)
    gh, gw = torch.autograd.grad(torch.sum(per * g), (h_, w_))
    np.testing.assert_allclose(dh.numpy(), gh.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), gw.numpy(), rtol=1e-4, atol=1e-5)
