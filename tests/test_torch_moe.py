"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` from the same params and the same numpy inputs.

``capacity`` is ``==`` over a grid; ``init_moe`` gives the reference's tree
(paths, shapes, dtypes), with and without shared experts.  ``moe_mlp`` on
the granite-moe and qwen2-moe smoke configs, and on qwen2-moe with its
capacity factor lowered until choices are dropped: the routing (top-k
experts) and the kept choices ``==`` the reference's, y and the balance
loss within 1e-5, and the grads of x and of every MoE param of
sum(y * r) + aux within 1e-4 relative to each leaf's scale (fp32 smoke
configs).  The hybrid jamba smoke LM under ``remat`` "none", "block" and
"nested" (its period of 4 runs as one checkpointed body): loss, balance
loss and grads against each other and against the reference's.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.core import losses as j_losses
from repro.models import build_model as j_build
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import registry as t_registry
from repro_torch.core import losses as t_losses
from repro_torch.interop import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                 tree_map)
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT

B, S = 3, 32
# qwen2-moe smoke with capacity factor 0.5: C = 12 slots for 64 choices
# over 6 experts in a sequence, so some choices must be dropped
DROP_CF = 0.5
CASES = [("granite-moe-3b-a800m", None), ("qwen2-moe-a2.7b", None),
         ("qwen2-moe-a2.7b", DROP_CF)]
IDS = ["granite", "qwen2-moe", "qwen2-moe-drops"]


def _cfgs(arch, cf=None):
    j, t = registry.get_smoke_config(arch), t_registry.get_smoke_config(arch)
    if cf is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=cf))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=cf))
    return j, t


@functools.lru_cache(maxsize=None)
def _setup(arch, cf):
    jcfg, _ = _cfgs(arch, cf)
    params = jax.tree.map(np.asarray, JM.init_moe(jax.random.PRNGKey(3),
                                                  jcfg))
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    r = rng.normal(0, 1, (B, S, jcfg.d_model)).astype(np.float32)
    return params, x, r


def _j_routing(cfg, p, x):
    """The reference's routing and keep mask, step for step as in
    ``repro.models.moe.moe_mlp``."""
    m = cfg.moe
    gates = jax.nn.softmax(jnp.einsum(
        "bsd,de->bse", x, p["router"]["w"].astype(jnp.float32)), axis=-1)
    _, topi = jax.lax.top_k(gates, m.top_k)
    ch_e = topi.reshape(x.shape[0], -1)
    onehot = jax.nn.one_hot(ch_e, m.num_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - onehot) * onehot, axis=-1)
    return np.asarray(topi), np.asarray(pos < JM.capacity(cfg, x.shape[1]))


@functools.lru_cache(maxsize=None)
def _j_run(arch, cf):
    jcfg, _ = _cfgs(arch, cf)
    params, x, r = _setup(arch, cf)

    def f(p, x_):
        y, aux = JM.moe_mlp(jcfg, p, x_)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (y, aux)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    topi, keep = _j_routing(jcfg, params, jnp.asarray(x))
    return (np.asarray(y), float(aux), jax.tree.map(np.asarray, grads),
            topi, keep)


@functools.lru_cache(maxsize=None)
def _t_run(arch, cf):
    _, tcfg = _cfgs(arch, cf)
    params, x, r = _setup(arch, cf)
    tp = tree_map(lambda t: t.requires_grad_(True), from_numpy_tree(params))
    tx = torch.tensor(x, requires_grad=True)
    y, aux = TM.moe_mlp(tcfg, tp, tx)
    leaves = tree_leaves(tp) + [tx]
    g = iter(torch.autograd.grad(torch.sum(y * torch.tensor(r)) + aux,
                                 leaves))
    grads = (to_numpy_tree(tree_map(lambda _: next(g), tp)),
             next(g).numpy())
    with torch.no_grad():
        _, _, topi = TM.route(tcfg, tp, tx)
        _, _, keep = TM.slots(topi, tcfg.moe.num_experts,
                              TM.capacity(tcfg, S))
    return (y.detach().numpy(), float(aux.detach()), grads, topi.numpy(),
            keep.numpy().reshape(B, -1))


def _assert_grads(t_tree, j_tree, tol=1e-4):
    t_flat = jax.tree_util.tree_flatten_with_path(t_tree)[0]
    j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert [k for k, _ in t_flat] == [k for k, _ in j_flat]
    for (path, a), (_, b) in zip(t_flat, j_flat):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cf", (0.5, 1.0, 1.25, 2.0))
def test_capacity_equals_reference(cf):
    """Over (tokens per group, top-k, experts): the round-up to 4, the
    floor of 4 and the cap at the group's tokens."""
    jcfg, tcfg = _cfgs("granite-moe-3b-a800m", cf)
    for S_, k, E in itertools.product((1, 7, 32, 512, 4096), (1, 2, 4, 8),
                                      (4, 16, 40, 60)):
        j = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, num_experts=E, top_k=k))
        t = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, num_experts=E, top_k=k))
        assert TM.capacity(t, S_) == JM.capacity(j, S_), (S_, k, E)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b"])
def test_init_moe_tree_equals_reference(arch):
    """Paths, shapes and dtypes; the shared triple and its gate only with
    shared experts (qwen2-moe); ``lead`` prefixes every leaf."""
    jcfg, tcfg = _cfgs(arch)
    j = jax.tree_util.tree_flatten_with_path(
        JM.init_moe(jax.random.PRNGKey(0), jcfg))[0]
    t = jax.tree_util.tree_flatten_with_path(to_numpy_tree(
        TM.init_moe(torch.Generator().manual_seed(0), tcfg)))[0]
    assert [(k, a.shape, a.dtype) for k, a in t] == \
        [(k, a.shape, a.dtype) for k, a in j]
    assert any("shared_gate" in jax.tree_util.keystr(k) for k, _ in t) == \
        bool(tcfg.moe.num_shared_experts)
    stacked = jax.tree_util.tree_flatten_with_path(to_numpy_tree(
        TM.init_moe(torch.Generator().manual_seed(0), tcfg, lead=(3,))))[0]
    assert [(k, a.shape) for k, a in stacked] == \
        [(k, (3,) + a.shape) for k, a in t]


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_routing_and_keep_equal_reference(arch, cf):
    *_, j_topi, j_keep = _j_run(arch, cf)
    *_, t_topi, t_keep = _t_run(arch, cf)
    np.testing.assert_array_equal(t_topi, j_topi)
    np.testing.assert_array_equal(t_keep, j_keep)
    assert (not j_keep.all()) == (cf == DROP_CF)


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_moe_mlp_matches_reference(arch, cf):
    j_y, j_aux, *_ = _j_run(arch, cf)
    t_y, t_aux, *_ = _t_run(arch, cf)
    np.testing.assert_allclose(t_y, j_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_aux, j_aux, rtol=1e-5)
    assert t_aux > 0


@pytest.mark.parametrize("arch,cf", CASES, ids=IDS)
def test_moe_mlp_grads_match_reference(arch, cf):
    j_grads = _j_run(arch, cf)[2]
    t_grads = _t_run(arch, cf)[2]
    _assert_grads(t_grads, j_grads)


JAMBA = "jamba-1.5-large-398b"
REMATS = ("none", "block", "nested")


@functools.lru_cache(maxsize=None)
def _jamba_inputs():
    cfg = registry.get_smoke_config(JAMBA)
    params = jax.tree.map(np.asarray,
                          j_build(cfg).init(jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    return params, tokens


@functools.lru_cache(maxsize=None)
def _jamba_j(remat):
    cfg = registry.get_smoke_config(JAMBA)
    params, tokens = _jamba_inputs()

    def f(p):
        out = JT.forward(cfg, p, jnp.asarray(tokens), remat=remat)
        loss, _ = j_losses.lm_loss_from_logits(out["logits"],
                                               jnp.asarray(tokens))
        return loss + out["aux"], out["aux"]

    (loss, aux), g = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return float(loss), float(aux), jax.tree.map(np.asarray, g)


@functools.lru_cache(maxsize=None)
def _jamba_t(remat):
    cfg = t_registry.get_smoke_config(JAMBA)
    params, tokens = _jamba_inputs()
    tp = tree_map(lambda t: t.requires_grad_(True), from_numpy_tree(params))
    out = TT.forward(cfg, tp, torch.tensor(tokens), remat=remat)
    loss, _ = t_losses.lm_loss_from_logits(out["logits"],
                                           torch.tensor(tokens))
    loss = loss + out["aux"]
    g = iter(torch.autograd.grad(loss, tree_leaves(tp)))
    return (float(loss.detach()), float(out["aux"].detach()),
            to_numpy_tree(tree_map(lambda _: next(g), tp)))


@pytest.mark.parametrize("remat", REMATS)
def test_jamba_remat_matches_reference(remat):
    j_loss, j_aux, j_g = _jamba_j(remat)
    t_loss, t_aux, t_g = _jamba_t(remat)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    np.testing.assert_allclose(t_aux, j_aux, rtol=1e-5)
    assert t_aux > 0
    _assert_grads(t_g, j_g)


@pytest.mark.parametrize("remat", ("block", "nested"))
def test_jamba_remat_equals_no_remat(remat):
    """Checkpointing the (x, aux) period body recomputes the same graph:
    the same loss and grads as no remat, fp32 1e-6."""
    base_loss, base_aux, base_g = _jamba_t("none")
    loss, aux, g = _jamba_t(remat)
    assert (loss, aux) == (base_loss, base_aux)
    _assert_grads(g, base_g, tol=1e-6)
