"""Port split/merge, device block, auxiliary loss and server block against
``repro.core.splitting`` / ``repro.core.auxiliary`` from the same params.

The split and merged trees convert one to one (same paths, equal leaves);
``device_forward``, ``aux_loss`` (tied head, layer-1 clone) and
``server_forward`` + ``lm_loss_from_hidden`` (plus the server layers' MoE
balance loss, ``out["aux"]``) match the JAX ``"xla"`` path with the port's
kernel path (plain versions on CPU), values and grads; also the hybrid
jamba (cut inside and at the end of its first period) and the MoE
qwen2-moe and granite-moe smoke configs.
Tolerance (fp32 smoke configs): 1e-4, grads 1e-4 relative to each leaf's
scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.base import SplitConfig
from repro.core import auxiliary as JA
from repro.core import losses as JL
from repro.core import splitting as JS
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import SplitConfig as TSplitConfig
from repro_torch.core import auxiliary as TA
from repro_torch.core import losses as TL
from repro_torch.core import splitting as TS
from repro_torch.interop import from_numpy_tree, to_numpy_tree, tree_leaves, tree_map
from repro_torch.models import build_model as t_build

ARCH_P = [("qwen3-1.7b", 1), ("qwen3-1.7b", 2), ("gemma2-2b", 1),
          ("jamba-1.5-large-398b", 1), ("jamba-1.5-large-398b", 3),
          ("qwen2-moe-a2.7b", 1), ("granite-moe-3b-a800m", 1)]
B, S = 2, 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _setup(arch, p):
    cfg = registry.get_smoke_config(arch)
    jm = j_build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    aux = JA.init_aux(jm, jax.random.PRNGKey(7), SplitConfig(split_point=p))
    tokens = np.random.default_rng(p).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jm, _np(params), _np(aux), tokens


def _ports(arch, p):
    jm, params, aux, tokens = _setup(arch, p)
    tm = t_build(t_registry.get_smoke_config(arch))
    return tm, from_numpy_tree(params), from_numpy_tree(aux), tokens


def _assert_trees(t_tree, j_tree, *, exact=False, tol=1e-4):
    t_flat = jax.tree_util.tree_flatten_with_path(t_tree)[0]
    j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    assert [k for k, _ in t_flat] == [k for k, _ in j_flat]
    for (path, a), (_, b) in zip(t_flat, j_flat):
        msg = jax.tree_util.keystr(path)
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=msg)
        else:
            scale = max(1e-3, float(np.abs(b).max()))
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                       err_msg=msg)


def _grad_tree(loss, tree):
    leaves = tree_leaves(tree)
    it = iter(torch.autograd.grad(loss, leaves))
    return to_numpy_tree(tree_map(lambda _: next(it), tree))


def _requires_grad(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


@pytest.mark.parametrize("arch,p", ARCH_P)
def test_split_and_merge_trees_convert_one_to_one(arch, p):
    jm, params, _, _ = _setup(arch, p)
    tm, tparams, _, _ = _ports(arch, p)
    jd, js = JS.split_params(jm, jax.tree.map(jnp.asarray, params), p)
    td, ts = TS.split_params(tm, tparams, p)
    _assert_trees(to_numpy_tree(td), _np(jd), exact=True)
    _assert_trees(to_numpy_tree(ts), _np(js), exact=True)
    merged = to_numpy_tree(TS.merge_params(tm, td, ts, p))
    _assert_trees(merged, _np(JS.merge_params(jm, jd, js, p)), exact=True)
    assert TS.merged_config(tm).tie_embeddings is False


@pytest.mark.parametrize("arch,p", ARCH_P)
def test_device_block_and_aux_loss_match(arch, p):
    jm, params, aux, tokens = _setup(arch, p)
    split = SplitConfig(split_point=p)
    jd, _ = JS.split_params(jm, jax.tree.map(jnp.asarray, params), p)

    def jloss(dev, aux_p):
        acts = JS.device_forward(jm, dev, jnp.asarray(tokens), p)
        loss, _ = JA.aux_loss(jm, aux_p, dev, acts, {"tokens": tokens}, split)
        return loss, acts

    (j_l, j_acts), j_g = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jd, jax.tree.map(jnp.asarray, aux))

    tm, tparams, taux, _ = _ports(arch, p)
    td, _ = TS.split_params(tm, tparams, p)
    td, taux = _requires_grad(td), _requires_grad(taux)
    t_acts = TS.device_forward(tm, td, torch.tensor(tokens), p)
    t_l, _ = TA.aux_loss(tm, taux, td, t_acts, {"tokens": torch.tensor(tokens)},
                         TSplitConfig(split_point=p))
    np.testing.assert_allclose(t_acts.detach().numpy(), np.asarray(j_acts),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t_l.detach()), float(j_l), rtol=1e-5)
    _assert_trees(_grad_tree(t_l, (td, taux)), _np(j_g))


@pytest.mark.parametrize("arch,p", ARCH_P)
def test_server_block_and_loss_match(arch, p):
    jm, params, _, tokens = _setup(arch, p)
    cfg = jm.cfg
    jd, js = JS.split_params(jm, jax.tree.map(jnp.asarray, params), p)
    acts = np.asarray(JS.device_forward(jm, jd, jnp.asarray(tokens), p))

    def jloss(srv):
        out = JS.server_forward(jm, srv, jnp.asarray(acts), p)
        loss, _ = JL.lm_loss_from_hidden(out["hidden"],
                                         JS.server_head_weight(srv),
                                         jnp.asarray(tokens),
                                         softcap=cfg.final_softcap)
        return loss + out["aux"], (out["hidden"], out["aux"])

    (j_l, (j_h, j_aux)), j_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(js)

    tm, tparams, _, _ = _ports(arch, p)
    _, ts = TS.split_params(tm, tparams, p)
    ts = _requires_grad(ts)
    out = TS.server_forward(tm, ts, torch.tensor(acts), p)
    t_l, _ = TL.lm_loss_from_hidden(out["hidden"], TS.server_head_weight(ts),
                                    torch.tensor(tokens),
                                    softcap=cfg.final_softcap)
    t_l = t_l + out["aux"]
    np.testing.assert_allclose(out["hidden"].detach().numpy(), np.asarray(j_h),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out["aux"].detach()), float(j_aux),
                               rtol=1e-5)
    assert (float(j_aux) > 0) == cfg.moe.enabled
    np.testing.assert_allclose(float(t_l.detach()), float(j_l), rtol=1e-5)
    _assert_trees(_grad_tree(t_l, ts), _np(j_g))
