"""Port LM forward and grads against ``repro.models`` from the same params.

``qwen3-1.7b``, ``gemma2-2b`` and ``mamba2-370m`` smoke configs (GQA +
qk-norm + tied embeddings; sliding window + both softcaps + post-block
norms + GeGLU; Mamba-2 SSD mixers with 2 chunks per sequence), and the
``musicgen-large`` (audio family), ``qwen2-vl-72b`` (vlm family, M-RoPE
with random (3, B, S) positions made with numpy and handed to both
packages), ``qwen1.5-4b`` and ``mistral-large-123b`` smoke configs start
from the JAX package's own init, converted through numpy.  The JAX
``impl="xla"`` path is held to the port's eager ``"xla"`` path, and JAX
``impl="pallas"`` (interpret mode) to the port's ``"kernel"`` path (plain
versions on CPU).  Tolerance (fp32 smoke configs): 1e-4 on logits, hidden
and the loss, 1e-4 relative to each leaf's scale on grads.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.core import losses as j_losses
from repro.models import build_model as j_build
from repro.models import transformer as JT
from repro_torch.configs import registry as t_registry
from repro_torch.core import losses as t_losses
from repro_torch.interop import from_numpy_tree, to_numpy_tree, tree_leaves
from repro_torch.models import transformer as TT

ARCHS = ("qwen3-1.7b", "gemma2-2b", "mamba2-370m", "musicgen-large",
         "qwen2-vl-72b", "qwen1.5-4b", "mistral-large-123b")
CASES = [(arch, jimpl, timpl) for arch in ARCHS
         for jimpl, timpl in (("xla", "xla"), ("pallas", "kernel"))]
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def _params_and_tokens(arch):
    cfg = registry.get_smoke_config(arch)
    params = j_build(cfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jax.tree.map(np.asarray, params), tokens


@functools.lru_cache(maxsize=None)
def _positions(arch):
    """M-RoPE (t, h, w) positions for the vlm config, else None (both
    packages then make their default positions)."""
    if not registry.get_smoke_config(arch).mrope_sections:
        return None
    return np.random.default_rng(1).integers(0, 2 * S, (3, B, S)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, impl):
    cfg = registry.get_smoke_config(arch)
    params, tokens = _params_and_tokens(arch)
    pos = _positions(arch)
    pos = None if pos is None else jnp.asarray(pos)

    def loss_fn(p):
        out = JT.forward(cfg, p, jnp.asarray(tokens), positions=pos,
                         impl=impl)
        loss, _ = j_losses.lm_loss_from_logits(out["logits"],
                                               jnp.asarray(tokens))
        return loss, out

    (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return (float(loss), np.asarray(out["logits"]), np.asarray(out["hidden"]),
            jax.tree.map(np.asarray, grads))


def _torch_run(arch, impl):
    cfg = t_registry.get_smoke_config(arch)
    params, tokens = _params_and_tokens(arch)
    tp = from_numpy_tree(params)
    leaves = tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    pos = _positions(arch)
    pos = None if pos is None else torch.tensor(pos)
    out = TT.forward(cfg, tp, torch.tensor(tokens), positions=pos, impl=impl)
    loss, _ = t_losses.lm_loss_from_logits(out["logits"], torch.tensor(tokens))
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    gtree = to_numpy_tree(jax.tree.map(lambda _: next(it), tp,
                                       is_leaf=torch.is_tensor))
    return (float(loss.detach()), out["logits"].detach().numpy(),
            out["hidden"].detach().numpy(), gtree)


@pytest.mark.parametrize("arch,jimpl,timpl", CASES)
def test_forward_matches_jax(arch, jimpl, timpl):
    j_loss, j_logits, j_hidden, _ = _jax_run(arch, jimpl)
    t_loss, t_logits, t_hidden, _ = _torch_run(arch, timpl)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_hidden, j_hidden, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)


@pytest.mark.parametrize("arch,jimpl,timpl", CASES)
def test_grads_match_jax(arch, jimpl, timpl):
    j_grads = _jax_run(arch, jimpl)[3]
    t_grads = _torch_run(arch, timpl)[3]
    j_flat = jax.tree_util.tree_flatten_with_path(j_grads)[0]
    t_flat = jax.tree_util.tree_flatten_with_path(t_grads)[0]
    assert [p for p, _ in j_flat] == [p for p, _ in t_flat]
    for (path, a), (_, b) in zip(t_flat, j_flat):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_kernel_split_bwd_matches_fused_at_model_level():
    """impl="kernel:split" reaches the two-sweep flash-attention backward
    from the model entry point; grads match the fused default (same math,
    another kernel schedule), fp32 1e-5, as tests/test_models.py holds the
    JAX package's "pallas:split"."""
    cfg = t_registry.get_smoke_config("qwen3-1.7b")
    params, tokens = _params_and_tokens("qwen3-1.7b")
    grads = {}
    for impl in ("kernel", "kernel:split"):
        leaves = tree_leaves(tp := from_numpy_tree(params))
        for t in leaves:
            t.requires_grad_(True)
        logits = TT.forward(cfg, tp, torch.tensor(tokens), impl=impl,
                            remat="none")["logits"]
        grads[impl] = torch.autograd.grad(torch.mean(torch.square(logits)),
                                          leaves)
    for a, b in zip(grads["kernel"], grads["kernel:split"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_converted_params_round_trip():
    params, _ = _params_and_tokens("gemma2-2b")
    back = to_numpy_tree(from_numpy_tree(params))
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert jax.tree.structure(back) == jax.tree.structure(params)


def test_dense_low_precision_grad_matches_jax():
    """``dense`` under the gradient-communication dtype: the weight grad is
    accumulated in fp32 and emitted in bf16 (``_mm_lowgrad``); bf16
    tolerance 2e-2."""
    from repro.analysis import grad_comm_dtype as j_gcd
    from repro.models import layers as JLy
    from repro_torch.models import layers as TLy

    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (3, 5, 16)).astype(np.float32)
    w = (rng.normal(0, 1, (16, 8)) / 4).astype(np.float32)

    def jf(w_, x_):
        return jnp.sum(jnp.sin(JLy.dense({"w": w_}, x_, "bfloat16")
                               .astype(jnp.float32)))

    with j_gcd("bfloat16"):
        jg = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w, jnp.bfloat16),
                                          jnp.asarray(x, jnp.bfloat16))
    tw = torch.tensor(w).to(torch.bfloat16).requires_grad_(True)
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    with TLy.grad_comm_dtype("bfloat16"):
        y = TLy.dense({"w": tw}, tx, "bfloat16")
    tg = torch.autograd.grad(torch.sum(torch.sin(y.float())), (tw, tx))
    for a, b in zip(tg, jg):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=2e-2,
                                   atol=2e-2)
