"""Port Mamba-2 pieces against the JAX package, from numpy-seeded inputs.

- ``causal_conv1d`` and ``gated_rmsnorm``, forward and grad (fp32, 1e-5);
- ``ssd_chunk.ops.ssd_intra`` on every ``SSD_CASES`` row of
  ``tests/test_kernels.py``, forward and grad, against the JAX
  ``ssd_chunk.ops.ssd_intra`` (the Pallas kernel in interpret mode, its
  custom VJP through the oracle) at rtol 1e-5 and atol 1e-5 of each
  output's scale (the dt gradient reaches ~80, where fp32 einsums summed
  in another order differ by ~2e-5 in absolute terms), and the kernel's
  plain version against the port's oracle;
- ``ssd_chunk.kernel.ssd_intra_bwd_plain`` (the backward's plain version,
  explicit formulas) against ``jax.vjp`` of the JAX ``ssd_intra`` and
  against torch autograd of the port's oracle, from the same numpy inputs
  and cotangents, on every ``SSD_CASES`` row and a ragged one (1e-5 of
  each gradient's scale), and finite under large decays;
- ``ssd_chunked`` with both impls (port ``"xla"``/``"kernel"`` against JAX
  ``"xla"``/``"pallas"``), including S % Q != 0 and S < chunk (fp32, 1e-5
  forward, 1e-4 of each gradient's scale: the inter-chunk recurrence adds
  up rounding);
- the whole ``mamba`` sublayer of the mamba2-370m smoke config from the JAX
  init, forward and grad (fp32, 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.kernels.ssd_chunk import ops as j_ssd_ops
from repro.models import layers as JL
from repro.models import mamba as JM
from repro_torch.configs import registry as t_registry
from repro_torch.interop import from_numpy_tree, tree_leaves
from repro_torch.kernels.ssd_chunk import kernel as SK
from repro_torch.kernels.ssd_chunk import ops as t_ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_ref
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM

SSD_CASES = [  # B, nc, Q, H, P, N (tests/test_kernels.py)
    (2, 3, 16, 4, 8, 16),
    (1, 2, 8, 2, 16, 8),
    (2, 1, 32, 8, 8, 32),
]


def _close(a, b, tol, msg="", scaled=False):
    """rtol = atol = tol; with ``scaled``, atol is tol times b's largest
    magnitude (at least 1)."""
    b = np.asarray(b)
    atol = tol * max(1.0, float(np.abs(b).max())) if scaled else tol
    np.testing.assert_allclose(np.asarray(a.detach() if torch.is_tensor(a)
                                          else a),
                               b, rtol=tol, atol=atol, err_msg=msg)


def _ssd_inputs(case, seed=0):
    B, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    xf = rng.normal(0, 1, (B, nc, Q, H, P)).astype(np.float32)
    dtf = np.abs(rng.normal(0, 0.1, (B, nc, Q, H))).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, (H,))).astype(np.float32)
    a_cum = np.cumsum(dtf * A, axis=2).astype(np.float32)
    Bf = rng.normal(0, 1, (B, nc, Q, N)).astype(np.float32)
    Cf = rng.normal(0, 1, (B, nc, Q, N)).astype(np.float32)
    return xf, dtf, a_cum, Bf, Cf


def _loss_j(fn):
    return lambda *a: jnp.sum(jnp.sin(fn(*a)[0])) + jnp.sum(fn(*a)[1] ** 2)


def _loss_t(outs):
    return torch.sum(torch.sin(outs[0])) + torch.sum(outs[1] ** 2)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_intra_matches_jax(case):
    arrs = _ssd_inputs(case)
    jargs = [jnp.asarray(a) for a in arrs]
    jy, js = j_ssd_ops.ssd_intra(*jargs)
    jg = jax.grad(_loss_j(j_ssd_ops.ssd_intra), argnums=(0, 1, 2, 3, 4))(
        *jargs)

    targs = [torch.tensor(a, requires_grad=True) for a in arrs]
    outs = t_ssd_ops.ssd_intra(*targs)
    tg = torch.autograd.grad(_loss_t(outs), targs)
    _close(outs[0], jy, 1e-5, "y")
    _close(outs[1], js, 1e-5, "S")
    for name, a, b in zip(("x", "dt", "a_cum", "B", "C"), tg, jg):
        _close(a, b, 1e-5, f"d{name}", scaled=True)


@pytest.mark.parametrize("case", SSD_CASES + [(1, 2, 16, 3, 16, 8)], ids=str)
def test_ssd_intra_plain_matches_oracle(case):
    args = [torch.tensor(a) for a in _ssd_inputs(case, seed=1)]
    for a, b in zip(SK.ssd_intra_plain(*args), ssd_intra_ref(*args)):
        _close(a, b.numpy(), 1e-5)


def test_ssd_intra_ref_grads_are_finite_with_large_decays():
    """Masking before the exponential: exp of the positive segment sums
    above the diagonal would overflow and poison the gradient."""
    arrs = list(_ssd_inputs((1, 1, 32, 2, 4, 8), seed=2))
    arrs[1] = arrs[1] * 400.0                      # dt -> a_cum spans ~1e3
    arrs[2] = np.cumsum(-arrs[1], axis=2).astype(np.float32)
    targs = [torch.tensor(a, requires_grad=True) for a in arrs]
    grads = torch.autograd.grad(_loss_t(t_ssd_ops.ssd_intra(*targs)), targs)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


SSD_BWD_CASES = SSD_CASES + [(1, 1, 100, 9, 40, 24)]


def _ssd_cotangents(case, seed=5):
    B, nc, Q, H, P, N = case
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, nc, Q, H, P)).astype(np.float32),
            rng.normal(0, 1, (B, nc, H, P, N)).astype(np.float32))


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=str)
def test_ssd_intra_bwd_plain_matches_jax_vjp(case):
    arrs = _ssd_inputs(case, seed=3)
    cots = _ssd_cotangents(case)
    _, vjp = jax.vjp(j_ssd_ops.ssd_intra, *(jnp.asarray(a) for a in arrs))
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    got = SK.ssd_intra_bwd_plain(*(torch.tensor(a) for a in arrs + cots))
    for name, a, b in zip(("x", "dt", "a_cum", "B", "C"), got, want):
        assert a.shape == b.shape, name
        _close(a, b, 1e-5, f"d{name}", scaled=True)


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=str)
def test_ssd_intra_bwd_plain_matches_oracle_autograd(case):
    arrs = _ssd_inputs(case, seed=4)
    dy, ds = (torch.tensor(c) for c in _ssd_cotangents(case, seed=6))
    targs = [torch.tensor(a, requires_grad=True) for a in arrs]
    want = torch.autograd.grad(ssd_intra_ref(*targs), targs, (dy, ds))
    got = SK.ssd_intra_bwd_plain(*(t.detach() for t in targs), dy, ds)
    for name, a, b in zip(("x", "dt", "a_cum", "B", "C"), got, want):
        _close(a, b.numpy(), 1e-5, f"d{name}", scaled=True)


def test_ssd_intra_bwd_plain_grads_are_finite_with_large_decays():
    """The plain backward masks before the exponential too."""
    arrs = list(_ssd_inputs((1, 1, 32, 2, 4, 8), seed=2))
    arrs[1] = arrs[1] * 400.0                      # dt -> a_cum spans ~1e3
    arrs[2] = np.cumsum(-arrs[1], axis=2).astype(np.float32)
    cots = _ssd_cotangents((1, 1, 32, 2, 4, 8))
    grads = SK.ssd_intra_bwd_plain(*(torch.tensor(a)
                                     for a in arrs + list(cots)))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("jimpl,timpl", [("xla", "xla"),
                                         ("pallas", "kernel")])
@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8), (21, 16), (12, 16)],
                         ids=str)
def test_ssd_chunked_matches_jax(jimpl, timpl, S, chunk):
    B, H, P, N = 2, 3, 8, 16
    rng = np.random.default_rng(S + chunk)
    xh = rng.normal(0, 1, (B, S, H, P)).astype(np.float32)
    dt = np.abs(rng.normal(0, 0.2, (B, S, H))).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.3, (H,))).astype(np.float32)
    Bm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    arrs = [xh, dt, A, Bm, Cm]

    def jf(*a):
        y, h = JM.ssd_chunked(*a, chunk, impl=jimpl)
        return jnp.sum(jnp.sin(y)) + jnp.sum(h ** 2), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *[jnp.asarray(a) for a in arrs])
    targs = [torch.tensor(a, requires_grad=True) for a in arrs]
    ty, th = TM.ssd_chunked(*targs, chunk, impl=timpl)
    tg = torch.autograd.grad(torch.sum(torch.sin(ty)) + torch.sum(th ** 2),
                             targs)
    assert ty.shape == (B, S, H, P) and th.shape == (B, H, P, N)
    _close(ty, jy, 1e-5, "y")
    _close(th, jh, 1e-5, "h_final")
    for name, a, b in zip(("x", "dt", "A", "B", "C"), tg, jg):
        _close(a, b, 1e-4, f"d{name}", scaled=True)


def test_causal_conv1d_and_gated_rmsnorm_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 9, 12)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, (12,)).astype(np.float32)
    z = rng.normal(0, 1, (2, 9, 12)).astype(np.float32)
    scale = rng.normal(1, 0.1, (12,)).astype(np.float32)

    def jf(x, w, b, z, scale):
        y = JL.causal_conv1d({"w": w, "b": b}, x, "float32")
        out = JL.gated_rmsnorm({"scale": scale}, y, z, 1e-5, "float32")
        return jnp.sum(jnp.sin(out)) + jnp.sum(y ** 2), (y, out)

    (_, (jy, jo)), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3, 4),
                                           has_aux=True)(
        *[jnp.asarray(a) for a in (x, w, b, z, scale)])
    tx, tw, tb, tz, ts = (torch.tensor(a, requires_grad=True)
                          for a in (x, w, b, z, scale))
    ty = TL.causal_conv1d({"w": tw, "b": tb}, tx, "float32")
    to = TL.gated_rmsnorm({"scale": ts}, ty, tz, 1e-5, "float32")
    tg = torch.autograd.grad(torch.sum(torch.sin(to)) + torch.sum(ty ** 2),
                             (tx, tw, tb, tz, ts))
    _close(ty, jy, 1e-5, "conv")
    _close(to, jo, 1e-5, "norm")
    for name, a, bb in zip(("x", "w", "b", "z", "scale"), tg, jg):
        _close(a, bb, 1e-5, f"d{name}")


def test_causal_conv1d_bf16_matches_jax():
    """bf16: the shifted-slice sum rounds in the reference's order."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 7, 8)).astype(np.float32)
    w = rng.normal(0, 0.5, (4, 8)).astype(np.float32)
    b = rng.normal(0, 0.1, (8,)).astype(np.float32)
    jy = JL.causal_conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x, jnp.bfloat16), "bfloat16")
    ty = TL.causal_conv1d({"w": torch.tensor(w), "b": torch.tensor(b)},
                          torch.tensor(x).to(torch.bfloat16), "bfloat16")
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy, np.float32))


@functools.lru_cache(maxsize=None)
def _mamba_params():
    cfg = j_registry.get_smoke_config("mamba2-370m")
    p = JM.init_mamba(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(5).normal(0, 1, (2, 40, cfg.d_model))
    return jax.tree.map(np.asarray, p), x.astype(np.float32)


@pytest.mark.parametrize("jimpl,timpl", [("xla", "xla"),
                                         ("pallas", "kernel")])
def test_mamba_sublayer_matches_jax(jimpl, timpl):
    jcfg = j_registry.get_smoke_config("mamba2-370m")
    tcfg = t_registry.get_smoke_config("mamba2-370m")
    params, x = _mamba_params()

    def jf(p, x):
        y, _ = JM.mamba(jcfg, p, x, impl=jimpl)
        return jnp.sum(jnp.sin(y)), y

    (_, jy), (jgp, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = from_numpy_tree(params)
    leaves = tree_leaves(tp)
    tx = torch.tensor(x, requires_grad=True)
    for t in leaves:
        t.requires_grad_(True)
    ty, _ = TM.mamba(tcfg, tp, tx, impl=timpl)
    tg = torch.autograd.grad(torch.sum(torch.sin(ty)), leaves + [tx])
    _close(ty, jy, 1e-4, "y")
    jl = jax.tree_util.tree_flatten_with_path(jgp)[0] + [(("x",), jgx)]
    for (path, b), a in zip(jl, tg):
        scale = max(1e-3, float(np.abs(np.asarray(b)).max()))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_init_mamba_layout_matches_jax():
    """Same leaves, shapes and dtypes as the JAX init, stacked or not; the
    A_log and dt_bias draws stay in their ranges."""
    jcfg = j_registry.get_smoke_config("mamba2-370m")
    tcfg = t_registry.get_smoke_config("mamba2-370m")
    jp = jax.tree.map(np.asarray, JM.init_mamba(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_mamba(torch.Generator().manual_seed(0), tcfg, lead=(3,))
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t, tp, is_leaf=torch.is_tensor))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert tuple(b.shape) == (3,) + a.shape, path
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name, path
    a_log = tp["A_log"]
    assert bool(((a_log >= 0) & (a_log <= np.log(16.0))).all())
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    m = tcfg.mamba
    assert bool(((dt >= m.dt_min * 0.999) & (dt <= m.dt_max * 1.001)).all())
