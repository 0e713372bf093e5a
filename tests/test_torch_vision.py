"""The port's vision classifiers against ``repro.models.cnn`` /
``repro.models.vit`` and the vision branches of ``repro.core``.

Inputs come from numpy with a seed, params from the JAX init carried
across by ``from_numpy_tree`` (the auxiliary network's from the port's
init, held to the tree the reference's init makes); everything is fp32
on the CPU.  Tolerances:
forwards within 1e-5 of each output's largest magnitude (the two
frameworks sum convolutions and matmuls in different orders), gradients
within 1e-4 of each leaf's largest magnitude, trees from the split and
merge equal exactly (they only move leaves), byte counts and model times
``==``.
"""

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.configs.base import SplitConfig as JSplit
from repro.core import auxiliary as JA
from repro.core import comm_model as JCM
from repro.core import splitting as JS
from repro.core import steps as JSt
from repro.models import build_model as j_build
from repro.models import cnn as JC
from repro.models import layers as JL
from repro.models import vit as JV
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.configs.base import SplitConfig as TSplit
from repro_torch.core import auxiliary as TA
from repro_torch.core import comm_model as TCM
from repro_torch.core import splitting as TS
from repro_torch.core import steps as TSt
from repro_torch.interop import (from_numpy_tree, to_numpy_tree, tree_leaves,
                                 tree_map)
from repro_torch.models import build_model as t_build
from repro_torch.models import cnn as TC
from repro_torch.models import layers as TL
from repro_torch.models import vit as TV

ARCHS = ("mobilenet-l", "vgg11", "vit-s", "swin-t")
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
B = 2


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, tol, what="", floor=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(floor, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _close_trees(got, want, tol):
    """Leaf by leaf, each within ``tol`` of its largest magnitude, that
    scale floored at 1e-1 of the tree's largest: a gradient that vanishes
    analytically (a conv bias under a one-channel group norm, a key bias
    under the softmax) holds only the rounding noise of sums that cancel,
    1e-7 to 2e-6 of the tree's largest gradient."""
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    top = max([float(np.abs(b).max()) for _, b in w if np.size(b)] + [0.0])
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, tol, jax.tree_util.keystr(path),
               floor=max(1e-6, 1e-1 * top))


def _np(tree):
    return jax.tree.map(np.array, tree)     # writable host copies


def _leaf(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def _torch_vjp(fn, args, ct):
    """(out, grads of sum(out * ct) over every leaf of ``args``)."""
    args = _leaf(from_numpy_tree(args))
    out = fn(*args)
    leaves = tree_leaves(args)
    gs = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves,
                             allow_unused=True)
    it = iter([torch.zeros_like(l) if g is None else g
               for l, g in zip(leaves, gs)])
    grads = tree_map(lambda _: next(it), args)
    return out.detach().numpy(), to_numpy_tree(grads)


def _jax_vjp(fn, args, ct):
    """One jitted program (compiling it beats dispatching op by op)."""
    @jax.jit
    def run(args, ct):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(ct)

    out, grads = run(jax.tree.map(jnp.asarray, tuple(args)), jnp.asarray(ct))
    return np.asarray(out), _np(grads)


def _check_vjp(j_fn, t_fn, args, seed=0):
    """Forward and every gradient of ``sum(out * ct)``, ct from numpy."""
    with torch.no_grad():   # the port's shape (cheaper than a JAX trace;
        shape = tuple(t_fn(*from_numpy_tree(args)).shape)  # _close checks)
    ct = _rng(seed + 100).normal(size=shape).astype(np.float32)
    j_out, j_g = _jax_vjp(j_fn, args, ct)
    t_out, t_g = _torch_vjp(t_fn, args, ct)
    _close(t_out, j_out, FWD_TOL, "forward")
    _close_trees(list(t_g), list(j_g), GRAD_TOL)
    return t_out, j_out


def _cfgs(arch, smoke=True):
    get = "get_smoke_config" if smoke else "get_config"
    return getattr(j_registry, get)(arch), getattr(t_registry, get)(arch)


# ---------------------------------------------------------------------------
# (a) conv2d, (b) groupnorm and layernorm
# ---------------------------------------------------------------------------

CONV_CASES = [  # (k, stride, depthwise, size)
    (k, s, dw, n) for k in (1, 3) for s in (1, 2) for dw in (False, True)
    for n in (7, 8) if not (dw and k == 1)]


@pytest.mark.parametrize("k,stride,dw,n", CONV_CASES)
def test_conv2d_matches_reference(k, stride, dw, n):
    rng = _rng(k * 100 + stride * 10 + n + dw)
    cin = 6 if dw else 5
    cout = cin if dw else 7
    x = rng.normal(size=(B, n, n, cin)).astype(np.float32)
    p = {"w": rng.normal(size=(k, k, 1 if dw else cin, cout)
                         ).astype(np.float32),
         "b": rng.normal(size=(cout,)).astype(np.float32)}
    g = cin if dw else 1
    out, _ = _check_vjp(lambda p, x: JC.conv2d(p, x, stride, groups=g),
                        lambda p, x: TC.conv2d(p, x, stride, groups=g),
                        (p, x))
    assert out.shape == (B, -(-n // stride), -(-n // stride), cout)


def test_stride2_conv_would_fail_under_symmetric_padding():
    """XLA pads k 3, s 2 on an even input (0, 1); padding 1 on both sides
    shifts every strided output by one pixel, which the test above sees."""
    assert TC.same_padding(8, 3, 2) == (0, 1)
    assert TC.same_padding(7, 3, 2) == (1, 1)
    assert TC.same_padding(8, 1, 2) == (0, 0)
    rng = _rng(5)
    x = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    p = {"w": rng.normal(size=(3, 3, 4, 4)).astype(np.float32),
         "b": np.zeros((4,), np.float32)}
    want = np.asarray(JC.conv2d(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), 2))
    tp, tx = from_numpy_tree(p), torch.from_numpy(x)
    sym = torch.nn.functional.conv2d(
        tx.permute(0, 3, 1, 2), tp["w"].permute(3, 2, 0, 1), stride=2,
        padding=1).permute(0, 2, 3, 1).numpy()
    assert np.abs(sym - want).max() > 100 * FWD_TOL * np.abs(want).max()
    _close(TC.conv2d(tp, tx, 2).numpy(), want, FWD_TOL)


@pytest.mark.parametrize("C,groups", [(16, 8), (12, 8), (6, 8)])
def test_groupnorm_matches_reference(C, groups):
    rng = _rng(C)
    x = (3.0 + 2.0 * rng.normal(size=(B, 5, 4, C))).astype(np.float32)
    p = {"scale": rng.normal(size=(C,)).astype(np.float32),
         "bias": rng.normal(size=(C,)).astype(np.float32)}
    _check_vjp(lambda p, x: JC.groupnorm(p, x, groups),
               lambda p, x: TC.groupnorm(p, x, groups), (p, x))


def test_layernorm_matches_reference():
    rng = _rng(3)
    x = (1.0 + 4.0 * rng.normal(size=(B, 9, 24))).astype(np.float32)
    p = {"scale": rng.normal(size=(24,)).astype(np.float32),
         "bias": rng.normal(size=(24,)).astype(np.float32)}
    _check_vjp(lambda p, x: JL.layernorm(p, x, 1e-6),
               lambda p, x: TL.layernorm(p, x, 1e-6), (p, x))
    tree = TL.init_layernorm(24)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tree.items()} == {
        k: (tuple(v.shape), torch.float32)
        for k, v in JL.init_layernorm(24).items()}


@pytest.mark.parametrize("arch", ARCHS + ("qwen3-1.7b",))
def test_model_input_and_label_keys(arch):
    """The batch keys the steps and the trainer read, from the model: a
    classifier's images and labels as in ``make_vision_dataset``, an LM's
    tokens for both (it predicts its own next tokens)."""
    from repro_torch.data.synthetic import make_dataset_for_model
    tm = t_build(t_registry.get_smoke_config(arch))
    arrays = make_dataset_for_model(tm, 4, seq_len=8).arrays
    assert {tm.input_key, tm.label_key} == set(arrays)
    want = ("tokens", "tokens") if tm.kind == "lm" else ("images", "labels")
    assert (tm.input_key, tm.label_key) == want
    assert tuple(arrays[tm.input_key].shape[1:]) == tuple(
        tm.input_spec(4, 8).shape[1:])


def test_pin_fp32_turns_tf32_off():
    """What ``resolve_device`` does for a CUDA device: cuDNN (TF32 by
    PyTorch's default) and cuBLAS run fp32 products in fp32."""
    from repro_torch.device import pin_fp32
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        pin_fp32()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def test_pin_deterministic_pins_only_cudnn():
    """What ``resolve_device`` also does for a CUDA device: cuDNN picks
    deterministic algorithms only; PyTorch's global deterministic mode
    stays as it was (it costs the LM step and changes nothing there)."""
    from repro_torch.device import pin_deterministic
    flag = torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.deterministic = False
        pin_deterministic()
        assert torch.backends.cudnn.deterministic
        assert not torch.are_deterministic_algorithms_enabled()
    finally:
        torch.backends.cudnn.deterministic = flag


# ---------------------------------------------------------------------------
# (c) every layer of the four smoke archs, forward and grads
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """(JAX model, port model, numpy params, numpy images, labels, the
    reference's activations entering each layer, and its whole-model
    output {"hidden", "logits"}), from one compiled program."""
    jcfg, tcfg = _cfgs(arch)
    jm, tm = j_build(jcfg), t_build(tcfg)
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = _rng(11)
    s = jcfg.img_size
    images = rng.normal(size=(B, s, s, jcfg.in_channels)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, (B,)).astype(np.int32)
    @jax.jit
    def inputs(params, x):
        x0, out = x, []
        for i in range(jcfg.num_layers):
            out.append(x)
            x = jm.apply(params, x, lo=i, hi=i + 1,
                         return_logits=False)["hidden"]
        return out, jm.apply(params, x0)

    ins, full = _np(inputs(params, jnp.asarray(images)))
    return jm, tm, params, images, labels, ins, full


def _layer_fns(arch, i):
    jm, tm = _arch(arch)[:2]
    if jm.cfg.family in ("vit", "swin"):
        return (lambda p, x: JV.apply_vit_layer(jm.cfg, p, x, i),
                lambda p, x: TV.apply_vit_layer(tm.cfg, p, x, i))
    return (lambda p, x: JC.apply_vision_layer(jm.cfg, p, x, i),
            lambda p, x: TC.apply_vision_layer(tm.cfg, p, x, i))


LAYER_CASES = [(a, i) for a in ARCHS
               for i in range(j_registry.get_smoke_config(a).num_layers)]


@pytest.mark.parametrize("arch,i", LAYER_CASES)
def test_layer_forward_and_grads_match(arch, i):
    _, _, params, _, _, ins, _ = _arch(arch)
    j_fn, t_fn = _layer_fns(arch, i)
    _check_vjp(j_fn, t_fn, (params["layers"][i], ins[i]), seed=i)


@pytest.mark.parametrize("arch", ARCHS)
def test_head_and_model_apply_match(arch):
    jm, tm, params, images, _, ins, full = _arch(arch)
    _check_vjp(lambda p, x: JC.apply_head(jm.cfg, p, x),
               lambda p, x: TC.apply_head(tm.cfg, p, x),
               (params["head"], full["hidden"]))
    want = full["logits"]
    got = tm.apply(from_numpy_tree(params), torch.from_numpy(images))
    _close(got["logits"].detach().numpy(), want, FWD_TOL)
    # layers [1, L) from the reference's layer-0 output: the inputs are
    # cast to the compute dtype when lo > 0
    got = tm.apply(from_numpy_tree(params), torch.from_numpy(ins[1]), lo=1)
    _close(got["logits"].detach().numpy(), want, FWD_TOL)


def test_swin_layer_would_fail_under_exact_gelu(monkeypatch):
    """jax.nn.gelu is the tanh form; the exact erf gelu moves a Swin
    layer's output beyond the layer tolerance."""
    arch, i = "swin-t", 1
    _, tm, params, _, _, ins, _ = _arch(arch)
    j_fn, t_fn = _layer_fns(arch, i)
    want = np.asarray(jax.jit(j_fn)(*jax.tree.map(
        jnp.asarray, (params["layers"][i], ins[i]))))
    args = from_numpy_tree((params["layers"][i], ins[i]))
    _close(t_fn(*args).numpy(), want, FWD_TOL)
    exact = torch.nn.functional.gelu
    monkeypatch.setattr(TV, "F", types.SimpleNamespace(
        gelu=lambda x, approximate: exact(x)))
    diff = np.abs(t_fn(*args).numpy() - want).max()
    assert diff > 10 * FWD_TOL * np.abs(want).max()


def test_swin_shift_runs_on_even_layers():
    """Layer 2 of swin-t-smoke is shifted, layer 1 is not: both match the
    reference (above), and a layer run at the other parity differs."""
    _, tm, params, _, _, ins, _ = _arch("swin-t")
    x = torch.from_numpy(ins[1])
    p = from_numpy_tree(params["layers"][1])
    a = TV.apply_vit_layer(tm.cfg, p, x, 1)
    b = TV.apply_vit_layer(tm.cfg, p, x, 2)
    assert float((a - b).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# (d) split, device/server forward and merge at every split point
# ---------------------------------------------------------------------------

# every cut of one CNN and one ViT-family model (Swin: its shifted layers)
SPLIT_CASES = [(a, p) for a in ("mobilenet-l", "swin-t")
               for p in range(1, j_registry.get_smoke_config(a).num_layers)]


@pytest.mark.parametrize("arch,p", SPLIT_CASES)
def test_split_forwards_and_merge_match(arch, p):
    jm, tm, params, images = _arch(arch)[:4]
    j_dev, j_srv = JS.split_params(jm, jax.tree.map(jnp.asarray, params), p)
    t_dev, t_srv = TS.split_params(tm, from_numpy_tree(params), p)
    for t, j in ((t_dev, j_dev), (t_srv, j_srv)):
        _close_trees(to_numpy_tree(t), _np(j), 0.0)
    # each reference function compiled (op by op, every shape of the
    # model would compile on its own)
    acts = np.array(jax.jit(lambda d, x: JS.device_forward(jm, d, x, p))(
        j_dev, jnp.asarray(images)))
    got = TS.device_forward(tm, t_dev, torch.from_numpy(images), p)
    _close(got.numpy(), acts, FWD_TOL, "device_forward")
    assert tuple(got.shape) == tuple(tm.activation_spec(
        B, split_point=p, dtype="float32").shape)
    want = jax.jit(lambda s, a: JS.server_forward(jm, s, a, p))(
        j_srv, jnp.asarray(acts))
    out = TS.server_forward(tm, t_srv, torch.from_numpy(acts), p)
    _close(out["logits"].numpy(), np.asarray(want["logits"]), FWD_TOL)
    _close(out["hidden"].numpy(), np.asarray(want["hidden"]), FWD_TOL)
    merged = TS.merge_params(tm, t_dev, t_srv, p)
    _close_trees(to_numpy_tree(merged), params, 0.0)
    _close_trees(to_numpy_tree(merged),
                 _np(JS.merge_params(jm, j_dev, j_srv, p)), 0.0)
    assert TS.merged_config(tm) == tm.cfg


# ---------------------------------------------------------------------------
# (e) the auxiliary network: shapes, loss and grads, with and without clone
# ---------------------------------------------------------------------------

# with and without the clone at p 1; the clone again at the last cut,
# where a CNN's clone takes the channels of layer p - 1 and Swin's clone
# runs at the other shift parity (ViT-S's only moves its index)
AUX_CASES = [(a, 1, clone) for a in ARCHS for clone in (True, False)] + [
    (a, j_registry.get_smoke_config(a).num_layers - 1, True)
    for a in ("mobilenet-l", "vgg11", "swin-t")]


def _init_aux(jm, tm, j_split, t_split):
    """Aux params for both sides from the port's init, held to the tree
    the reference's init makes (traced, not compiled: XLA compiles a
    sampler per shape, ~2 s a case)."""
    aux = to_numpy_tree(TA.init_aux(tm, torch.Generator().manual_seed(7),
                                    t_split))
    want = jax.eval_shape(lambda k: JA.init_aux(jm, k, j_split),
                          jax.random.PRNGKey(7))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), aux) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), want)
    return aux


def _shapes(tree):
    return jax.tree.map(lambda a: tuple(a.shape), tree)


@pytest.mark.parametrize("arch,p,clone", AUX_CASES)
def test_aux_init_shapes_loss_and_grads(arch, p, clone):
    jm, tm, params, images, labels, ins, _ = _arch(arch)
    jsc = JSplit(split_point=p, aux_clone_first_server_layer=clone)
    tsc = TSplit(split_point=p, aux_clone_first_server_layer=clone)
    j_aux = _init_aux(jm, tm, jsc, tsc)
    t_meta = TA.init_aux(tm, torch.Generator(), tsc, "meta")
    assert ("block" in j_aux) == clone
    assert jax.tree.map(lambda t: tuple(t.shape), t_meta) == _shapes(j_aux)
    assert all(t.device.type == "meta" for t in tree_leaves(t_meta))
    acts = ins[p]

    def j_fn(aux, a):
        return JA.aux_loss(jm, aux, None, a, {"labels": jnp.asarray(labels)},
                           jsc)[0]

    def t_fn(aux, a):
        return TA.aux_loss(tm, aux, None, a,
                           {"labels": torch.from_numpy(labels)}, tsc)[0]

    _check_vjp(j_fn, t_fn, (j_aux, acts))


def test_classification_loss_matches_reference():
    rng = _rng(4)
    logits = (3.0 * rng.normal(size=(64, 10))).astype(np.float32)
    labels = rng.integers(0, 10, (64,)).astype(np.int32)
    from repro.core import losses as JLoss
    from repro_torch.core import losses as TLoss
    j_loss, j_m = JLoss.classification_loss(jnp.asarray(logits),
                                            jnp.asarray(labels))
    t_loss, t_m = TLoss.classification_loss(torch.from_numpy(logits),
                                            torch.from_numpy(labels))
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert float(t_m["acc"]) == float(j_m["acc"]) > 0
    _check_vjp(lambda x: JLoss.classification_loss(x, jnp.asarray(labels))[0],
               lambda x: TLoss.classification_loss(
                   x, torch.from_numpy(labels))[0], (logits,))


# ---------------------------------------------------------------------------
# (f) one client round and one server step
# ---------------------------------------------------------------------------

FED = dict(num_clients=2, clients_per_round=2, local_steps=2,
           device_batch_size=B, server_batch_size=4, seed=0)
OPTIM = dict(name="momentum", lr=0.05, schedule="inverse_time",
             decay_gamma=0.005)


def _run_cfgs(p=1):
    return (JRun(fed=JFed(**FED), optim=JOptim(**OPTIM),
                 split=JSplit(split_point=p)),
            TRun(fed=TFed(**FED), optim=TOptim(**OPTIM),
                 split=TSplit(split_point=p)))


@pytest.mark.parametrize("arch", ARCHS)
def test_client_round_and_server_step_match(arch):
    jm, tm, params = _arch(arch)[:3]
    jrun, trun = _run_cfgs()
    H, s = FED["local_steps"], jm.cfg.img_size
    rng = _rng(21)
    batches = {"images": rng.normal(size=(H, B, s, s, 3)).astype(np.float32),
               "labels": rng.integers(0, 10, (H, B)).astype(np.int32)}
    j_dev, j_srv = _np(JS.split_params(jm, params, 1))
    j_aux = _init_aux(jm, tm, jrun.split, trun.split)
    jd, ja, jl = jax.jit(JSt.make_client_round_fn(jm, jrun))(
        j_dev, j_aux, jax.tree.map(jnp.asarray, batches), 0.05)
    td, ta, tl = TSt.make_client_round_fn(tm, trun)(
        from_numpy_tree(j_dev), from_numpy_tree(j_aux),
        from_numpy_tree(batches), 0.05)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _close_trees(to_numpy_tree((td, ta)), _np((jd, ja)), GRAD_TOL)

    acts = rng.normal(size=(4,) + tuple(tm.activation_spec(
        1, split_point=1, dtype="float32").shape[1:])).astype(np.float32)
    batch = {"acts": acts, "labels": rng.integers(0, 10, (4,)).astype(
        np.int32)}
    j_state, jm_ = jax.jit(JSt.make_server_train_step(jm, jrun))(
        JSt.init_server_state(jm, jrun, j_srv),
        jax.tree.map(jnp.asarray, batch))
    t_state, tm_ = TSt.make_server_train_step(tm, trun)(
        TSt.init_server_state(tm, trun, from_numpy_tree(j_srv)),
        from_numpy_tree(batch))
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    _close_trees(to_numpy_tree(t_state["server"]), _np(j_state["server"]),
                 GRAD_TOL)


# ---------------------------------------------------------------------------
# (h) split sizes, FLOPs and times for the eight vision configs
# ---------------------------------------------------------------------------

SIZE_CASES = [(a, smoke) for a in ARCHS for smoke in (True, False)]


@pytest.mark.parametrize("arch,smoke", SIZE_CASES)
def test_split_sizes_flops_and_times_equal_reference(arch, smoke):
    jcfg, tcfg = _cfgs(arch, smoke)
    jm, tm = j_build(jcfg), t_build(tcfg)
    L = jcfg.num_layers
    tt, jt = TCM.TimeModel(), JCM.TimeModel()
    for p in sorted({1, L // 2, L - 1}):
        jsc, tsc = JSplit(split_point=p), TSplit(split_point=p)
        js, ts = JCM.split_sizes(jm, jsc), TCM.split_sizes(tm, tsc)
        assert _fields(ts) == _fields(js), p
        assert ts.act_per_sample == math.prod(tm.activation_spec(
            1, split_point=p, dtype="float32").shape) * 4 + 4
        assert TCM.split_sizes(tm, tsc, act_dtype_bytes=1).act_per_sample \
            == ts.act_per_sample - 3 * (ts.act_per_sample - 4) // 4
        for algo in ("ampere", "fedavg", "splitfed", "pipar", "scaffold",
                     "splitgp"):
            assert TCM.device_flops_per_sample(tm, tsc, algo, sizes=ts) == \
                JCM.device_flops_per_sample(jm, jsc, algo, sizes=js), algo
            kw = dict(n_samples=512, batch_size=16)
            assert TCM.epoch_time(algo, tm, tsc, tt, sizes=ts, **kw) == \
                JCM.epoch_time(algo, jm, jsc, jt, sizes=js, **kw), algo
            assert TCM.epoch_time_parts(algo, tm, tsc, tt, sizes=ts, **kw) \
                == JCM.epoch_time_parts(algo, jm, jsc, jt, sizes=js, **kw)
            assert TCM.comm_volume(algo, ts, epochs=3, n_samples=512,
                                   device_epochs=2) == \
                JCM.comm_volume(algo, js, epochs=3, n_samples=512,
                                device_epochs=2), algo
        assert TCM.ampere_server_epoch_time(tm, tsc, tt, n_samples=512,
                                            sizes=ts) == \
            JCM.ampere_server_epoch_time(jm, jsc, jt, n_samples=512,
                                         sizes=js)
    assert all(t.device.type == "meta"
               for t in tree_leaves(TCM.abstract_params(tm)))


def _fields(s):
    return (s.device, s.aux, s.server, s.act_per_sample, s.per_layer,
            s.head, s.embed)
