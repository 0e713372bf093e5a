"""The port's synchronous baselines against ``repro.core.baselines``: one
round step of each system (the SFL family and FedAvg) on the
``qwen3-1.7b`` and ``mobilenet-l`` smoke configs, from the reference's own
init carried across by ``from_numpy_tree`` and the same numpy batches
(K 2 clients, H 2 local steps, batch 4, weights 0.6 / 0.4), fp32 on the
CPU.

Trained trees within 1e-5 of each leaf's largest magnitude, floored at
1e-1 of the tree's largest (``tests/test_torch_vision.py``); the round's
loss within 1e-5 relative.  SCAFFOLD's ``c`` and ``c_k`` within 1e-5 of
the same scale, floored in addition at the trained leaf's scale over
H lr: ``c_k' = c_k - c + (x - y) / (H lr)`` carries the trained tree's
error (a last-bit difference of ``y``) amplified by 1 / (H lr).  A
``splitfedv2`` round with a padded zero-weight slot shows that slot
training the shared server in both packages, and ``splitfed_pa`` is
refused, naming its queue item.
"""

import functools

import jax
import numpy as np
import pytest

import torch_experiment_parity as P
from repro.configs import registry as j_registry
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.core import auxiliary as JA
from repro.core import splitting as JS
from repro.core.baselines import fedavg as JF
from repro.core.baselines import sfl_family as JSFL
from repro.data import make_dataset_for_model as j_dataset
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core.baselines import fedavg as TF
from repro_torch.core.baselines import sfl_family as TSFL
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.models import build_model as t_build

ARCHS = ("qwen3-1.7b", "mobilenet-l")
SFL = ("splitfed", "splitfed_mb", "splitfedv2", "splitgp", "scaffold",
       "pipar")
K, H, B, SEQ = 2, 2, 4, 16
FED = dict(num_clients=4, clients_per_round=K, local_steps=H,
           device_batch_size=B, seed=0)
OPTIM = dict(name="sgd", lr=0.1)
LR = 0.1
WEIGHTS = [0.6, 0.4]
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _close_trees(got, want, tol=TOL, floors=None):
    """Leaf by leaf within ``tol`` of its largest magnitude, that scale
    floored at 1e-1 of the tree's largest and at the leaf's entry of
    ``floors`` (a tree of scalars) where given."""
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    fl = (jax.tree_util.tree_leaves(floors) if floors is not None
          else [0.0] * len(w))
    assert len(fl) == len(w)
    top = max([float(np.abs(b).max()) for _, b in w if np.size(b)] + [0.0])
    for (path, a), (_, b), f in zip(g, w, fl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        scale = max(1e-6, 1e-1 * top, float(np.abs(b).max()), float(f))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference model, port model, reference run config, port run config,
    numpy init {"params", "aux"}, numpy batches (K, H, B, ...))."""
    jm = j_build(j_registry.get_smoke_config(arch))
    tm = t_build(t_registry.get_smoke_config(arch))
    j_run = JRun(arch=arch, fed=JFed(**FED), optim=JOptim(**OPTIM))
    t_run = TRun(arch=arch, fed=TFed(**FED), optim=TOptim(**OPTIM))
    key = jax.random.PRNGKey(0)
    init = {"params": jax.jit(jm.init)(key),
            "aux": jax.jit(lambda k: JA.init_aux(jm, k, j_run.split))(
                jax.random.fold_in(key, 3))}
    init = jax.tree.map(np.array, init)
    kw = {"seq_len": SEQ} if jm.kind == "lm" else {}
    data = j_dataset(jm, K * H * B, seed=0, **kw).arrays
    batches = {k: v.reshape((K, H, B) + v.shape[1:]) for k, v in data.items()}
    return jm, tm, j_run, t_run, init, batches


@functools.lru_cache(maxsize=None)
def _j_step(arch, variant):
    """The reference's round step, compiled once per (arch, variant)."""
    jm, _, j_run, *_ = _setup(arch)
    if variant == "fedavg":
        return jax.jit(JF.make_fedavg_round_step(jm, j_run))
    return jax.jit(JSFL.make_sfl_round_step(jm, j_run, variant))


def _state(arch, variant):
    """The variant's initial state as numpy, split as the reference
    splits it."""
    jm, _, j_run, _, init, _ = _setup(arch)
    if variant == "fedavg":
        return init["params"]
    dev, srv = JS.split_params(jm, init["params"], j_run.split.split_point)
    state = {"device": dev, "server": srv}
    if variant == "splitgp":
        state["aux"] = init["aux"]
    return jax.tree.map(np.array, state)


def _controls(arch):
    """Nonzero SCAFFOLD controls from a seed: ``c`` and the cohort's
    ``c_k`` (K, ...), so the correction ``g - c_k + c`` is exercised."""
    st = _state(arch, "scaffold")
    rng = np.random.default_rng(1)
    par = (st["device"], st["server"])
    c = jax.tree.map(
        lambda x: (1e-2 * rng.standard_normal(x.shape)).astype(np.float32),
        par)
    c_k = jax.tree.map(
        lambda x: (1e-2 * rng.standard_normal((K,) + x.shape)
                   ).astype(np.float32), par)
    return c, c_k


def _both(arch, variant, weights=WEIGHTS):
    """(port outputs, reference outputs), each as numpy trees."""
    _, tm, _, t_run, _, batches = _setup(arch)
    state = _state(arch, variant)
    j_step = _j_step(arch, variant)
    if variant == "fedavg":
        t_step = TF.make_fedavg_round_step(tm, t_run)
    else:
        t_step = TSFL.make_sfl_round_step(tm, t_run, variant)
    j_args = (batches, np.asarray(weights, np.float32), LR)
    if variant == "scaffold":
        controls = _controls(arch)
        j_out = j_step(state, controls, *j_args)
        t_out = t_step(from_numpy_tree(state), from_numpy_tree(controls),
                       from_numpy_tree(batches), weights, LR)
    else:
        j_out = j_step(state, *j_args)
        t_out = t_step(from_numpy_tree(state), from_numpy_tree(batches),
                       weights, LR)
    return to_numpy_tree(t_out), jax.tree.map(np.asarray, j_out)


@pytest.mark.parametrize("variant", SFL + ("fedavg",))
@pytest.mark.parametrize("arch", ARCHS)
def test_round_step_matches_reference(arch, variant):
    t_out, j_out = _both(arch, variant)
    _close_trees(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[-1]["loss"], j_out[-1]["loss"],
                               rtol=TOL)
    if variant == "scaffold":
        (t_c, t_ck), (j_c, j_ck) = t_out[1], j_out[1]
        trained = (j_out[0]["device"], j_out[0]["server"])
        floors = jax.tree.map(lambda y: float(np.abs(y).max()) / (H * LR),
                              trained)
        _close_trees(t_c, j_c, floors=floors)
        _close_trees(t_ck, j_ck, floors=floors)
    # the round trained: most leaves moved away from the init
    before = jax.tree_util.tree_leaves(_state(arch, variant))
    after = jax.tree_util.tree_leaves(t_out[0])
    assert sum(not np.array_equal(a, b) for a, b in zip(before, after)) \
        > len(before) // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_splitfedv2_padded_slot_trains_the_server(arch):
    """A cohort of one survivor padded to two slots (weights 1, 0): the
    device block is the survivor's alone, but the shared server has also
    trained on the padded slot's batches — in both packages."""
    t_out, j_out = _both(arch, "splitfedv2", weights=[1.0, 0.0])
    _close_trees(t_out[0], j_out[0])
    np.testing.assert_allclose(t_out[1]["loss"], j_out[1]["loss"],
                               rtol=TOL)
    # one slot only: the server the survivor alone would leave
    _, tm, _, t_run, _, batches = _setup(arch)
    one = TSFL.make_sfl_round_step(tm, t_run, "splitfedv2")(
        from_numpy_tree(_state(arch, "splitfedv2")),
        from_numpy_tree({k: v[:1] for k, v in batches.items()}), [1.0], LR)
    one = to_numpy_tree(one[0])
    _close_trees(t_out[0]["device"], one["device"], tol=0.0)
    for got in (t_out[0]["server"], j_out[0]["server"]):
        moved = [not np.allclose(a, b, rtol=0, atol=1e-7) for a, b in zip(
            jax.tree_util.tree_leaves(got),
            jax.tree_util.tree_leaves(one["server"]))]
        assert sum(moved) > len(moved) // 2


def test_splitfed_pa_is_refused():
    _, tm, _, t_run, _, _ = _setup("qwen3-1.7b")
    with pytest.raises(ValueError, match="queue A5"):
        TSFL.make_sfl_round_step(tm, t_run, "splitfed_pa")
    with pytest.raises(ValueError, match="unknown SFL variant"):
        TSFL.make_sfl_round_step(tm, t_run, "nope")
