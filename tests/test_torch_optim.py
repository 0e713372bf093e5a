"""Port optimizers, schedules and aggregation against the JAX package:
same params, grads and config, three updates; fp32 tolerance 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig, OptimConfig
from repro.core import aggregation as JAg
from repro.optim import make_optimizer as j_make, make_schedule as j_sched
from repro_torch.configs.base import FedConfig as TFed
from repro_torch.configs.base import OptimConfig as TOptim
from repro_torch.core import aggregation as TAg
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.optim import make_optimizer as t_make
from repro_torch.optim import make_schedule as t_sched

OPTS = [dict(name="sgd", weight_decay=0.01), dict(name="momentum"),
        dict(name="adam"), dict(name="adamw", weight_decay=0.05),
        dict(name="momentum", master_weights=True)]


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(0, 1, (4, 3)).astype(np.float32)},
            "layers": [{"b": rng.normal(0, 1, (5,)).astype(np.float32)}]}


@pytest.mark.parametrize("kw", OPTS, ids=lambda k: "-".join(map(str, k.values())))
def test_optimizer_updates_match_jax(kw):
    params = _tree(0)
    j_opt, t_opt = j_make(OptimConfig(**kw)), t_make(TOptim(**kw))
    jp, tp = jax.tree.map(jnp.asarray, params), from_numpy_tree(params)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for step in range(3):
        grads = _tree(10 + step)
        jp, js = j_opt.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.1)
        tp, ts = t_opt.update(from_numpy_tree(grads), ts, tp, 0.1)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6,
                                                         atol=1e-6),
                 to_numpy_tree(tp), jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("name", ["constant", "inverse_time", "cosine",
                                  "warmup_cosine"])
def test_schedules_match_jax(name):
    cfg = dict(schedule=name, lr=0.2, decay_gamma=0.005, warmup_steps=3,
               total_steps=20)
    j, t = j_sched(OptimConfig(**cfg)), t_sched(TOptim(**cfg))
    for step in (0, 1, 2, 5, 19, 30):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6)


def test_cohort_sampling_and_fedavg_match_jax():
    fed = dict(num_clients=12, clients_per_round=5, drop_prob=0.3,
               straggler_deadline_factor=1.1)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for rnd in range(4):
        jc = JAg.sample_cohort(jr, FedConfig(**fed), rnd)
        tc = TAg.sample_cohort(tr, TFed(**fed), rnd)
        for k in jc:
            np.testing.assert_array_equal(tc[k], jc[k])
    ids, w = TAg.pad_cohort([3, 1], [0.5, 0.5], 4)
    assert (ids, w) == JAg.pad_cohort([3, 1], [0.5, 0.5], 4)
    trees = [_tree(s) for s in range(4)]
    want = JAg.fedavg_stacked(
        jax.tree.map(lambda *xs: jnp.stack(xs), *trees), jnp.asarray(w))
    got = TAg.fedavg_stacked([from_numpy_tree(t) for t in trees], w)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-6,
                                                         atol=1e-7),
                 to_numpy_tree(got), jax.tree.map(np.asarray, want))
