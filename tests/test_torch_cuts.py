"""The port's heterogeneous-cut pieces against the reference's, without a
full run: the cut policy's checks, the resolved assignment, the split
with an extended loose region and the merge back, the server block
entered at a deeper cut (forward and two momentum steps, the skipped
layers included), the prefix FedAvg, the store's cut buckets, latency
priced per class and a scheduler trace with a cut map (the same bytes),
and the fleet buckets' independence from each other.

Tolerance (fp32 smoke configs, the port's plain versions against the
JAX ``"xla"`` path): 1e-4 of each leaf's scale, as
``tests/test_torch_split_aux.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import FedConfig as JFed
from repro.configs.base import OptimConfig as JOptim
from repro.configs.base import RunConfig as JRun
from repro.core import aggregation as j_agg
from repro.core import splitting as JS
from repro.core import steps as JSt
from repro.data.activation_store import ActivationStore as JStore
from repro.fleet import FleetConfig as JFleet
from repro.fleet import FleetScheduler as JScheduler
from repro.fleet import make_latency_fn as j_latency
from repro.fleet import sample_population as j_population
from repro.fleet.cuts import CutPolicy as JCut
from repro.fleet.cuts import resolve_cuts as j_resolve_cuts
from repro.models import build_model as j_build
from repro_torch.configs import registry
from repro_torch.configs.base import FedConfig, OptimConfig, RunConfig
from repro_torch.core import aggregation, splitting, steps
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import ActivationStore, federate, make_dataset_for_model
from repro_torch.fleet import (CutPolicy, FleetConfig, FleetEngine,
                               FleetScheduler, make_latency_fn,
                               resolve_cuts, sample_population)
from repro_torch.fleet.cuts import CutAssignment
from repro_torch.interop import from_numpy_tree, to_numpy_tree, tree_map
from repro_torch.models import build_model

FED = dict(num_clients=8, clients_per_round=4, local_steps=2,
           device_batch_size=4, server_batch_size=8)
OPTIM = dict(name="momentum", lr=0.2, schedule="inverse_time",
             decay_gamma=0.005)
MIX = (("jetson-fast", 0.4), ("jetson-slow", 0.3), ("phone-3g", 0.3))
B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _runs(arch, **split):
    return (JRun(arch=arch, fed=JFed(**FED), optim=JOptim(**OPTIM),
                 **({"split": dataclasses.replace(JRun().split, **split)}
                    if split else {})),
            RunConfig(arch=arch, fed=FedConfig(**FED),
                      optim=OptimConfig(**OPTIM),
                      **({"split": dataclasses.replace(RunConfig().split,
                                                       **split)}
                         if split else {})))


@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = j_build(j_registry.get_smoke_config(arch))
    tm = build_model(registry.get_smoke_config(arch))
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return jm, tm, params


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _assert_trees(t_tree, j_tree, *, exact=False, tol=1e-4):
    """Same paths; leaves equal, or within ``tol`` of each leaf's scale."""
    t_flat = dict(_flat(to_numpy_tree(t_tree)))
    j_flat = dict(_flat(jax.tree.map(np.asarray, j_tree)))
    assert t_flat.keys() == j_flat.keys()
    for k, b in j_flat.items():
        if exact:
            np.testing.assert_array_equal(t_flat[k], b, err_msg=k)
        else:
            scale = max(1e-3, float(np.abs(b).max()))
            np.testing.assert_allclose(t_flat[k], b, rtol=tol,
                                       atol=tol * scale, err_msg=k)


# ---------------------------------------------------------------------------
# the policy and its resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,num_layers", [
    ({}, None), ({}, 28),
    (dict(mode="per_profile", overrides=(("phone-3g", 2),)), 4),
    (dict(mode="per_profile", min_cut=2, max_cut=3), 4),
    (dict(mode="adaptive", objective="bytes"), None),
    (dict(min_cut=0, max_cut=-1), None),
    (dict(min_cut=3, max_cut=2), 4),
    (dict(min_cut=5, max_cut=6), 4),
    (dict(overrides=(("pager", 1), ("phone-3g", 0))), None),
    (dict(overrides=(("phone-3g", 9),)), 4),
], ids=["default", "default_28", "overrides", "range", "mode_objective",
        "negative", "inverted", "too_deep", "unknown_class", "override_deep"])
def test_cut_policy_validate_matches_reference(kw, num_layers):
    problems = CutPolicy(**kw).validate(num_layers)
    assert problems == JCut(**kw).validate(num_layers)
    assert bool(problems) == (kw not in (
        {}, dict(mode="per_profile", overrides=(("phone-3g", 2),)),
        dict(mode="per_profile", min_cut=2, max_cut=3)))


@pytest.mark.parametrize("arch,seq", [("mobilenet-l", 0), ("qwen3-1.7b", 32)])
@pytest.mark.parametrize("kw", [
    dict(mode="static"), dict(mode="per_profile"),
    dict(mode="per_profile", overrides=(("phone-3g", 2),)),
    dict(mode="per_profile", min_cut=2, overrides=(("jetson-slow", 1),)),
], ids=["static", "uniform", "overrides", "min_cut"])
def test_resolve_cuts_matches_reference(arch, seq, kw):
    jm, tm, _ = _models(arch)
    j_run, t_run = _runs(arch)
    fleet = dict(n_devices=8, seed=1, class_mix=MIX)
    t = resolve_cuts(CutPolicy(**kw), tm, t_run, FleetConfig(**fleet),
                     seq_len=seq)
    j = j_resolve_cuts(JCut(**kw), jm, j_run, JFleet(**fleet), seq_len=seq)
    assert (t.by_class, t.by_client, t.depths, t.uniform) == \
        (j.by_class, j.by_client, j.depths, j.uniform)
    assert t.summary() == j.summary()
    if "overrides" in kw:
        assert not t.uniform and t.cut_of(1) == j.cut_of(1)
    # without a fleet every class is the split point, and no client
    empty = resolve_cuts(CutPolicy(**kw), tm, t_run, None, seq_len=seq)
    assert empty.summary() == j_resolve_cuts(
        JCut(**kw), jm, j_run, None, seq_len=seq).summary()


# ---------------------------------------------------------------------------
# split / merge and the server block entered deeper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,p,loose_until", [
    ("qwen3-1.7b", 1, 3), ("qwen3-1.7b", 1, 2), ("gemma2-2b", 1, 3),
    ("gemma2-2b", 1, 2), ("mobilenet-l", 1, 3)])
def test_split_loose_until_and_merge_match_reference(arch, p, loose_until):
    jm, tm, params = _models(arch)
    j_dev, j_srv = JS.split_params(jm, params, p, loose_until=loose_until)
    t_params = from_numpy_tree(params)
    t_dev, t_srv = splitting.split_params(tm, t_params, p,
                                          loose_until=loose_until)
    _assert_trees(t_dev, j_dev, exact=True)
    _assert_trees(t_srv, j_srv, exact=True)
    if tm.kind == "lm":
        period = tm.cfg.pattern_period
        q = -(-max(p, loose_until) // period) * period
        assert len(t_srv["layers_head"]) == min(q, tm.cfg.num_layers) - p
    # the merge reads only the first p layers of an oversized stack
    deep, _ = splitting.split_params(tm, t_params, loose_until)
    merged = splitting.merge_params(tm, deep, t_srv, p)
    merged = dict(merged, head=t_params["head"]) if "head" in t_params \
        else {k: v for k, v in merged.items() if k != "head"}
    _assert_trees(merged, params, exact=True)
    _assert_trees(splitting.merge_params(tm, deep, t_srv, p),
                  JS.merge_params(jm, JS.split_params(jm, params,
                                                      loose_until)[0],
                                  j_srv, p), exact=True)


@pytest.mark.parametrize("arch,loose_until,entry", [
    ("qwen3-1.7b", None, 2), ("qwen3-1.7b", 1, 2), ("gemma2-2b", 2, 3)])
def test_entry_inside_the_scan_raises_as_reference(arch, loose_until, entry):
    jm, tm, params = _models(arch)
    _, j_srv = JS.split_params(jm, params, 1, loose_until=loose_until)
    _, t_srv = splitting.split_params(tm, from_numpy_tree(params), 1,
                                      loose_until=loose_until)
    acts = np.zeros((1, 4, tm.cfg.d_model), np.float32)
    with pytest.raises(ValueError, match="inside the scanned stack") as j:
        JS.server_forward(jm, j_srv, jnp.asarray(acts), 1, entry=entry)
    with pytest.raises(ValueError, match="inside the scanned stack") as t:
        splitting.server_forward(tm, t_srv, torch.as_tensor(acts), 1,
                                 entry=entry)
    assert str(t.value) == str(j.value)


def _server_inputs(arch, seed):
    jm, tm, params = _models(arch)
    rng = np.random.default_rng(seed)
    if tm.kind == "lm":
        acts = rng.normal(size=(B, S, tm.cfg.d_model)).astype(np.float32)
        labels = {"tokens": rng.integers(0, tm.cfg.vocab_size,
                                         (B, S)).astype(np.int32)}
    else:
        jd, _ = JS.split_params(jm, params, 2)
        images = rng.normal(size=(B, 32, 32, 3)).astype(np.float32)
        acts = np.array(JS.device_forward(jm, jd, jnp.asarray(images), 2))
        labels = {"labels": rng.integers(0, 10, (B,)).astype(np.int32)}
    return jm, tm, params, acts, labels


ENTRY_CASES = [("qwen3-1.7b", 1, 2, 2), ("qwen3-1.7b", 1, 3, 2),
               ("gemma2-2b", 1, 3, 3), ("gemma2-2b", 1, 2, 2),
               ("mobilenet-l", 1, None, 2)]


@pytest.mark.parametrize("arch,p,loose_until,entry", ENTRY_CASES)
def test_server_forward_entry_matches_reference(arch, p, loose_until, entry):
    jm, tm, params, acts, _ = _server_inputs(arch, entry)
    _, j_srv = JS.split_params(jm, params, p, loose_until=loose_until)
    _, t_srv = splitting.split_params(tm, from_numpy_tree(params), p,
                                      loose_until=loose_until)
    j_out = JS.server_forward(jm, j_srv, jnp.asarray(acts), p, entry=entry)
    with torch.no_grad():
        t_out = splitting.server_forward(tm, t_srv, torch.as_tensor(acts), p,
                                         entry=entry)
    key = "hidden" if tm.kind == "lm" else "logits"
    scale = float(np.abs(np.asarray(j_out[key])).max())
    np.testing.assert_allclose(t_out[key].numpy(), np.asarray(j_out[key]),
                               rtol=1e-4, atol=1e-4 * scale)
    # entering at the split point is the plain server forward
    with torch.no_grad():
        plain = splitting.server_forward(tm, t_srv, torch.as_tensor(acts), p)
        at_p = splitting.server_forward(tm, t_srv, torch.as_tensor(acts), p,
                                        entry=p)
    assert torch.equal(plain[key], at_p[key])


@pytest.mark.parametrize("arch,p,loose_until,entry", ENTRY_CASES)
def test_server_step_entry_matches_reference(arch, p, loose_until, entry):
    """Two momentum steps, the first entering at the split point and the
    second at ``entry``: the skipped layers get zero gradients in the
    second, and their momentum from the first still moves them."""
    jm, tm, params, acts, labels = _server_inputs(arch, entry)
    j_run, t_run = _runs(arch, split_point=p)
    _, j_srv = JS.split_params(jm, params, p, loose_until=loose_until)
    _, t_srv = splitting.split_params(tm, from_numpy_tree(params), p,
                                      loose_until=loose_until)
    batch = dict(labels, acts=acts)
    j_state = JSt.init_server_state(jm, j_run, j_srv)
    t_state = steps.init_server_state(tm, t_run, t_srv)
    losses = []
    for e in (None, entry):
        j_state, jm_ = jax.jit(JSt.make_server_train_step(jm, j_run,
                                                          entry=e))(
            j_state, jax.tree.map(jnp.asarray, batch))
        t_state, tm_ = steps.make_server_train_step(tm, t_run, entry=e)(
            t_state, from_numpy_tree(batch))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        losses.append(float(tm_["loss"]))
    _assert_trees(t_state["server"], j_state["server"])
    # a layer below the entry moved in the second step by its momentum
    key = "layers_head" if tm.kind == "lm" else "layers"
    skipped = [dict(_flat(to_numpy_tree(t_state["server"][key][k])))
               for k in range(entry - p)]
    before = [dict(_flat(to_numpy_tree(t_srv[key][k])))
              for k in range(entry - p)]
    assert skipped and any(not np.array_equal(a[k], b[k])
                           for a, b in zip(skipped, before) for k in a)


# ---------------------------------------------------------------------------
# aggregation, the store, pricing
# ---------------------------------------------------------------------------


def _tree(rng, n_layers):
    return {"embed": {"table": rng.normal(size=(5, 3)).astype(np.float32)},
            "layers": [{"w": rng.normal(size=(3, 2)).astype(np.float32),
                        "b": rng.normal(size=(2,)).astype(np.float32)}
                       for _ in range(n_layers)]}


@pytest.mark.parametrize("weights", [
    {1: 1.0, 2: 1.0, 4: 2.0}, {1: 0.25, 2: 0.0, 4: 0.75},
    {1: 1.0, 2: 0.0, 4: 0.0}, {2: 3.0}, {1: 0.0, 2: 0.0, 4: 0.0}],
    ids=["all", "zero_middle", "shallow_only", "one_bucket", "none"])
def test_prefix_fedavg_matches_reference(weights):
    rng = np.random.default_rng(0)
    current = _tree(rng, 4)
    by_depth = {d: _tree(rng, d) for d in weights}
    t = aggregation.prefix_fedavg(
        from_numpy_tree(current),
        {d: from_numpy_tree(v) for d, v in by_depth.items()}, weights)
    j = j_agg.prefix_fedavg(jax.tree.map(jnp.asarray, current),
                            {d: jax.tree.map(jnp.asarray, v)
                             for d, v in by_depth.items()}, weights)
    _assert_trees(t, j, tol=1e-6)
    owners = [d for d in weights if weights[d] > 0]
    for l in range(4):
        if not any(d > l for d in owners):   # no bucket covers it
            np.testing.assert_array_equal(t["layers"][l]["w"].numpy(),
                                          current["layers"][l]["w"])


@pytest.mark.parametrize("kind", ["cnn", "lm"])
@pytest.mark.parametrize("quantize", [False, True])
def test_store_cut_buckets_match_reference(kind, quantize):
    """Shards of different depths never share a pool.  An LM's
    activations have one shape at every depth, so only the tags keep the
    buckets apart."""
    rng = np.random.default_rng(1)
    shape = {1: (4, 2, 2, 3), 2: (3, 1, 1, 5)} if kind == "cnn" \
        else {1: (4, 8, 16), 2: (3, 8, 16)}
    label = "labels" if kind == "cnn" else "tokens"
    shards = [(0, 1, 0.0), (1, 2, 10.0), (0, 1, 20.0), (2, 2, 30.0),
              (3, None, 40.0)]
    t = ActivationStore(quantize_int8=quantize, seed=3)
    j = JStore(quantize_int8=quantize, seed=3)
    for cid, cut, offset in shards:
        n = shape[cut or 1][0]
        shard = {"acts": (offset + rng.normal(size=shape[cut or 1])).astype(
                     np.float32),
                 label: rng.integers(0, 9, (n,) if kind == "cnn"
                                     else (n, 8)).astype(np.int32)}
        t.add(cid, shard, cut=cut)
        j.add(cid, shard, cut=cut)
    assert t.cut_depths() == j.cut_depths() == [1, 2]
    assert t.bytes_received == j.bytes_received
    for cut in (None, 1, 2):
        assert t.num_samples(cut=cut) == j.num_samples(cut=cut)
        np.testing.assert_array_equal(t.epoch_indices(2, cut=cut),
                                      j.epoch_indices(2, cut=cut))
        if cut is None and kind == "cnn":
            continue      # shapes differ across depths: no one pool
        tp, jp = t.pool(cut=cut), j.pool(cut=cut)
        assert tp.keys() == jp.keys()
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k])
    assert t.num_samples(cut=1) == 8 and t.num_samples(cut=2) == 6
    for cid in range(4):
        assert t.num_samples(cid, cut=2) == j.num_samples(cid, cut=2)
    # the depth-1 bucket holds only the depth-1 shards (offsets 0, 20)
    acts = t.pool(cut=1)["acts"].astype(np.float32)
    if quantize:
        acts = acts * t.pool(cut=1)["acts_scale"]
    assert acts.max() < 30.0


@pytest.mark.parametrize("arch,seq", [("mobilenet-l", 0), ("qwen3-1.7b", 32)])
def test_latency_fn_with_cuts_matches_reference(arch, seq):
    jm, tm, _ = _models(arch)
    j_run, t_run = _runs(arch)
    cuts = {"jetson-slow": 2, "phone-3g": 3}
    pop = sample_population(FleetConfig(n_devices=12, class_mix=MIX))
    jpop = j_population(JFleet(n_devices=12, class_mix=MIX))
    tl = make_latency_fn(tm, t_run, seq_len=seq, cuts=cuts)
    jl = j_latency(jm, j_run, seq_len=seq, cuts=cuts)
    assert [tl(p) for p in pop] == [jl(p) for p in jpop]
    assert [tl.parts(p) for p in pop] == [jl.parts(p) for p in jpop]
    # a class outside the map prices at the split point
    uniform = make_latency_fn(tm, t_run, seq_len=seq)
    for p in pop:
        assert (tl(p) == uniform(p)) == (p.cls == "jetson-fast")


def test_trace_with_cut_map_saves_the_reference_bytes(tmp_path):
    """Per-class cuts change each profile's latency, and with it the
    straggler deadlines of the sync scheduler."""
    jm, tm, _ = _models("mobilenet-l")
    j_run, t_run = _runs("mobilenet-l")
    kw = dict(n_devices=16, class_mix=MIX, dropout_hazard=0.05,
              deadline_factor=2.0, min_cohort=2, max_cohort=6,
              init_cohort=4, target_round_time_factor=1.05)
    cuts = {"jetson-slow": 2, "phone-3g": 3}
    out = {}
    for side, cfg, pop, sched, lat in (
            ("t", FleetConfig(**kw), sample_population, FleetScheduler,
             make_latency_fn(tm, t_run, cuts=cuts)),
            ("j", JFleet(**kw), j_population, JScheduler,
             j_latency(jm, j_run, cuts=cuts))):
        trace = sched(pop(cfg), lat, cfg).simulate(10)
        trace.save(str(tmp_path / f"{side}.jsonl"))
        out[side] = (trace, (tmp_path / f"{side}.jsonl").read_bytes())
    assert out["t"][1] == out["j"][1]
    uncut = FleetScheduler(sample_population(FleetConfig(**kw)),
                           make_latency_fn(tm, t_run),
                           FleetConfig(**kw)).simulate(10)
    assert [p.round_time for p in uncut.rounds] != \
        [p.round_time for p in out["t"][0].rounds]


# ---------------------------------------------------------------------------
# the fleet buckets share the stack's tensors
# ---------------------------------------------------------------------------


def test_buckets_start_from_the_round_start_state():
    """Both buckets own layer 0 and hold the same tensors of it (the
    prefixes are lists over the stack's own tensors): a bucket's round
    must leave the state it started from as it was, so the next bucket
    starts from the round-start values, and the prefix FedAvg then folds
    layer 0 from both."""
    arch = "qwen3-1.7b"
    _, run = _runs(arch)
    model = build_model(registry.get_smoke_config(arch))
    clients = federate(make_dataset_for_model(model, 32, seed=0, seq_len=16),
                       FED["num_clients"], run.fed.dirichlet_alpha, seed=0)
    cuts = CutAssignment({"a": 1, "b": 2},
                         {c: 1 + c % 2 for c in range(FED["num_clients"])})
    tr = AmpereTrainer(model, run, clients, clients[0].dataset,
                       device="cpu", cuts=cuts)
    dev, _, aux = tr._init_states(torch.Generator().manual_seed(0))
    state = {"device": dev, "aux": aux}
    before = tree_map(torch.clone, state)
    assert len(dev["layers"]) == 2 and aux.keys() == {"p1", "p2"}
    engines = {d: FleetEngine(model, tr._run_by_depth[d], clients,
                              device="cpu") for d in (1, 2)}

    def bucket(st, d, ids):
        return engines[d].run_round(
            {"device": tr._device_prefix(st["device"], d),
             "aux": st["aux"][f"p{d}"]}, 0, ids, [0.5] * len(ids), 0.1,
            pad_to=4)[0]

    shallow = bucket(state, 1, [0, 2])
    deep = bucket(state, 2, [1, 3])
    for (k, a), (_, b) in zip(_flat(state), _flat(before)):
        assert torch.equal(a, b), k
    alone = bucket(tree_map(torch.clone, before), 2, [1, 3])
    for (k, a), (_, b) in zip(_flat(deep), _flat(alone)):
        assert torch.equal(a, b), k
    assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
        _flat(shallow["device"]["layers"][0]),
        _flat(deep["device"]["layers"][0])))
    new = aggregation.prefix_fedavg(
        state["device"], {1: shallow["device"], 2: deep["device"]},
        {1: 1.0, 2: 1.0})
    want = aggregation.fedavg([shallow["device"]["layers"][0],
                               deep["device"]["layers"][0]], [1.0, 1.0])
    for (k, a), (_, b) in zip(_flat(new["layers"][0]), _flat(want)):
        assert torch.equal(a, b), k
    for (k, a), (_, b) in zip(_flat(new["layers"][1]),
                              _flat(deep["device"]["layers"][1])):
        assert torch.equal(a, b), k
