"""The port's distribution layer against the JAX package's.

* ``repro_torch.sharding.rules.param_specs`` equals
  ``repro.sharding.rules.param_specs`` (``tuple(PartitionSpec)``) for every
  assigned arch and the four vision archs, the three strategies, both
  production mesh shapes, params and decode caches (both KV layouts);
* the JAX package's sharding tests mirrored
  (``tests/test_sharding_roofline.py``);
* specs become ``DTensor`` placements on a fake 2x2 mesh;
* ``shard`` is a no-op without a binding (the qwen3 smoke forward bit for
  bit, and a plain tensor passes through a binding);
* the collective counter's ring costs equal
  ``repro.launch.roofline.parse_collectives`` on the same ops;
* ``Roofline`` terms and ``model_flops_estimate`` equal the reference's
  with the same hardware constants.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import registry as j_registry
from repro.core import comm_model as j_comm
from repro.launch import roofline as JRL
from repro.models import build_model as j_build
from repro.models import transformer as JT
from repro.sharding import rules as JSR
from repro_torch.configs import registry as t_registry
from repro_torch.core import comm_model as t_comm
from repro_torch.interop import from_numpy_tree
from repro_torch.launch import roofline as TRL
from repro_torch.models import build_model as t_build
from repro_torch.models import transformer as TT
from repro_torch.sharding import (axis_rules, logical_to_spec, shard,
                                  spec_to_placements)
from repro_torch.sharding import rules as TSR


class FakeMesh:
    """A mesh of the production shape: axis names and a device grid shape
    (``tests/test_sharding_roofline.py``)."""

    def __init__(self, shape, names):
        self.axis_names = names

        class _D:
            pass
        self.devices = _D()
        self.devices.shape = shape
        self.devices.size = int(np.prod(shape))


MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("fsdp_tp", "dp_only", "tp_only")
# params; decode caches with the KV sequence over "model" and the batch
# over dp (decode_32k), or over every axis with no batch axis (long_500k)
TREES = ("params", "cache_kv_model", "cache_kv_all")
CACHE_SHAPES = {"cache_kv_model": (128, 32768), "cache_kv_all": (1, 524288)}
ARCHS = tuple(j_registry.ASSIGNED_ARCHS) + tuple(t_registry.PAPER_ARCHS)


@functools.lru_cache(maxsize=None)
def _trees(arch, kind):
    """(reference abstract tree, port meta tree) of ``arch``."""
    if kind == "params":
        return (j_comm.abstract_params(j_build(j_registry.get_config(arch))),
                t_comm.abstract_params(t_build(t_registry.get_config(arch))))
    B, S = CACHE_SHAPES[kind]
    jcfg = j_registry.get_config(arch)
    j = jax.eval_shape(lambda: JT.init_caches(jcfg, B, S,
                                              kv_dtype="bfloat16"))
    t = TT.init_caches(t_registry.get_config(arch), B, S, device="meta")
    return j, t


def _flat_ref(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {JSR._path_str(p): tuple(s) for p, s in flat}


def _flat_port(specs, path=()):
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_flat_port(v, path + (str(k),)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_flat_port(v, path + (str(i),)))
        return out
    return {"/".join(path): specs}


def _cases():
    for arch in ARCHS:
        lm = arch in j_registry.ASSIGNED_ARCHS
        for kind in (TREES if lm else TREES[:1]):
            for strategy in STRATEGIES:
                for mesh in MESHES:
                    yield arch, kind, strategy, mesh


@pytest.mark.parametrize("arch,kind,strategy,mesh_name", list(_cases()))
def test_param_specs_match_reference(arch, kind, strategy, mesh_name):
    mesh = FakeMesh(*MESHES[mesh_name])
    kw = {"strategy": strategy}
    if kind != "params":
        multi = mesh_name == "multi_pod"
        dp = ("pod", "data") if multi else ("data",)
        kw["cache"] = True
        if kind == "cache_kv_all":
            kw.update(kv_seq_axes=dp + ("model",), batch_axes=())
    j_tree, t_tree = _trees(arch, kind)
    want = _flat_ref(JSR.param_specs(j_tree, mesh, **kw))
    got = _flat_port(TSR.param_specs(t_tree, mesh, **kw))
    assert got and got == want


# ---------------------------------------------------------------------------
# the JAX package's sharding tests, mirrored
# ---------------------------------------------------------------------------


def test_param_specs_divisibility_fallback():
    params = {"embed": {"table": torch.empty((50280, 1024), device="meta")},
              "blocks": {"pos0": {"attn": {"wq": {
                  "w": torch.empty((2, 1024, 2048), device="meta")}}}}}
    specs = TSR.param_specs(params, FakeMesh((16, 16), ("data", "model")),
                            strategy="fsdp_tp")
    # 50280 % 16 != 0 -> vocab axis falls back to replicated
    assert specs["embed"]["table"] == tuple(P(None, ("data",)))
    # stacked attn weight: leading rep dim unsharded, fsdp + tp on the rest
    assert specs["blocks"]["pos0"]["attn"]["wq"]["w"] == \
        tuple(P(None, ("data",), "model"))


def test_shard_noop_without_context():
    x = torch.ones((4, 4))
    assert shard(x, "batch", None) is x


def test_axis_rules_binding():
    mesh = FakeMesh((1,), ("data",))
    with axis_rules({"batch": ("data",)}, mesh):
        assert logical_to_spec("batch", None) == tuple(P("data", None))
    assert logical_to_spec("batch", None) == tuple(P(None, None))


def test_default_axis_rules_and_batch_spec_match_reference():
    for shape, names in MESHES.values():
        mesh = FakeMesh(shape, names)
        assert TSR.batch_spec(mesh, 2) == tuple(JSR.batch_spec(mesh, 2))
        for strategy in STRATEGIES:
            for seq in (True, False):
                assert TSR.default_axis_rules(
                    mesh, sequence_sharding=seq, strategy=strategy) == \
                    JSR.default_axis_rules(mesh, sequence_sharding=seq,
                                           strategy=strategy)


# ---------------------------------------------------------------------------
# placements on a fake 2x2 mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_mesh_2x2():
    from repro_torch.launch.mesh import make_debug_mesh
    assert not dist.is_initialized()
    try:
        yield make_debug_mesh(2, 2)
    finally:
        dist.destroy_process_group()


def test_spec_to_placements_on_fake_mesh(fake_mesh_2x2):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = fake_mesh_2x2
    assert spec_to_placements((None, "data", "model"), mesh) == \
        [Shard(1), Shard(2)]
    assert spec_to_placements(("model", None), mesh) == [Replicate(),
                                                         Shard(0)]
    assert spec_to_placements((("data", "model"),), mesh) == [Shard(0),
                                                              Shard(0)]
    assert spec_to_placements((), mesh) == [Replicate(), Replicate()]
    with pytest.raises(ValueError):
        spec_to_placements(("data", "data"), mesh)
    # a tree of specs, and the local shards the placements give
    params = {"embed": {"table": torch.zeros((8, 6))},
              "blocks": {"pos0": {"attn": {"wq": {"w": torch.zeros(
                  (3, 6, 4))}}}}}
    pl = TSR.to_placements(TSR.param_specs(params, mesh), mesh)
    assert pl["embed"]["table"] == [Shard(1), Shard(0)]
    w = distribute_tensor(params["blocks"]["pos0"]["attn"]["wq"]["w"], mesh,
                          pl["blocks"]["pos0"]["attn"]["wq"]["w"])
    assert tuple(w.to_local().shape) == (3, 3, 2)
    # inside a binding a DTensor is redistributed, a plain tensor is not
    x = distribute_tensor(torch.zeros((4, 6)), mesh,
                          [Replicate(), Replicate()])
    with axis_rules({"batch": ("data",), "vocab": ("model",)}, mesh):
        y = shard(x, "batch", "vocab")
        plain = torch.zeros(2)
        assert shard(plain, "batch") is plain
    assert list(y.placements) == [Shard(0), Shard(1)]
    assert tuple(y.to_local().shape) == (2, 3)


def test_production_mesh_keeps_a_smaller_existing_group(fake_mesh_2x2):
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="4 ranks exists"):
        make_production_mesh()
    assert dist.is_initialized() and dist.get_world_size() == 4
    assert make_debug_mesh(1, 2).size() == 2    # the same group's ranks


def test_shard_noop_bit_for_bit_on_smoke_forward():
    cfg = j_registry.get_smoke_config("qwen3-1.7b")
    params = jax.tree.map(np.asarray,
                          j_build(cfg).init(jax.random.PRNGKey(0)))
    tm = t_build(t_registry.get_smoke_config("qwen3-1.7b"))
    tp = from_numpy_tree(params)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    out = tm.apply(tp, tokens, impl="xla")
    mesh = FakeMesh((16, 16), ("data", "model"))
    with axis_rules(TSR.default_axis_rules(mesh), mesh):
        bound = tm.apply(tp, tokens, impl="xla")
    assert torch.equal(out["logits"], bound["logits"])
    assert torch.equal(out["hidden"], bound["hidden"])


# ---------------------------------------------------------------------------
# collectives and the roofline
# ---------------------------------------------------------------------------

# one reference HLO line a collective, the port issuing the same op with
# the same result size and group size
COLLECTIVE_CASES = [
    ("all-gather", 16, (128, 256), (2048, 256),
     "%ag = f32[2048,256]{1,0} all-gather(%p0), dims={0}, "
     "replica_groups=[1,16]<=[16]"),
    ("all-reduce", 4, (128, 256), (128, 256),
     "%ar = f32[128,256]{1,0} all-reduce(%p0), replica_groups={{0,1,2,3}}, "
     "to_apply=add"),
    ("reduce-scatter", 16, (128, 256), (8, 256),
     "%rs = f32[8,256]{1,0} reduce-scatter(%p0), dimensions={0}, "
     "replica_groups=[1,16]<=[16]"),
    ("all-to-all", 8, (128, 256), (128, 256),
     "%a2a = f32[128,256]{1,0} all-to-all(%p0), replica_groups=[2,8]<=[16]"),
]


@pytest.fixture
def fake_world_16():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield {s: dist.new_group(list(range(s))) for s in (4, 8, 16)}
    finally:
        dist.destroy_process_group()


def _issue(op, group, x):
    import torch.distributed._functional_collectives as fc
    if op == "all-gather":
        return fc.all_gather_tensor(x, 0, group)
    if op == "all-reduce":
        return fc.all_reduce(x, "sum", group)
    if op == "reduce-scatter":
        return fc.reduce_scatter_tensor(x, "sum", 0, group)
    return fc.all_to_all_single(x, None, None, group)


def test_collective_counter_matches_parse_collectives(fake_world_16):
    hlo = "ENTRY e {\n" + "\n".join(
        "  " + c[4] for c in COLLECTIVE_CASES) + "\n}\n"
    want = JRL.parse_collectives(hlo)
    counter = TRL.CollectiveCounter()
    with counter:
        for op, s, shape_in, shape_out, _ in COLLECTIVE_CASES:
            y = _issue(op, fake_world_16[s], torch.zeros(shape_in))
            assert tuple(y.wait().shape) == shape_out
    got = counter.stats
    assert got.counts == want.counts
    assert got.per_device_bytes == pytest.approx(want.per_device_bytes,
                                                 rel=1e-12)
    assert set(got.bytes_by_op) == set(want.bytes_by_op)
    for k, v in want.bytes_by_op.items():
        assert got.bytes_by_op[k] == pytest.approx(v, rel=1e-12)
    # the permute / broadcast cost: the result size
    assert TRL.ring_bytes("collective-permute", 1024, 8) == 1024.0


def test_cost_counter_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.randn(16, 32, requires_grad=True)
    w = torch.randn(32, 48, requires_grad=True)

    def step():
        y = torch.nn.functional.gelu(x @ w)
        s = torch.einsum("ik,jk->ij", y, y).sum()
        return torch.autograd.grad(s, [x, w])

    counter = TRL.CostCounter()
    counter.track((x, w))
    with counter:
        step()
    fcm = FlopCounterMode(display=False)
    with fcm:
        step()
    assert counter.flops == fcm.get_total_flops() > 0
    assert counter.bytes_accessed > 0
    assert counter.peak >= counter.live >= 4 * (16 * 32 + 32 * 48)


def _rooflines(mod):
    return mod.Roofline(arch="x", shape="train_4k", mesh="single_pod",
                        step="server_train_step", chips=256,
                        flops_per_device=3e12, bytes_per_device=4e10,
                        collective_bytes_per_device=1e10,
                        peak_memory_per_device=8e9, model_flops=5e14,
                        collective_counts={"all-gather": 3})


def test_roofline_matches_reference_with_same_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JRL, name, getattr(TRL, name))
    t, j = _rooflines(TRL).row(), _rooflines(JRL).row()
    for k, v in j.items():
        assert t[k] == v, k
    assert t["roofline_seconds"] == max(t["t_compute_ms"], t["t_memory_ms"],
                                        t["t_collective_ms"]) / 1e3


def test_roofline_terms_and_bottleneck():
    r = TRL.Roofline(arch="x", shape="train_4k", mesh="single_pod",
                     step="server_train_step", chips=256,
                     flops_per_device=TRL.PEAK_FLOPS * 0.1,
                     bytes_per_device=TRL.HBM_BW * 0.05,
                     collective_bytes_per_device=TRL.LINK_BW * 0.2,
                     peak_memory_per_device=8e9,
                     model_flops=TRL.PEAK_FLOPS * 256 * 0.05,
                     collective_counts={})
    assert abs(r.t_compute - 0.1) < 1e-9
    assert abs(r.t_memory - 0.05) < 1e-9
    assert abs(r.t_collective - 0.2) < 1e-9
    assert r.bottleneck == "collective"
    assert abs(r.roofline_seconds - 0.2) < 1e-9
    assert 0 < r.roofline_fraction < 1
    assert abs(r.useful_flops_fraction - 0.5) < 1e-9


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m",
                                  "mamba2-370m"])
def test_model_flops_estimate_matches_reference(arch):
    jcfg, tcfg = j_registry.get_config(arch), t_registry.get_config(arch)
    for kind, seq, batch, step in (
            ("train", 4096, 256, "server_train_step"),
            ("train", 4096, 256, "e2e_train_step"),
            ("train", 4096, 256, "device_round_step"),
            ("prefill", 32768, 32, "prefill_step"),
            ("decode", 32768, 128, "decode_step")):
        assert TRL.model_flops_estimate(tcfg, kind, seq, batch, step) == \
            JRL.model_flops_estimate(jcfg, kind, seq, batch, step)


# ---------------------------------------------------------------------------
# remesh and the tree arithmetic
# ---------------------------------------------------------------------------


def test_tree_sub_and_tree_add_match_reference():
    from repro.core import aggregation as JA
    from repro_torch.core import aggregation as TA
    rng = np.random.default_rng(0)
    a = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    b = {"w": rng.normal(size=(3, 4)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    ja, jb = jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b)
    ta, tb = from_numpy_tree(a), from_numpy_tree(b)
    for got, want in ((TA.tree_sub(ta, tb), JA.tree_sub(ja, jb)),
                      (TA.tree_add(ta, tb, 0.5), JA.tree_add(ja, jb, 0.5))):
        g = jax.tree_util.tree_leaves(jax.tree.map(
            np.asarray, {"w": got["w"].numpy(), "b": [got["b"][0].numpy()]}))
        w = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, want))
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x, y)


def test_remesh_places_params_by_the_new_mesh_rules(fake_mesh_2x2):
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.runtime import elastic
    mesh = fake_mesh_2x2
    params = {"embed": {"table": torch.arange(48.0).reshape(8, 6)},
              "final_norm": {"scale": torch.ones(6)}}
    plan = elastic.remesh_plan(params, None, mesh)
    assert plan == TSR.to_placements(TSR.param_specs(params, mesh), mesh)
    moved = elastic.remesh(params, None, mesh)
    table = moved["embed"]["table"]
    assert isinstance(table, DTensor)
    assert list(table.placements) == [Shard(1), Shard(0)]
    assert tuple(table.to_local().shape) == (4, 3)
    # a DTensor already on the mesh is redistributed in place of copied
    again = elastic.remesh(moved, mesh, mesh, strategy="tp_only")
    assert list(again["embed"]["table"].placements) == \
        TSR.to_placements(TSR.param_specs(params, mesh,
                                          strategy="tp_only"), mesh)[
            "embed"]["table"]
