"""The port's end-to-end step, vocab-sharded cross-entropy and one sharded
server step, held to the JAX package.

* ``make_e2e_train_step`` / ``init_e2e_state``: 3 steps (warmup + cosine
  schedule, global-norm clipping) on the qwen3 smoke config with adamw
  (the port's kernel route and the dry-run's ``impl="xla"`` +
  ``xent_impl="sharded"`` route) and on the vgg11 smoke config with
  momentum (its conv biases feed batch norms: their gradients are
  rounding noise, which Adam's normalized step would amplify), from the
  same converted params and numpy batches as the reference's ``"xla"``
  step: losses rtol 1e-5, every param after 3 steps within 1e-4 of its
  leaf's scale (fp32 smoke configs).
* ``cross_entropy(impl="sharded")`` against the reference's ``"sharded"``
  (no mesh) and ``"ref"``: loss rtol 1e-5, dh and dw within 1e-5 of their
  scale; with softcap, with a mask, and over a vocabulary padded to the
  vocab-shard count (a binding, plain tensors); ``impl="xla"`` (the
  blockwise loss the dry-run costs the device round on) against the
  reference's ``"xla"`` and ``"ref"`` at the same vocab tile, the last
  tile padded, with the same tolerances.
* A gloo world-4 run in a subprocess (2x2 ``DeviceMesh`` on the CPU, real
  values): one qwen3 smoke server step with ``fsdp_tp`` placements, the
  dry-run's bindings and ``xent_impl="sharded"`` over the odd vocabulary
  (269, padded to 270): loss and updated params within 1e-5 of the
  unsharded port step, and so of the reference's step (1e-5 loss, 1e-4
  params).
"""

import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import (OptimConfig as JOpt, RunConfig as JRun,
                                ShardingConfig as JShard)
from repro.core import splitting as JS
from repro.core import steps as JSt
from repro.kernels.xent import ops as JX
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import (OptimConfig as TOpt, RunConfig as TRun,
                                      ShardingConfig as TShard)
from repro_torch.core import steps as TSt
from repro_torch.interop import from_numpy_tree, to_numpy_tree
from repro_torch.kernels.xent import ops as TX
from repro_torch.models import build_model as t_build
from repro_torch.sharding import axis_rules

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = 3
OPTIM = dict(lr=1e-3, schedule="warmup_cosine", warmup_steps=2,
             total_steps=10, grad_clip=1.0, weight_decay=0.01)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, kind, rng):
    if kind == "lm":
        return [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
            np.int32)} for _ in range(STEPS)]
    return [{"images": rng.normal(size=(4, cfg.img_size, cfg.img_size,
                                        cfg.in_channels)).astype(np.float32),
             "labels": rng.integers(0, cfg.num_classes, (4,)).astype(
                 np.int32)} for _ in range(STEPS)]


def _assert_close_trees(got, want, tol):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w]
    for (path, a), (_, b) in zip(g, w):
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                                   err_msg=jax.tree_util.keystr(path))


E2E_CASES = [("qwen3-1.7b", "adamw", "kernel", "kernel"),
             ("qwen3-1.7b", "adamw", "xla", "sharded"),
             ("vgg11", "momentum", "kernel", "kernel")]


@pytest.mark.parametrize("arch,opt,impl,xent_impl", E2E_CASES)
def test_e2e_train_step_history_matches_reference(arch, opt, impl,
                                                  xent_impl):
    jcfg = j_registry.get_smoke_config(arch)
    jm = j_build(jcfg)
    tm = t_build(t_registry.get_smoke_config(arch))
    jrun = JRun(optim=JOpt(name=opt, **OPTIM), sharding=JShard(remat="block"))
    trun = TRun(optim=TOpt(name=opt, **OPTIM), sharding=TShard(remat="block"))
    params = _np(jm.init(jax.random.PRNGKey(0)))
    batches = _batches(jcfg, jm.kind, np.random.default_rng(1))

    jstep = jax.jit(JSt.make_e2e_train_step(jm, jrun))
    jstate = JSt.init_e2e_state(jm, jrun, jax.tree.map(jnp.asarray, params))
    tstep = TSt.make_e2e_train_step(tm, trun, impl=impl, xent_impl=xent_impl)
    tstate = TSt.init_e2e_state(tm, trun, from_numpy_tree(params))
    for b in batches:
        jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm_ = tstep(tstate, from_numpy_tree(b))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        assert tm_["lr"] == pytest.approx(float(jm_["lr"]), rel=1e-6)
        if "acc" in jm_:
            assert float(tm_["acc"]) == pytest.approx(float(jm_["acc"]))
    assert tstate["step"] == int(jstate["step"]) == STEPS
    _assert_close_trees(to_numpy_tree(tstate["params"]),
                        _np(jstate["params"]), 1e-4)


# ---------------------------------------------------------------------------
# vocab-sharded cross-entropy
# ---------------------------------------------------------------------------


class _ModelMesh:
    """A ("model",) mesh of ``n`` shards: names and a device grid shape."""

    def __init__(self, n):
        self.axis_names = ("model",)

        class _D:
            shape = (n,)
        self.devices = _D()


def _xent_inputs(V, seed, masked):
    rng = np.random.default_rng(seed)
    T_, D = 24, 16
    h = rng.normal(size=(T_, D)).astype(np.float32)
    w = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    labels = rng.integers(0, V, (T_,)).astype(np.int32)
    mask = (rng.random(T_) > 0.3).astype(np.float32) if masked else None
    return h, w, labels, mask


def _jax_xent(h, w, labels, mask, softcap, impl, block=2048):
    def f(h, w):
        return JX.cross_entropy(h, w, jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask),
                                softcap=softcap, impl=impl, block=block)[0]
    loss, (dh, dw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    return float(loss), np.asarray(dh), np.asarray(dw)


def _port_xent(h, w, labels, mask, softcap, impl="sharded", block=2048):
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    loss, _ = TX.cross_entropy(th, tw, torch.tensor(labels),
                               None if mask is None else torch.tensor(mask),
                               softcap=softcap, impl=impl, block=block)
    dh, dw = torch.autograd.grad(loss, [th, tw])
    return float(loss.detach()), dh.numpy(), dw.numpy()


@pytest.mark.parametrize("softcap,masked,shards", [
    (0.0, False, 1), (30.0, False, 1), (0.0, True, 1), (30.0, True, 4),
    (0.0, False, 4)])
def test_sharded_xent_matches_reference(softcap, masked, shards):
    V = 37                      # 37 % 4 != 0: padded to 40 under 4 shards
    h, w, labels, mask = _xent_inputs(V, 3, masked)
    if shards > 1:
        with axis_rules({"vocab": ("model",)}, _ModelMesh(shards)):
            assert TX._vocab_shards() == shards
            got = _port_xent(h, w, labels, mask, softcap)
    else:
        got = _port_xent(h, w, labels, mask, softcap)
    for impl in ("sharded", "ref"):
        want = _jax_xent(h, w, labels, mask, softcap, impl)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))


@pytest.mark.parametrize("softcap,masked,block", [
    (0.0, False, 8), (30.0, True, 8), (0.0, True, 64)])
def test_blockwise_xent_matches_reference(softcap, masked, block):
    V = 37                      # 37 % 8 != 0: the last tile padded, masked
    h, w, labels, mask = _xent_inputs(V, 4, masked)
    got = _port_xent(h, w, labels, mask, softcap, impl="xla", block=block)
    for impl in ("xla", "ref"):
        want = _jax_xent(h, w, labels, mask, softcap, impl, block)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(b).max()))


# ---------------------------------------------------------------------------
# one sharded server step on a gloo 2x2 mesh
# ---------------------------------------------------------------------------

GLOO_SCRIPT = r"""
import pickle
import sys
sys.path.insert(0, {src!r})
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, port, data, out):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import steps
    from repro_torch.interop import from_numpy_tree
    from repro_torch.launch import roofline
    from repro_torch.models import build_model
    from repro_torch.sharding import axis_rules, rules

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with open(data, "rb") as f:
        blob = pickle.load(f)
    model = build_model(registry.get_smoke_config("qwen3-1.7b"))
    run_cfg = RunConfig()
    srv = from_numpy_tree(blob["srv"])
    batch = from_numpy_tree(blob["batch"])

    def place(t, specs):
        if isinstance(t, dict):
            return {{k: place(v, specs[k]) for k, v in t.items()}}
        if isinstance(t, list):
            return [place(v, s) for v, s in zip(t, specs)]
        return distribute_tensor(t, mesh, rules.to_placements(specs, mesh))

    specs = rules.param_specs(srv, mesh)
    state = steps.init_server_state(model, run_cfg, place(srv, specs))
    dbatch = {{k: distribute_tensor(v, mesh, rules.to_placements(
        rules.batch_spec(mesh, v.dim() - 1), mesh)) for k, v in batch.items()}}
    step = steps.make_server_train_step(
        model, run_cfg, impl="xla", xent_impl="sharded",
        grad_placements=rules.to_placements(specs, mesh))
    counter = roofline.CollectiveCounter()
    with axis_rules(rules.default_axis_rules(mesh), mesh), \
            implicit_replication(), counter:
        new, m = step(state, dbatch)
    loss = m["loss"]
    loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                 else loss)
    flat = {{}}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [str(k)])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
        else:
            full = t.full_tensor() if hasattr(t, "full_tensor") else t
            flat["/".join(path)] = full.detach().numpy()

    walk(new["server"], [])
    if rank == 0:
        plain = steps.make_server_train_step(model, run_cfg, impl="xla",
                                             xent_impl="sharded")
        pnew, pm = plain(steps.init_server_state(model, run_cfg, srv), batch)
        pflat = {{}}

        def pwalk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    pwalk(v, path + [str(k)])
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    pwalk(v, path + [str(i)])
            else:
                pflat["/".join(path)] = t.detach().numpy()

        pwalk(pnew["server"], [])
        np.savez(out, loss=loss, plain_loss=float(pm["loss"]),
                 collectives=sum(counter.stats.counts.values()),
                 **{{"sharded/" + k: v for k, v in flat.items()}},
                 **{{"plain/" + k: v for k, v in pflat.items()}})
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=({port}, {data!r}, {out!r}), nprocs=4, join=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): np.asarray(tree)}


def test_gloo_2x2_server_step_matches_unsharded(tmp_path):
    arch = "qwen3-1.7b"
    jm = j_build(j_registry.get_smoke_config(arch))
    assert jm.cfg.vocab_size % 2 == 1          # padded over 2 vocab shards
    params = _np(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    _, srv = JS.split_params(jm, params, 1)
    srv = _np(srv)
    rng = np.random.default_rng(5)
    batch = {"acts": rng.normal(size=(4, 16, jm.cfg.d_model)).astype(
        np.float32),
        "tokens": rng.integers(0, jm.cfg.vocab_size, (4, 16)).astype(
            np.int32)}
    data = tmp_path / "in.pkl"
    out = tmp_path / "out.npz"
    with open(data, "wb") as f:
        pickle.dump({"srv": srv, "batch": batch}, f)
    script = tmp_path / "gloo_step.py"
    script.write_text(GLOO_SCRIPT.format(src=str(ROOT / "src"),
                                         port=_free_port(), data=str(data),
                                         out=str(out)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = dict(np.load(out))
    assert res["collectives"] > 0
    np.testing.assert_allclose(res["loss"], res["plain_loss"], rtol=1e-5)
    sharded = {k[8:]: v for k, v in res.items() if k.startswith("sharded/")}
    plain = {k[6:]: v for k, v in res.items() if k.startswith("plain/")}
    assert sharded.keys() == plain.keys() == _flat(srv).keys()
    for k, v in plain.items():
        np.testing.assert_allclose(sharded[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    # and the reference's step
    jst, jm_ = jax.jit(JSt.make_server_train_step(jm, JRun()))(
        JSt.init_server_state(jm, JRun(), srv),
        jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(res["loss"], float(jm_["loss"]), rtol=1e-5)
    want = _flat(_np(jst["server"]))
    for k, v in want.items():
        scale = max(1e-3, float(np.abs(v).max()))
        np.testing.assert_allclose(sharded[k], v, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
