"""Multi-pod dry-run: prove the distribution config is coherent, as
``repro.launch.dryrun``.

For every (architecture x input-shape x mesh) cell, builds the relevant
step function (Ampere server phase for training shapes, prefill/decode for
serving shapes, plus the device round and the e2e step on request), lays
its inputs out on a ``DeviceMesh`` as ``DTensor``s with the placements of
:mod:`repro_torch.sharding.rules`, and RUNS it once under
:class:`repro_torch.launch.roofline.CostCounter`, which counts each rank's
FLOPs, bytes, collectives and live storage bytes at dispatch (the JAX
package's ``cost_analysis()`` / ``memory_analysis()`` and HLO parsing).

Nothing is allocated on any device: every tensor is a ``meta`` tensor
(shape and dtype only), and the production meshes are ``DeviceMesh``es over
a ``"fake"`` process group of 256 or 512 ranks whose collectives return at
once (this process is rank 0, and ``DTensor`` computes rank 0's local
shards).  So this entry point runs on any host and never needs the card:
the port's rule that an entry point raises rather than fall back to the
CPU does not apply to it.  A one-rank mesh (``--mesh debug``) runs the
plain step, no ``DTensor``: it is the unsharded step the card runs.

The dry-run traces the reference's ``"xla"`` route (``impl="xla"``:
chunked attention and the SSD oracle; ``xent_impl="sharded"``, and the
blockwise ``xent_impl="xla"`` for the device round), as the JAX package
lowers it; no hand-written kernel is on it.  The port's layer loops are
Python loops, so the one trace counts the whole depth: no scan is
counted once, and the JAX package's two-point depth extrapolation
(its ``analysis_costs``) has no counterpart here.  The device round is
costed as the JAX package does: one client's local round traced with
h = 1 and 2 and extrapolated to H, plus the FedAvg all-reduce.

With ``--all`` a cell that traces longer than :data:`ALL_CELL_TIMEOUT_S`
becomes a ``"fail"`` row: ``DTensor`` plans a redistribution between
strided shards by a search exponential in the mesh dims, which can hold
one cell for hours.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --out results/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import signal
import sys
import time
import traceback
import types

import torch

from repro_torch import analysis
from repro_torch.configs import registry
from repro_torch.configs.base import (FedConfig, InputShape, OptimConfig,
                                      RunConfig, SHAPES, ShardingConfig,
                                      SplitConfig, replace)
from repro_torch.core import auxiliary, comm_model, splitting, steps
from repro_torch.interop import tree_leaves, tree_map
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer
from repro_torch.sharding import axis_rules, rules as shard_rules
from repro_torch.sharding.annotations import mesh_axis_sizes

BIG_ARCH_PARAMS = 20e9   # archs above this use bf16 optimizer moments
META = "meta"
ALL_CELL_TIMEOUT_S = 240  # --all: seconds a cell may trace before it fails


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------


def make_run_cfg(arch: str, shape_name: str) -> RunConfig:
    cfg = registry.get_config(arch)
    big = cfg.param_count() > BIG_ARCH_PARAMS
    # multi-layer periods (jamba) remat per layer inside the period body,
    # or the backward holds a whole superblock's intermediates
    remat = "nested" if cfg.pattern_period > 1 else "block"
    return RunConfig(
        arch=arch, shape=shape_name,
        split=SplitConfig(split_point=1),
        fed=FedConfig(clients_per_round=32, local_steps=8,
                      device_batch_size=8),
        optim=OptimConfig(name="adamw", lr=3e-4, schedule="warmup_cosine",
                          optimizer_state_dtype="bfloat16" if big
                          else "float32"),
        sharding=ShardingConfig(strategy="fsdp_tp", remat=remat,
                                scan_layers=True),
    )


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _fresh(tree):
    """Each tensor leaf on a storage of its own (a split's leaves are views
    of the whole model's stacked tensors, whose storages the live-bytes
    count would otherwise charge in full)."""
    return tree_map(lambda t: _empty(t.shape, t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def input_specs(arch: str, shape_name: str, step: str, run_cfg=None,
                cfg=None, shape=None):
    """Meta-tensor stand-ins for every input of ``step`` — shapes and
    dtypes only, no allocation.  ``shape`` overrides ``SHAPES[shape_name]``
    (an :class:`InputShape`)."""
    cfg = cfg if cfg is not None else registry.get_config(arch)
    model = build_model(cfg)
    shape = shape or SHAPES[shape_name]
    run_cfg = run_cfg or make_run_cfg(arch, shape_name)
    B, S = shape.global_batch, shape.seq_len
    p = run_cfg.split.split_point

    if step == "server_train_step":
        params = comm_model.abstract_params(model)
        srv = _fresh(splitting.split_params(model, params, p)[1])
        del params
        opt = make_optimizer(run_cfg.optim)
        state = {"server": srv, "opt": opt.init(srv), "step": 0}
        batch = {"acts": _empty((B, S, cfg.d_model), torch.bfloat16),
                 "tokens": _empty((B, S), torch.int32)}
        return {"state": state, "batch": batch}

    if step == "e2e_train_step":
        params = comm_model.abstract_params(model)
        opt = make_optimizer(run_cfg.optim)
        state = {"params": params, "opt": opt.init(params), "step": 0}
        return {"state": state, "batch": {"tokens": _empty((B, S),
                                                           torch.int32)}}

    if step == "device_round_step":
        params = comm_model.abstract_params(model)
        dev = _fresh(splitting.split_params(model, params, p)[0])
        del params
        aux = auxiliary.init_aux(model, torch.Generator(), run_cfg.split,
                                 META)
        K = run_cfg.fed.clients_per_round
        H = run_cfg.fed.local_steps
        b = max(1, B // K)
        return {"state": {"device": dev, "aux": aux},
                "batches": {"tokens": _empty((K, H, b, S), torch.int32)},
                "weights": [1.0] * K, "lr": 0.0}

    if step in ("prefill_step", "decode_step"):
        params = comm_model.abstract_params(model)
        caches = T.init_caches(cfg, B, S, kv_dtype="bfloat16", device=META)
        if step == "prefill_step":
            return {"params": params, "tokens": _empty((B, S), torch.int32),
                    "caches": caches}
        return {"params": params, "caches": caches,
                "token": _empty((B, 1), torch.int32), "index": S - 1}

    raise ValueError(f"unknown step {step!r}")


# ---------------------------------------------------------------------------
# Placement assignment
# ---------------------------------------------------------------------------


def _repl(tree, mesh):
    return shard_rules.to_placements(
        shard_rules._map_with_path(lambda _p, _l: (), tree), mesh)


def _size(mesh, axes) -> int:
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def cell_shardings(abstract_args, step: str, mesh, shape, run_cfg):
    """Placements tree matching ``input_specs(...)`` for this step (a
    list a tensor leaf, ``()`` specs for non-tensor leaves)."""
    names = tuple(mesh_axis_sizes(mesh))
    multi_pod = "pod" in names
    strategy = run_cfg.sharding.strategy
    dp = (names if strategy == "dp_only"
          else (("pod", "data") if multi_pod else ("data",)))
    B = shape.global_batch
    batch_ok = B % _size(mesh, dp) == 0
    if not batch_ok and strategy == "dp_only":
        dp = ("pod", "data") if multi_pod else ("data",)
        batch_ok = B % _size(mesh, dp) == 0

    def pspec(tree, **kw):
        return shard_rules.to_placements(
            shard_rules.param_specs(tree, mesh, strategy=strategy, **kw), mesh)

    def batch_pl(v, axes):
        return shard_rules.to_placements(
            (axes if axes else None,) + (None,) * (v.dim() - 1), mesh)

    if step in ("server_train_step", "e2e_train_step"):
        key = "server" if step == "server_train_step" else "params"
        st = abstract_args["state"]
        state_sh = {key: pspec(st[key]), "opt": pspec(st["opt"]),
                    "step": _repl(st["step"], mesh)}
        bsh = {k: batch_pl(v, dp[-1:] if step == "e2e_train_step" else dp)
               for k, v in abstract_args["batch"].items()}
        return (state_sh, bsh)

    if step == "device_round_step":
        # pure client-parallelism: the device block is tiny by Ampere's
        # design (p=1), so clients map onto EVERY mesh axis, the device
        # block + aux net are replicated, and the round ends in one
        # weighted all-reduce (the FedAvg)
        st = abstract_args["state"]
        state_sh = {"device": _repl(st["device"], mesh),
                    "aux": _repl(st["aux"], mesh)}
        bsh = {k: batch_pl(v, names)
               for k, v in abstract_args["batches"].items()}
        return (state_sh, bsh, _repl(abstract_args["weights"], mesh),
                _repl(abstract_args["lr"], mesh))

    if step in ("prefill_step", "decode_step"):
        kv_axes = ("model",)
        batch_axes = dp
        if not batch_ok:
            batch_axes = ()
            kv_axes = dp + ("model",)    # long-context: shard seq everywhere
        # token ids over one mesh axis: DTensor's index op (the embedding
        # lookup) takes no tensor dim sharded over two (PyTorch 2.11)
        tok_axes = batch_axes[-1:]
        params_sh = pspec(abstract_args["params"])
        caches_sh = pspec(abstract_args["caches"], cache=True,
                          kv_seq_axes=kv_axes, batch_axes=batch_axes)
        if step == "prefill_step":
            return (params_sh, batch_pl(abstract_args["tokens"], tok_axes),
                    caches_sh)
        return (params_sh, caches_sh,
                batch_pl(abstract_args["token"], tok_axes),
                _repl(abstract_args["index"], mesh))

    raise ValueError(step)


def distribute(tree, placements, mesh):
    """``DTensor``s of ``tree``'s meta leaves on ``mesh``: each a fresh
    local meta tensor of rank 0's shard shape (so a rank's storage is its
    shard, never the global tensor); non-tensor leaves stay as they are."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, p, mesh)
                          for v, p in zip(tree, placements))
    if not isinstance(tree, torch.Tensor):
        return tree
    local = distribute_tensor(tree, mesh, placements)._local_tensor
    fresh = torch.empty(local.shape, dtype=local.dtype, device=META)
    return DTensor.from_local(fresh, mesh, placements, run_check=False,
                              shape=tree.shape, stride=tree.stride())


# ---------------------------------------------------------------------------
# Cell tracing
# ---------------------------------------------------------------------------


def make_step_fn(model, run_cfg, step: str, grad_placements=None):
    if step == "server_train_step":
        return steps.make_server_train_step(model, run_cfg, impl="xla",
                                            xent_impl="sharded",
                                            grad_placements=grad_placements)
    if step == "e2e_train_step":
        return steps.make_e2e_train_step(model, run_cfg, impl="xla",
                                         xent_impl="sharded")
    if step == "device_round_step":
        # blockwise xent: per-client local math, no resharding (params are
        # replicated in the client-parallel device phase)
        return steps.make_device_round_step(model, run_cfg, impl="xla",
                                            xent_impl="xla")
    if step == "prefill_step":
        return steps.make_prefill_step(model, run_cfg, impl="xla")
    if step == "decode_step":
        return steps.make_decode_step(model, run_cfg, impl="xla")
    raise ValueError(step)


def _storage_bytes(tree) -> int:
    """Bytes of the distinct local storages of a tree's tensors."""
    from torch.distributed.tensor import DTensor
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = (t._local_tensor if isinstance(t, DTensor)
                  else t).untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _trace_once(model, run_cfg, shape, mesh, step: str, arch: str,
                shape_name: str, *, cfg=None):
    """Run one step on meta tensors under a :class:`RL.CostCounter`;
    returns (counter, {"argument", "output"} bytes, trace seconds)."""
    cfg = cfg if cfg is not None else model.cfg
    if run_cfg.optim.master_weights and cfg.param_dtype != "bfloat16":
        cfg = replace(cfg, param_dtype="bfloat16")
        model = build_model(cfg)
    abstract_args = input_specs(arch, shape_name, step, run_cfg, cfg=cfg,
                                shape=shape)
    sharded = mesh is not None and mesh.size() > 1
    grad_pl = None
    ctx = contextlib.ExitStack()
    if sharded:
        from torch.distributed.tensor.experimental import implicit_replication
        in_pl = cell_shardings(abstract_args, step, mesh, shape, run_cfg)
        args = tuple(distribute(a, p, mesh)
                     for a, p in zip(abstract_args.values(), in_pl))
        if step == "server_train_step":
            grad_pl = in_pl[0]["server"]
        seq_shard = (run_cfg.sharding.sequence_sharding
                     and shape.kind != "decode")
        ctx.enter_context(axis_rules(shard_rules.default_axis_rules(
            mesh, sequence_sharding=seq_shard,
            strategy=run_cfg.sharding.strategy), mesh))
        ctx.enter_context(implicit_replication())
    else:
        args = tuple(abstract_args.values())
    del abstract_args
    fn = make_step_fn(model, run_cfg, step, grad_placements=grad_pl)
    counter = RL.CostCounter(device_type=META)
    counter.track(args)
    argument = counter.live
    # real host-side trace timing, not sim time
    t0 = time.perf_counter()  # staticcheck: ok=wall-clock
    with ctx, analysis.grad_comm_dtype(run_cfg.optim.grad_dtype or None), \
            counter:
        out = fn(*args)
    t_trace = time.perf_counter() - t0  # staticcheck: ok=wall-clock
    output = _storage_bytes(out)
    del out, args
    gc.collect()
    return counter, {"argument": argument, "output": output}, t_trace


def _depth_for(cfg, step: str, p: int, k: int) -> int:
    """num_layers for a k-rep analysis graph of ``step``."""
    P = cfg.pattern_period
    if step == "server_train_step":
        r0 = -(-p // P)
        return r0 * P + k * P
    return k * P


def _device_round_analysis(arch, shape_name, run_cfg, shape, chips, *,
                           cfg=None):
    """Device-phase costs: per-device work == one client's local round
    (client-parallel mapping, params replicated), so trace the
    single-client round with h = 1 and 2 and extrapolate the local-step
    count; the only collective is the FedAvg all-reduce, costed
    analytically.  Returns the costs as a record of a
    :class:`RL.CostCounter`'s fields (peak: the h = 2 round's), the
    round's memory and the trace seconds."""
    cfg = cfg if cfg is not None else registry.get_config(arch)
    model = build_model(cfg)
    vals, peak, t_total = [], 0, 0.0
    for h in (1, 2):
        rc = replace(run_cfg, fed=replace(run_cfg.fed, clients_per_round=1,
                                          local_steps=h,
                                          device_batch_size=1))
        one = InputShape(shape.name, shape.seq_len, 1, shape.kind)
        counter, mem, t = _trace_once(model, rc, one, None,
                                      "device_round_step", arch, shape_name,
                                      cfg=cfg)
        vals.append((counter.flops, counter.bytes_accessed))
        peak, t_total = counter.peak, t_total + t
    (f1, b1), (f2, b2) = vals
    H = run_cfg.fed.local_steps
    flops = f1 + (H - 1) * (f2 - f1)
    byts = b1 + (H - 1) * (b2 - b1)
    sizes = comm_model.split_sizes(model, run_cfg.split,
                                   seq_len=shape.seq_len)
    coll = 2.0 * (sizes.device + sizes.aux) * (chips - 1) / chips
    costs = types.SimpleNamespace(
        flops=flops, bytes_accessed=byts, peak=peak,
        stats=RL.CollectiveStats(coll, {"all-reduce": 4}, {"all-reduce": coll}))
    return costs, mem, t_total


_MESHES = {}


def mesh_for(mesh_name: str):
    """The named mesh (made once a process): ``single_pod`` 16x16,
    ``multi_pod`` 2x16x16; ``debug``, the 1x1 mesh, is ``None``: its
    step is the plain one and needs no process group."""
    if mesh_name == "debug":
        return None
    if mesh_name not in _MESHES:
        if mesh_name == "single_pod" and "multi_pod" not in _MESHES:
            # one 512-rank group carries both production meshes
            mesh_for("multi_pod")
        _MESHES[mesh_name] = make_production_mesh(
            multi_pod=(mesh_name == "multi_pod"))
    return _MESHES[mesh_name]


def run_cell(arch: str, shape_name: str, mesh_name: str, step: str,
             *, run_cfg=None, verbose: bool = True, shape=None):
    """One dry-run cell: the step run once on the mesh's ranks (the
    placement proof, the per-rank memory and the roofline counts in one
    trace).  ``shape`` overrides ``SHAPES[shape_name]``."""
    cfg = registry.get_config(arch)
    model = build_model(cfg)
    shape = shape or SHAPES[shape_name]
    run_cfg = run_cfg or make_run_cfg(arch, shape_name)
    mesh = mesh_for(mesh_name)
    chips = 1 if mesh is None else mesh.size()

    if step == "device_round_step":
        counter, mem, t_trace = _device_round_analysis(
            arch, shape_name, run_cfg, shape, chips)
    else:
        counter, mem, t_trace = _trace_once(model, run_cfg, shape, mesh,
                                            step, arch, shape_name)

    mf = RL.model_flops_estimate(cfg, shape.kind, shape.seq_len,
                                 shape.global_batch, step)
    if step == "device_round_step":
        sizes = comm_model.split_sizes(model, run_cfg.split,
                                       seq_len=shape.seq_len)
        K, H, b = chips, run_cfg.fed.local_steps, 1  # mesh-wide cohort
        mf = 6.0 * ((sizes.device + sizes.aux) / 4) * K * H * b * shape.seq_len

    rl = RL.analyse(arch, shape.name, mesh_name, step, chips, counter, mf)
    row = rl.row()
    row["flops_per_device"] = rl.flops_per_device
    row["coll_mb_by_op_per_dev"] = {
        k: round(v / 1e6, 2) for k, v in counter.stats.bytes_by_op.items()}
    row["trace_s"] = round(t_trace, 2)
    row["status"] = "ok"
    row["mem"] = {
        "argument_gb": mem["argument"] / 1e9,
        "output_gb": mem["output"] / 1e9,
        "temp_gb": max(0, counter.peak - mem["argument"]) / 1e9,
        "alias_gb": 0.0,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape.name} x {mesh_name} x {step}: "
              f"trace ok in {t_trace:.1f}s | "
              f"t_comp={row['t_compute_ms']:.2f}ms "
              f"t_mem={row['t_memory_ms']:.2f}ms "
              f"t_coll={row['t_collective_ms']:.2f}ms "
              f"bottleneck={row['bottleneck']} "
              f"useful={row['useful_flops_frac']:.2f} "
              f"peak_mem={row['peak_mem_gb_per_device']:.2f}GB/dev",
              flush=True)
        print(f"         memory: {row['mem']}", flush=True)
        print(f"         costs: flops/dev={row['hlo_gflops_total']/chips:.1f}G "
              f"bytes/dev={row['hbm_gb_total']/chips:.2f}GB "
              f"collectives={row['collectives']}", flush=True)
    return row


STEP_FOR_KIND = {"train": "server_train_step", "prefill": "prefill_step",
                 "decode": "decode_step"}


@contextlib.contextmanager
def _time_limit(seconds: int):
    """Raise TimeoutError in the main thread after ``seconds`` (0: none)."""
    if not seconds:
        yield
        return

    def alarm(signum, frame):
        raise TimeoutError(f"trace exceeded {seconds} s")
    prev = signal.signal(signal.SIGALRM, alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single_pod", "multi_pod", "both", "debug"])
    ap.add_argument("--steps", default="auto",
                    help="comma list or 'auto' (per-shape default) or 'full' "
                         "(auto + device_round for train shapes)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-analyze", action="store_true",
                    help="accepted for the JAX package's CLI: the port's "
                         "one trace is both the proof and the count")
    ap.add_argument("--strategy", default="",
                    choices=["", "fsdp_tp", "dp_only", "tp_only"],
                    help="override the sharding strategy")
    ap.add_argument("--master-weights", action="store_true",
                    help="bf16 params + fp32 master weights")
    args = ap.parse_args(argv)

    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])
    if args.all:
        matrix = registry.cells(include_skipped=True)
    else:
        archs = [args.arch] if args.arch else list(registry.ASSIGNED_ARCHS)
        shapes = [args.shape] if args.shape else list(SHAPES)
        matrix = [(a, s, r, why) for a in archs for s in shapes
                  for (aa, ss, r, why) in registry.cells()
                  if aa == a and ss == s]

    rows = []
    failures = 0
    for arch, shape_name, runnable, why in matrix:
        if not runnable:
            rows.append({"arch": arch, "shape": shape_name, "status": "skip",
                         "reason": why})
            print(f"[dryrun] {arch} x {shape_name}: SKIP ({why})", flush=True)
            continue
        kind = SHAPES[shape_name].kind
        if args.steps == "auto":
            step_list = [STEP_FOR_KIND[kind]]
        elif args.steps == "full":
            step_list = [STEP_FOR_KIND[kind]]
            if kind == "train":
                step_list.append("device_round_step")
        else:
            step_list = args.steps.split(",")
        run_cfg = None
        if args.strategy or args.master_weights:
            run_cfg = make_run_cfg(arch, shape_name)
            if args.strategy:
                run_cfg = replace(run_cfg, sharding=replace(
                    run_cfg.sharding, strategy=args.strategy))
            if args.master_weights:
                run_cfg = replace(run_cfg, optim=replace(
                    run_cfg.optim, master_weights=True))
        for mesh_name in meshes:
            for step in step_list:
                try:
                    with _time_limit(ALL_CELL_TIMEOUT_S if args.all else 0):
                        rows.append(run_cell(arch, shape_name, mesh_name,
                                             step, run_cfg=run_cfg))
                except Exception as e:
                    failures += 1
                    traceback.print_exc()
                    rows.append({"arch": arch, "shape": shape_name,
                                 "mesh": mesh_name, "step": step,
                                 "status": "fail", "error": repr(e)})
                    print(f"[dryrun] {arch} x {shape_name} x {mesh_name} x "
                          f"{step}: FAIL {e}", flush=True)
                gc.collect()

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1, default=str)
        print(f"[dryrun] wrote {len(rows)} rows to {args.out}", flush=True)
    ok = sum(1 for r in rows if r.get("status") == "ok")
    print(f"[dryrun] {ok} ok / {failures} failed / "
          f"{sum(1 for r in rows if r.get('status') == 'skip')} skipped",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
