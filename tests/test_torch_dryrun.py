"""The port's dry-run (``repro_torch.launch.dryrun``).

* The CLI in a subprocess for qwen3-1.7b x decode_32k on both production
  meshes (the mirror of ``tests/test_dryrun_subprocess.py``; the bound is
  the H100's 80 GiB in place of a v5e's 16 GB) and for train_4k x
  server_train_step on the single-pod mesh (256 fake ranks, fake
  collectives, meta tensors);
* the long_500k skip rule;
* the linearity the JAX package's depth extrapolation assumes, for
  FLOPs: 2- to 5-rep traces of the qwen3 smoke server step differ by
  exactly one period's FLOPs, so the two-point extrapolation would equal
  the full-depth count.  The eager bytes are not linear but exactly
  quadratic in the rep count (constant second differences): autograd
  gives each rep's slice of a period-stacked leaf a gradient of the whole
  stack's size (zeros, then the slice) and sums them, so the dry-run
  counts the whole depth rather than extrapolating;
* the unsharded row's FLOPs equal ``FlopCounterMode``'s on the same step
  run on real tensors (chip_smoke.py's phase 18 (a) on the CPU).
"""

import json
import os
import subprocess
import sys

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import InputShape, replace
from repro_torch.core import splitting, steps
from repro_torch.launch import dryrun
from repro_torch.models import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB80 = 80 * 2**30 / 1e9            # the card's memory, in the rows' GB


def _cli(tmp_path, name, *args, timeout=600):
    out = tmp_path / f"{name}.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


def _check_row(row, chips, step):
    assert row["status"] == "ok", row
    assert row["step"] == step
    assert row["chips"] == chips
    assert row["t_memory_ms"] > 0 and row["t_compute_ms"] > 0
    assert 0 < row["peak_mem_gb_per_device"] < GIB80
    assert row["collectives"]
    assert row["trace_s"] > 0


def test_dryrun_decode_cli_both_meshes(tmp_path):
    rows = _cli(tmp_path, "decode", "--arch", "qwen3-1.7b", "--shape",
                "decode_32k", "--mesh", "both", "--no-analyze")
    assert [r["mesh"] for r in rows] == ["single_pod", "multi_pod"]
    for row, chips in zip(rows, (256, 512)):
        _check_row(row, chips, "decode_step")
    # the KV cache is sequence-sharded: per device, half on twice the ranks
    assert rows[1]["peak_mem_gb_per_device"] < \
        rows[0]["peak_mem_gb_per_device"]


def test_dryrun_train_cli_single_pod(tmp_path):
    rows = _cli(tmp_path, "train", "--arch", "qwen3-1.7b", "--shape",
                "train_4k", "--mesh", "single_pod")
    assert len(rows) == 1
    row = rows[0]
    _check_row(row, 256, "server_train_step")
    assert {"all-gather", "all-reduce"} <= set(row["collectives"])
    assert row["mem"]["argument_gb"] > 0 and row["mem"]["temp_gb"] > 0
    assert 0 < row["useful_flops_frac"] < 1


def test_dryrun_skip_rule(tmp_path):
    rows = _cli(tmp_path, "skip", "--arch", "gemma2-2b", "--shape",
                "long_500k", "--mesh", "single_pod", timeout=300)
    assert rows[0]["status"] == "skip"
    assert "sub-quadratic" in rows[0]["reason"]


SHAPE = InputShape("smoke", 32, 4, "train")


def _smoke(layers):
    cfg = registry.get_smoke_config("qwen3-1.7b")
    return cfg if layers is None else replace(cfg, num_layers=layers)


def test_depth_linearity_and_extrapolation():
    cfg = _smoke(None)
    run_cfg = dryrun.make_run_cfg("qwen3-1.7b", "train_4k")
    step, p = "server_train_step", run_cfg.split.split_point
    vals = []
    for k in (2, 3, 4, 5):
        c = _smoke(dryrun._depth_for(cfg, step, p, k))
        counter, _, _ = dryrun._trace_once(build_model(c), run_cfg, SHAPE,
                                           None, step, "qwen3-1.7b",
                                           "train_4k", cfg=c)
        vals.append((counter.flops, counter.bytes_accessed))
    (f2, b2), (f3, b3), (f4, b4), (f5, b5) = vals
    assert f5 - f4 == f4 - f3 == f3 - f2 > 0
    assert (b5 - b4) - (b4 - b3) == (b4 - b3) - (b3 - b2) > 0
    assert f5 == f2 + 3 * (f3 - f2)


def test_unsharded_row_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _smoke(None)
    run_cfg = dryrun.make_run_cfg("qwen3-1.7b", "train_4k")
    model = build_model(cfg)
    counter, mem, _ = dryrun._trace_once(model, run_cfg, SHAPE, None,
                                         "server_train_step", "qwen3-1.7b",
                                         "train_4k", cfg=cfg)
    gen = torch.Generator().manual_seed(0)
    _, srv = splitting.split_params(model, model.init(gen), 1)
    srv = {k: v for k, v in srv.items()}
    state = steps.init_server_state(model, run_cfg, srv)
    batch = {"acts": torch.randn((SHAPE.global_batch, SHAPE.seq_len,
                                  cfg.d_model), generator=gen).to(
                                      torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (SHAPE.global_batch, SHAPE.seq_len),
                                     generator=gen, dtype=torch.int32)}
    fn = dryrun.make_step_fn(model, run_cfg, "server_train_step")
    fcm = FlopCounterMode(display=False)
    with fcm:
        fn(state, batch)
    assert counter.flops == fcm.get_total_flops() > 0
    assert mem["argument"] > 0 and counter.peak > mem["argument"]
