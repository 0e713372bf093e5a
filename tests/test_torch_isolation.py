"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU
fallback."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.base import RunConfig
from repro_torch.core.baselines import (FedAvgTrainer, FedBuffTrainer,
                                        SFLTrainer)
from repro_torch.core.uit import AmpereTrainer
from repro_torch.data import federate, make_dataset_for_model
from repro_torch.fleet import FleetEngine
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.ssd_chunk import kernel as SK
from repro_torch.kernels.xent import kernel as XK
from repro_torch.launch import train
from repro_torch.models import build_model

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = """
import sys
sys.path.insert(0, {root!r})
import repro_torch
import repro_torch.core.baselines
import repro_torch.core.baselines.fedavg
import repro_torch.core.baselines.fedbuff
import repro_torch.core.baselines.sfl_family
import repro_torch.core.comm_model
import repro_torch.experiments
import repro_torch.experiments.api
import repro_torch.experiments.runner
import repro_torch.experiments.spec
import repro_torch.experiments.systems
import repro_torch.fleet
import repro_torch.fleet.cuts
import repro_torch.fleet.engine
import repro_torch.fleet.profiles
import repro_torch.fleet.scheduler
import repro_torch.analysis
import repro_torch.launch.dryrun
import repro_torch.launch.mesh
import repro_torch.launch.roofline
import repro_torch.launch.run_experiment
import repro_torch.launch.serve
import repro_torch.launch.train
import repro_torch.models.cnn
import repro_torch.models.moe
import repro_torch.observability
import repro_torch.observability.export
import repro_torch.observability.metrics
import repro_torch.observability.profiling
import repro_torch.observability.tracer
import repro_torch.models.vit
import repro_torch.runtime.checkpoint
import repro_torch.runtime.compression
import repro_torch.runtime.elastic
import repro_torch.runtime.fault_tolerance
import repro_torch.runtime.metrics
import repro_torch.sharding
import repro_torch.sharding.annotations
import repro_torch.sharding.rules
import repro_torch.streaming
import repro_torch.streaming.overlap
import repro_torch.streaming.ring
import repro_torch.streaming.store
import repro_torch.streaming.versions
import repro_torch.transport
import repro_torch.transport.faults
import repro_torch.transport.framing
import repro_torch.transport.inprocess
import repro_torch.transport.retry
import repro_torch.transport.roles
import repro_torch.transport.socket_transport
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_and_chip_smoke_import_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--train-samples", "16", "--eval-samples",
                    "8", "--seq-len", "8", "--quiet"])
    model = build_model(registry.get_smoke_config("qwen3-1.7b"))
    data = make_dataset_for_model(model, 16, seq_len=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        AmpereTrainer(model, RunConfig(), federate(data, 2, 0.5), data)
    for trainer in (SFLTrainer, FedAvgTrainer, FedBuffTrainer):
        with pytest.raises(RuntimeError, match="CUDA"):
            trainer(model, RunConfig(), federate(data, 2, 0.5), data)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetEngine(model, RunConfig(), federate(data, 2, 0.5))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--algo", "splitfed", "--train-samples", "16",
                    "--eval-samples", "8", "--quiet"])
    from repro_torch.experiments import ExperimentSpec, run_experiment
    spec = ExperimentSpec(arch="qwen3-1.7b", max_rounds=1,
                          max_server_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_experiment(spec, write_results=False)


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    q = torch.empty((4, 16, 16), device="meta")
    k = torch.empty((2, 16, 16), device="meta")
    kw = dict(group=2, causal=True, window=0, softcap=0.0, scale=0.25,
              kv_len=16)
    with pytest.raises(ValueError, match="CUDA"):
        FK.flash_fwd(q, k, k, **kw)
    for bwd in (FK.flash_bwd_fused, FK.flash_bwd_dq, FK.flash_bwd_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            bwd(q, k, k, q, q[..., 0], q[..., 0], **kw)
    h = torch.empty((8, 16), device="meta")
    w = torch.empty((16, 32), device="meta")
    lab = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        XK.xent_fwd(h, w, lab)
    with pytest.raises(ValueError, match="CUDA"):
        XK.xent_bwd(h, w, lab, lab.float(), lab.float())
    x = torch.empty((1, 2, 16, 4, 8), device="meta")
    dt = torch.empty((1, 2, 16, 4), device="meta")
    bc = torch.empty((1, 2, 16, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        SK.ssd_intra_kernel(x, dt, dt, bc, bc)
    ds = torch.empty((1, 2, 4, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        SK.ssd_intra_bwd_kernel(x, dt, dt, bc, bc, x, ds)


def test_missing_toolchain_and_failed_launch_raise(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()

    class FailingLib:
        @staticmethod
        def rt_error_string(err):
            return b"invalid configuration argument"

    with pytest.raises(RuntimeError, match="invalid configuration"):
        build.check(FailingLib, 9, "flash_fwd")
    build.check(FailingLib, 0, "flash_fwd")      # success is silent

    class FailingSSDLib(FailingLib):
        @staticmethod
        def rt_ssd_intra_bwd_scratch_floats(bc, q, h):
            return bc * q * (q + h)          # one head group, one j tile

        @staticmethod
        def rt_ssd_intra_bwd(*args):
            return 9

    x = torch.zeros((1, 1, 8, 2, 4))
    dt = torch.zeros((1, 1, 8, 2))
    bc = torch.zeros((1, 1, 8, 4))
    with pytest.raises(RuntimeError, match="ssd_intra_bwd: CUDA error 9"):
        SK._launch_bwd(FailingSSDLib, 0, x, dt, dt, bc, bc, x,
                       torch.zeros((1, 1, 2, 4, 4)))
