#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  ``python3 chip_smoke.py`` from the repository root:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: every CUDA source under ``src/repro_torch/csrc`` into one sm_90a
   library (``build/repro_torch_kernels/``), timed.
3. Kernels: each of ``flash_fwd``, ``flash_bwd_fused``, ``flash_bwd_dq``,
   ``flash_bwd_dkv``, ``xent_fwd``, ``xent_bwd``, ``ssd_intra`` and
   ``ssd_intra_bwd`` against its plain PyTorch version on the same
   inputs, at the main paths' shapes (qwen3-1.7b: server batch 8 x 512
   tokens, Hkv 8, G 2, hd 128, bf16; xent T = 8 x 511, D 2048, V
   151936; mamba2-370m: server SSD (8, 8, 256, 32, 64) with N 128, the
   auxiliary clone's H 16, N 64), at a gemma2-style
   case (hd 256, window, softcaps 50 / 30), a ragged bf16 attention case
   (S 300 over 130 keys, kv_len 120, window 64: rows with no valid key),
   the main attention shape in fp32 (the instantiations that the split
   step's fp32 pass and the fp32 smoke configs run: the forward and the
   fused backward on the tensor cores over three bf16 planes of q, k and
   v, the two sweeps too, their bounds restated for their passes by
   ``split_bound``, the fp32-FMA bound beside it on the "timing" line),
   the gemma2-style and the ragged cases in fp32 too, and a small odd SSD
   case (the fused
   backward gets an fp32 dO, the split sweeps dO in q's dtype); xent, on
   the tensor cores, with a bf16 h and an fp32 w at the qwen3 shape
   (untied), the tied auxiliary shape (T 2044), gemma2's softcap case (T
   1024, V 256000) and the mamba2-370m server shape (T 16376, D 1024, V
   50280, tied), and with an fp32 h (split into bf16 hi/lo as w is) at
   the qwen3 shape, each backward twice
   (bit-identical; the attention backwards too, fused and split, in both
   dtypes); the SSD backward on all three SSD cases, twice
   (bit-identical); kernel, plain and library times with CUDA events
   (median of ``REPEATS`` timings after ``WARMUP`` calls, their range
   beside it; SSD one timing), and for the SSD backward the route it
   replaced (autograd of the oracle ``ssd_intra_ref``, ``replaced_ms``)
   and its bound restated for the tensor cores (3 bf16 passes; the
   fp32-FMA bound beside it on the "timing" line, as for xent).
   The build prints ptxas's registers, spills and static shared memory of
   the attention and xent kernels (all on the tensor cores), their split
   pre-passes and the SSD kernels.
4. References: the launcher's path on the qwen3-1.7b and mamba2-370m smoke
   configs from the same initial states on the card (kernels) and on the
   CPU (plain versions); the histories must agree.
5. Main paths: ``repro_torch.launch.train.run_training`` on full-width,
   full-depth qwen3-1.7b (seq 512, lr 0.02) and mamba2-370m (seq 2048, so
   8 chunks of 256 per sequence, lr ``MAMBA_LR``), random init from the
   seed, 4 clients, cohort 2, H 2, device batch 4, 2 device rounds, server
   batch 8, one server epoch over 64 samples, 8 eval samples; each path's
   kernels must have launched, every loss be finite, and the merged
   model's validation loss end below ln V.  The accounting must hold at
   full width: the store holds ``bytes_received`` = 64 x (seq x d_model x
   4 + seq x 4) (fp32 activations and int32 labels), ``comm_bytes`` =
   rounds x 2K(s_d + s_aux) + bytes_received with the sizes from
   ``repro_torch.core.comm_model``, and ``sim_time`` = the rounds'
   slowest clients + bytes_received / BANDWIDTH_BPS + epochs x
   ``ampere_server_epoch_time``, summed in the Runner's order.  Then the
   qwen3-1.7b path again from the same init with ``--quantize-acts``
   (int8 payloads, one fp32 scale a token): its kernels launch, its losses
   are finite and below ln V, the store holds 64 x (seq x d_model + seq x
   4 + seq x 4) bytes, and ``comm_bytes`` and ``sim_time`` fall from the
   fp32 run's by exactly the upload bytes saved and their time on the
   link.
6. Profile: one server train step of each main path at its shape (8 x 512
   qwen3-1.7b, 8 x 2048 mamba2-370m) under ``torch.profiler`` after one
   untimed step and 3 steps timed without it (CUDA events): device time
   by kernel name (top 10), the xent and SSD kernels' shares, each SSD
   kernel's time and calls, the device busy share (union of kernel
   intervals over the unprofiled step's median time; over the profiled
   step's wall time beside it), or "not measured" when the trace holds no
   device time, and the peak memory of the timed steps.
7. Split backward: one server train step of full-width, full-depth
   qwen3-1.7b (8 x 512) from the same state and batch through
   ``steps.make_server_train_step``, twice with ``impl="kernel"`` and
   twice with ``impl="kernel:split"``, in fp32 and in the config's bf16
   compute: the losses agree, two fused runs and two split runs each give
   bit-identical gradients, split differs from fused by at most 1e-4 of
   each leaf's scale in fp32 and 0.05 in bf16 (the two routes sum dQ in
   different orders, and 27 layers of bf16 backward carry the last-bit
   difference into every gradient), and every attention kernel launched
   in both dtypes.
8. Experiment: ``repro_torch.experiments.run_experiment`` on the
   qwen3-1.7b smoke spec (4 clients, cohort 2, H 2, 2 rounds, 2 server
   epochs, seq 32, checkpoints after every round and epoch in a temporary
   workdir), on the card and on the CPU from the same (CPU-seeded) init:
   losses within 1e-4 relative, next-token accuracy within 1e-2,
   ``comm_bytes`` and ``sim_time`` equal; then a card run killed after
   round 0 and rerun from its workdir matches the uninterrupted card run
   bit for bit (the kernels and PyTorch's ops on this path repeat exactly;
   PERF.md, Findings).
   Then the same experiment on the card with ``device_pool_budget_mb``
   0, fp32 and int8: the device phase uploads each round's batches and
   the server phase streams the store's batches through
   ``DevicePrefetcher`` (pinned memory, a side stream, an event wait),
   and each history equals (``==``) the resident card run's.
9. Vision: the paper's classifiers at their published configs
   (mobilenet-l, vgg11, vit-s, swin-t; 32x32x3, 10 classes) through
   ``run_training`` with ``examples/quickstart.py``'s federation (8
   clients, cohort 4, H 8, device batch 16, server batch 32, Dirichlet
   0.33, momentum, inverse_time), 512 training and 128 eval samples, 2
   device rounds, 12 server epochs, split point 1, each at its
   ``VISION_LR``: finite losses, ``bytes_received`` = 512 x (the
   activations' elements x 4 + 4), ``comm_bytes`` and ``sim_time`` as in
   phase 5, the merged model at val acc >= 0.5 and val loss <= ln 10 -
   0.5, and no hand-written kernel
   launched (the reference's vision path reaches no Pallas kernel); each
   arch's phase walls beside the card's name and power limit, then one
   server step at batch 32 from the trained state, timed and profiled as
   in phase 6.
10. Vision experiment: the four smoke classifiers through
   ``run_experiment`` on the card twice (bit for bit the same: the port
   pins cuDNN's deterministic algorithms) and on the CPU from the same
   CPU-seeded init (lr ``VISION_EXPERIMENT_LR``): losses within 1e-4 relative,
   accuracies within 1e-2, ``comm_bytes`` and ``sim_time`` equal, with
   TF32 off for cuBLAS and cuDNN (the tolerance assumes it), as the
   port's entry points set it (``repro_torch.device.pin_fp32``): the
   script leaves PyTorch's flags alone, logs them at the start and fails
   if either is still on after the runs.
11. Baselines: (a) ``launch.train.run_baseline`` with SplitFed and with
   FedAvg on full-width, full-depth qwen3-1.7b (phase 5's corpus, seq
   512, lr 0.02, 4 clients, cohort 2, H 2, device batch 4, 2 rounds, 8
   eval samples): SplitFed launches the attention pair and the xent pair
   (its backward crosses the cut), FedAvg the attention pair and no xent
   kernel (its loss is the reference's from materialized logits); every
   loss finite, the merged model's val loss lower after round 1 than
   after round 0; ``comm_bytes`` = rounds x 2K x ((2 x act_per_sample x b
   x H + 2 s_d) // 2) for SplitFed and rounds x 2K x the model's bytes
   for FedAvg, ``sim_time`` the rounds' ``epoch_time``; the round time
   and peak memory beside the card's name and power limit.  (b) Ampere
   against SplitFed on the published mobilenet-l through
   ``run_experiment`` (phase 9's federation, samples, rounds and
   ``VISION_LR``, 2 server epochs): both accountings ``==`` the comm
   model's, and the traffic Ampere saves.  (c) The seven synchronous
   systems on the qwen3-1.7b smoke spec through ``run_experiment``, card
   against CPU from the same CPU-seeded init: losses within 1e-4
   relative, accuracies within 1e-2, ``comm_bytes`` and ``sim_time``
   equal (SCAFFOLD keeps a control tree per client: run at this size
   only).

The corpus: ``make_lm_dataset`` builds an O(vocab^2) bigram table, which
cannot exist at V = 151936 or 50280, so the main paths sample the
unchanged generator at vocab 257 and map the ids into [0, V) through a
fixed random injection drawn from the seed; model, head and xent still run
over the full vocabulary.

Tolerances: each kernel output within 1e-4 of its largest magnitude (fp32
accumulation in another order).

Prints one line per phase (the last, "total", the script's wall
seconds), then the kernels' JSON line (``launches`` the
sum over the path runs of 5 (the int8 run too), 7, 8 (the streamed
runs too), 9, 10 and 11,
``launches_by_path`` each run's count; the attention rows are the bf16 tensor-core kernels,
``*_fp32`` the fp32 instantiations behind the same wrappers, counted by
dtype (every one on the tensor cores over bf16 planes, with its bf16
pass count and fp32-FMA bound); the xent rows are a bf16 h, ``*_fp32`` an fp32 h, both on the
tensor cores, counted by h's dtype; the xent rows add their bf16 pass
count, the fp32-FMA bound for comparison and their times at the mamba2
shape), the card line and,
last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or when any
phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import (FedConfig, OptimConfig,  # noqa: E402
                                      RunConfig)
from repro_torch.core import (aggregation, comm_model, splitting,  # noqa: E402
                              steps)
from repro_torch.core import uit  # noqa: E402
from repro_torch.core.uit import AmpereTrainer  # noqa: E402
from repro_torch.data import (ActivationStore, Dataset, federate,  # noqa: E402
                              make_dataset_for_model, make_lm_dataset)
from repro_torch.experiments import (AmpereSystem, DataSpec,  # noqa: E402
                                     ExperimentSpec, SystemContext,
                                     resolve_setup, run_experiment)
from repro_torch.interop import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as SR  # noqa: E402
from repro_torch.kernels.xent import kernel as XK  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = {
    "flash_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention/kernel.py:104"),
    "flash_fwd_fp32": ("src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention/kernel.py:104"),
    "flash_bwd_fused": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:407"),
    "flash_bwd_fused_fp32": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:407"),
    "flash_bwd_dq": ("src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/kernels/flash_attention/kernel.py:201"),
    "flash_bwd_dq_fp32": ("src/repro_torch/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention/kernel.py:201"),
    "flash_bwd_dkv": ("src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention/kernel.py:257"),
    "flash_bwd_dkv_fp32": ("src/repro_torch/csrc/flash_attention.cu",
                           "src/repro/kernels/flash_attention/kernel.py:257"),
    "xent_fwd": ("src/repro_torch/csrc/xent.cu",
                 "src/repro/kernels/xent/kernel.py:107"),
    "xent_fwd_fp32": ("src/repro_torch/csrc/xent.cu",
                      "src/repro/kernels/xent/kernel.py:107"),
    "xent_bwd": ("src/repro_torch/csrc/xent.cu",
                 "src/repro/kernels/xent/kernel.py:242"),
    "xent_bwd_fp32": ("src/repro_torch/csrc/xent.cu",
                      "src/repro/kernels/xent/kernel.py:242"),
    "ssd_intra": ("src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk/kernel.py:55"),
    # the reference's VJP of ssd_intra_pallas (autograd of its oracle)
    "ssd_intra_bwd": ("src/repro_torch/csrc/ssd_chunk.cu",
                      "src/repro/kernels/ssd_chunk/ops.py:29"),
}
WRAPPERS = {"flash_fwd": FK.flash_fwd, "flash_bwd_fused": FK.flash_bwd_fused,
            "flash_bwd_dq": FK.flash_bwd_dq, "flash_bwd_dkv": FK.flash_bwd_dkv,
            "xent_fwd": XK.xent_fwd, "xent_bwd": XK.xent_bwd,
            "ssd_intra": SK.ssd_intra_kernel,
            "ssd_intra_bwd": SK.ssd_intra_bwd_kernel}
# rows whose wrapper launches a different kernel per dtype: (wrapper, dtype)
FA_BY_DTYPE = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
               "flash_bwd_dkv")
XENT_BY_DTYPE = ("xent_fwd", "xent_bwd")
BY_DTYPE = {**{name: (name, "bfloat16")
               for name in FA_BY_DTYPE + XENT_BY_DTYPE},
            **{f"{name}_fp32": (name, "float32")
               for name in FA_BY_DTYPE + XENT_BY_DTYPE}}

# The main paths: sequence length, learning rate, and the kernels each
# must launch.  LR: the launcher's default 0.2 (momentum 0.9) diverges on
# the random-init full-width qwen3 server block within one epoch; at 0.02
# it trains below ln V (PERF.md, Findings).  The mamba2 rate comes from
# ``scripts/torch_lr_probe.py --arch mamba2-370m`` (PERF.md, Findings).
MAMBA_LR = 0.05
MAIN_PATHS = {
    "qwen3-1.7b": dict(seq=512, lr=0.02, kernels=(
        "flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd")),
    "mamba2-370m": dict(seq=2048, lr=MAMBA_LR, kernels=(
        "ssd_intra", "ssd_intra_bwd", "xent_fwd", "xent_bwd")),
}
SEQ_LEN = MAIN_PATHS["qwen3-1.7b"]["seq"]
INT8_ARCH = "qwen3-1.7b"     # its main path runs again with int8 payloads
# phase 9: the paper's classifiers at their published configs, with
# examples/quickstart.py's federation (8 clients, cohort 4, H 8, device
# batch 16, server batch 32, Dirichlet 0.33, momentum, inverse_time)
VISION_ARCHS = ("mobilenet-l", "vgg11", "vit-s", "swin-t")
# each arch's rate: the lowest final merged val loss after 8 server epochs
# over lr 0.2 to 0.0005 (scripts/torch_vision_lr_probe.py on the card;
# PERF.md): at 0.2 the server phase of mobilenet-l, vit-s and swin-t
# diverges and vgg11 never trains (heavy-ball momentum 0.9 from a random
# server block, no warm-up, no clipping)
VISION_LR = {"mobilenet-l": 0.01, "vgg11": 0.005, "vit-s": 0.0005,
             "swin-t": 0.005}
VISION_ARGS = ["--clients", "8", "--cohort", "4", "--local-steps", "8",
               "--batch-size", "16", "--server-batch", "32", "--alpha",
               "0.33", "--seed", "0"]
VISION_TRAIN, VISION_EVAL = 512, 128
VISION_ROUNDS, VISION_EPOCHS = 2, 12
# the merged model must have learnt the classes: accuracy 5x chance and
# val loss 0.5 under ln 10 (an untrained one sits near 0.1 and ln 10)
VISION_MIN_ACC, VISION_LOSS_MARGIN = 0.5, 0.5
# phase 10: the smoke configs through run_experiment, card against CPU, at
# one rate at which all four train at this size (ViT/Swin diverge at 0.2)
VISION_EXPERIMENT_LR = 0.05
TRAIN_SAMPLES = 64
EVAL_SAMPLES = 8
DEVICE_ROUNDS = 2
SERVER_EPOCHS = 1
# phase 11: the synchronous baselines.  (a) SplitFed and FedAvg on the
# full-width qwen3-1.7b main path, with the kernels each must launch; (b)
# Ampere against SplitFed on the published mobilenet-l, server epochs cut
# to COMPARISON_EPOCHS; (c) every synchronous system on the qwen3 smoke
# spec, card against CPU
BASELINE_ARCH = "qwen3-1.7b"
BASELINE_KERNELS = {
    "splitfed": ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd"),
    "fedavg": ("flash_fwd", "flash_bwd_fused")}
COMPARISON_EPOCHS = 2
SYNC_SYSTEMS = ("splitfed", "splitfed_mb", "splitfedv2", "splitgp",
                "scaffold", "pipar", "fedavg")
ITERS_ATTENTION = 20     # timed calls per measurement
REPEATS = 5              # attention: measurements per time, median kept
WARMUP = 3               # attention: untimed calls before them
ITERS_XENT = 2
ITERS_SSD = 10
# kernels whose ptxas report the build phase prints: the attention and
# xent tensor-core kernels, their split pre-passes and the SSD forward and
# backward
PTXAS_REPORT = ("fa_fwd_tc_", "fa_bwd_tc_", "fa_bwd_dq_tc_", "fa_split_",
                "xent_tc_", "xent_split_", "ssd_y_", "ssd_state_",
                "ssd_bwd_")
# bf16 mma passes a product of the SSD kernels takes: the forward splits
# each fp32 operand into three bf16 planes (held to 1e-5), the backward
# into two (held to 1e-4); csrc/ssd_chunk.cu
SSD_FWD_PASSES, SSD_BWD_PASSES = 6, 3
# bf16 mma passes of the fp32 attention kernels, each over one product of
# 2 hd flops an unmasked pair: q, k and v in three planes; the forward's S
# = Q K^T 6 (i + j <= 2) and O += P V 5 (P hi/lo against v's three), the
# backwards' S 6 and every other product 3 (hi/lo of both operands): fused
# dP, dV, dK, dQ; dQ sweep dP, dQ; dK/dV sweep dP, dV, dK;
# csrc/flash_attention.cu
FA_FWD_PASSES, FA_BWD_PASSES = 6 + 5, 6 + 4 * 3
FA_DQ_PASSES, FA_DKV_PASSES = 6 + 3 + 3, 6 + 3 * 3
PROFILE_TOP = 10         # kernels named in each profile line
PROFILE_STEPS = 3        # unprofiled steps timed before the profiled one
# split backward against fused, relative to each gradient leaf's scale
SPLIT_TOL = {"float32": 1e-4, "bfloat16": 0.05}


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_runs(fn, iters: int, warmup: int = 1, repeats: int = 1) -> list:
    """ms per call of ``repeats`` measurements of ``iters`` calls each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return runs


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    return time_runs(fn, iters, warmup)[0]


def time_median(fn, iters: int) -> tuple:
    """(median, [min, max]) ms per call over REPEATS measurements."""
    runs = time_runs(fn, iters, WARMUP, REPEATS)
    return float(np.median(runs)), [min(runs), max(runs)]


def check(name: str, got, want, rel_tol: float) -> float:
    """Each output's max abs error must stay within rel_tol of that
    output's largest magnitude; returns the max abs error over outputs
    (a tensor or a tuple of them)."""
    if torch.is_tensor(got):
        got, want = (got,), (want,)
    errs, rels = [], []
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        errs.append(err)
        rels.append(err / max(float(b.float().abs().max()), 1e-30))
    ok = max(rels) <= rel_tol
    log("check", kernel=name, max_abs_err=max(errs), max_rel_err=max(rels),
        rel_tol=rel_tol, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: relative error {max(rels)} > {rel_tol}")
    return max(errs)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _valid_pairs(Sq, Skv, causal, window):
    q = np.arange(Sq)[:, None]
    k = np.arange(Skv)[None, :]
    m = np.ones((Sq, Skv), bool)
    if causal:
        m &= q >= k
    if window:
        m &= (q - k) < window
    return int(m.sum())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def fa_case(dev, B, S, Hkv, G, hd, window, cap, dtype, iters, library,
            Skv=None, kv_len=None):
    """Causal attention of S queries over Skv keys (default S), the first
    kv_len of them valid (default Skv)."""
    Skv = S if Skv is None else Skv
    kv_len = Skv if kv_len is None else kv_len
    gen = torch.Generator(device=dev).manual_seed(0)
    BH, BKV = B * Hkv * G, B * Hkv
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((BH, S, hd), (BKV, Skv, hd), (BKV, Skv, hd)))
    kw = dict(group=G, causal=True, window=window, softcap=cap,
              scale=1 / math.sqrt(hd), kv_len=kv_len)
    o, lse = FK.flash_fwd(q, k, v, **kw)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    tag = (f"B{B} S{S} Skv{Skv} kv_len{kv_len} Hkv{Hkv} G{G} hd{hd} "
           f"window{window} cap{cap}")
    errs = {"flash_fwd": check(f"flash_fwd {tag}", (o, lse), (o_p, lse_p),
                               1e-4)}
    # the fused kernel takes an fp32 dO (its hi/lo split is checked); the
    # split sweeps read dO in q's dtype, as ops.py hands it to them
    do = torch.randn(o.shape, generator=gen, device=dev)
    do_q = do.to(dtype)
    fused_args = (q, k, v, do, lse_p, torch.sum(do * o_p, dim=-1))
    split_args = (q, k, v, do_q, lse_p, torch.sum(do_q.float() * o_p, dim=-1))
    bwd = {"flash_bwd_fused": (FK.flash_bwd_fused, FK.flash_bwd_fused_plain,
                               fused_args),
           "flash_bwd_dq": (FK.flash_bwd_dq, FK.flash_bwd_dq_plain,
                            split_args),
           "flash_bwd_dkv": (FK.flash_bwd_dkv, FK.flash_bwd_dkv_plain,
                             split_args)}
    for name, (fn, plain, bargs) in bwd.items():
        got = fn(*bargs, **kw)
        errs[name] = check(f"{name} {tag}", got, plain(*bargs, **kw), 1e-4)
        if not all(torch.equal(a, b) for a, b in zip(got, fn(*bargs, **kw))):
            raise AssertionError(f"{name} {tag}: two calls differ")
    if not library:
        return None
    pairs = BH * _valid_pairs(S, S, True, window)
    isz = q.element_size()
    in_bytes = (BH + 2 * BKV) * S * hd * isz          # q, k, v
    lse_delta = BH * S * 2 * 4
    # + dO as each kernel reads it (fp32 for fused, q's dtype for the sweeps)
    bwd_in = {"flash_bwd_fused": in_bytes + BH * S * hd * 4 + lse_delta,
              "flash_bwd_dq": in_bytes + BH * S * hd * isz + lse_delta,
              "flash_bwd_dkv": in_bytes + BH * S * hd * isz + lse_delta}
    def timed(fn, plain, bound):
        (ms, ms_range), (plain_ms, _) = (time_median(f, iters)
                                         for f in (fn, plain))
        return dict(ms=ms, ms_range=ms_range, plain_ms=plain_ms, bound=bound)

    res = {"flash_fwd": timed(
        lambda: FK.flash_fwd(q, k, v, **kw),
        lambda: FK.flash_fwd_plain(q, k, v, **kw),
        bound_ms(in_bytes + BH * S * (hd + 1) * 4, 4 * hd * pairs, dtype))}
    # products per unmasked pair: fused S, dP, dV, dK, dQ; dq sweep S, dP,
    # dQ; dk/dv sweep S, dP, dV, dK (2 * hd flops each)
    out_bytes = {"flash_bwd_fused": (BH + 2 * BKV) * S * hd * 4,
                 "flash_bwd_dq": BH * S * hd * 4,
                 "flash_bwd_dkv": 2 * BKV * S * hd * 4}
    products = {"flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
    for name, (fn, plain, bargs) in bwd.items():
        res[name] = timed(lambda: fn(*bargs, **kw),
                          lambda: plain(*bargs, **kw),
                          bound_ms(bwd_in[name] + out_bytes[name],
                                   2 * products[name] * hd * pairs, dtype))
    if dtype == torch.float32:
        # the tensor-core instantiations: their passes over the planes,
        # beside the softmax's elementwise work (about 4 ops a pair
        # forward, 6 backward)
        passes = {"flash_fwd": FA_FWD_PASSES,
                  "flash_bwd_fused": FA_BWD_PASSES,
                  "flash_bwd_dq": FA_DQ_PASSES,
                  "flash_bwd_dkv": FA_DKV_PASSES}
        nbytes = {"flash_fwd": in_bytes + BH * S * (hd + 1) * 4,
                  **{name: bwd_in[name] + out_bytes[name] for name in bwd}}
        n_products = {"flash_fwd": 2, **products}
        for name in passes:
            ew = 4 if name == "flash_fwd" else 6
            # split_bound over one product's flops with every pass of the
            # kernel; its fp32-FMA bound over all the products
            bms, by, n, _ = split_bound(2 * hd * pairs, ew * pairs,
                                        nbytes[name], passes[name])
            fma_ms = bound_ms(nbytes[name],
                              (2 * n_products[name] * hd + ew) * pairs,
                              torch.float32)[0]
            res[name].update(bound=(bms, by), bound_passes=n,
                             bound_fp32_fma_ms=fma_ms)
    for name, r in res.items():
        r["max_abs_err"] = errs[name]
    # yardstick only: one PyTorch call computing the same function
    q4 = q.reshape(B, Hkv * G, S, hd).requires_grad_(True)
    k4 = k.reshape(B, Hkv, S, hd).requires_grad_(True)
    v4 = v.reshape(B, Hkv, S, hd).requires_grad_(True)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        return sdpa(q4, k4, v4, is_causal=True, scale=kw["scale"],
                    enable_gqa=True)

    with torch.no_grad():
        (res["flash_fwd"]["library_ms"],
         res["flash_fwd"]["library_ms_range"]) = time_median(lib_fwd, iters)
    out = lib_fwd()
    do4 = do.reshape(B, Hkv * G, S, hd).to(dtype)
    lib_bwd, lib_bwd_range = time_median(
        lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
        iters)
    for name in bwd:
        res[name]["library_ms"] = lib_bwd
        res[name]["library_ms_range"] = lib_bwd_range
    log("timing", case=tag, dtype=str(dtype).removeprefix("torch."),
        iters=iters, warmup=WARMUP, repeats=REPEATS,
        **{name: {k: r[k] for k in ("ms", "ms_range", "library_ms",
                                    "library_ms_range", "bound",
                                    "bound_passes", "bound_fp32_fma_ms")
                  if k in r}
           for name, r in res.items()})
    return res


def xent_bound(T, D, V, hdt, backward):
    """(bound ms, by, bf16 passes, fp32-FMA bound ms) for an fp32 w: bytes
    of h, w, labels (+ lse, g, dh, dw in the backward) read or written
    once; the bf16 passes on the tensor cores that carry the fp32 operands
    to 1e-4, hi.lo and lo.hi beside hi.hi (lo.lo dropped): with a bf16 h
    (exact) forward 2, backward 2 + 3 + 2; with an fp32 h (split into hi
    and lo as w is) 3 and 3 + 3 + 3 (a bf16 w: 1 and 1 + 2 + 2, or 2 and
    2 + 2 + 3); beside them one fp32-FMA product per contraction."""
    ops = 2.0 * T * D * V
    nbytes = (T * D * (4 if hdt == torch.float32 else 2) + D * V * 4
              + T * 4 + T * 8)       # + loss, lse out / lse, g in
    if backward:
        nbytes += T * D * 4 + D * V * 4
    fma = bound_ms(nbytes, (3 if backward else 1) * ops, torch.float32)
    passes = {(False, False): 2, (False, True): 7, (True, False): 3,
              (True, True): 9}[hdt == torch.float32, backward]
    return (*bound_ms(nbytes, passes * ops, torch.bfloat16), passes, fma[0])


def xent_case(dev, T, D, V, cap, tied, iters, library, hdt=torch.bfloat16):
    """xent_fwd / xent_bwd against their plain versions (h in hdt, w fp32),
    the backward twice (no atomics: bit-identical)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((T, D), generator=gen, device=dev).to(hdt)
    w = torch.randn((V, D) if tied else (D, V), generator=gen,
                    device=dev) / math.sqrt(D)
    w = w.t() if tied else w
    lab = torch.randint(0, V, (T,), generator=gen, device=dev,
                        dtype=torch.int32)
    loss, lse = XK.xent_fwd(h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    tag = (f"T{T} D{D} V{V} cap{cap} tied{int(tied)} "
           f"h {str(hdt).removeprefix('torch.')}")
    fwd_err = check(f"xent_fwd {tag}", (loss, lse), (loss_p, lse_p), 1e-4)
    del loss_p
    g = torch.full((T,), 1.0 / T, device=dev)
    got = XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap)
    want = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    bwd_err = check(f"xent_bwd {tag}", got, want, 1e-4)
    del want
    again = XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("check", kernel=f"xent_bwd repeat {tag}", bit_identical=same)
    if not same:
        raise AssertionError(f"xent_bwd {tag}: two calls differ")
    del got, again
    if not library:
        return None
    # yardstick only: fp32 logits + F.cross_entropy, and its autograd
    ce = torch.nn.functional.cross_entropy
    hl = h.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    labl = lab.long()

    def lib_fwd():
        with torch.no_grad():
            return ce(hl.float() @ wl, labl, reduction="none")

    out = ce(hl.float() @ wl, labl)
    fns = {"xent_fwd": (lambda: XK.xent_fwd(h, w, lab, softcap=cap),
                        lambda: XK.xent_fwd_plain(h, w, lab, softcap=cap),
                        lib_fwd, fwd_err),
           "xent_bwd": (lambda: XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap),
                        lambda: XK.xent_bwd_plain(h, w, lab, lse_p, g,
                                                  softcap=cap),
                        lambda: torch.autograd.grad(out, (hl, wl),
                                                    retain_graph=True),
                        bwd_err)}
    res, bounds = {}, {}
    for name, (fn, plain, library_fn, err) in fns.items():
        ms, ms_range = time_median(fn, iters)
        plain_ms, _ = time_median(plain, iters)
        lib_ms, lib_range = time_median(library_fn, iters)
        bms, by, passes, fma_ms = xent_bound(T, D, V, hdt,
                                             name == "xent_bwd")
        res[name] = dict(max_abs_err=err, ms=ms, ms_range=ms_range,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         library_ms_range=lib_range, bound=(bms, by))
        bounds[name] = dict(bound_ms=bms, passes=passes,
                            bound_fp32_fma_ms=fma_ms)
    log("timing", case=tag, iters=iters, warmup=WARMUP, repeats=REPEATS,
        **{name: {**{k: r[k] for k in ("ms", "ms_range", "plain_ms",
                                       "library_ms", "library_ms_range")},
                  **bounds[name]}
           for name, r in res.items()})
    return res


def split_bound(products, elementwise, nbytes, passes):
    """(bound ms, by, bf16 passes, fp32-FMA bound ms) of a kernel whose
    products run on the tensor cores as ``passes`` bf16 passes over fp32
    operands split into bf16 planes, beside fp32 elementwise work on the
    CUDA cores.  The two units overlap, so the operations take the longer
    of the two; bytes are read or written once."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(passes * products / PEAK_FLOPS[torch.bfloat16],
                elementwise / PEAK_FLOPS[torch.float32])
    fma_ms = bound_ms(nbytes, products + elementwise, torch.float32)[0]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations", passes, fma_ms)


def ssd_fwd_bound(B, nc, Q, H, P, N):
    """``split_bound`` of the SSD forward.  Products: C.B^T once per (b,
    chunk) over the causal pairs (2 N a pair), per head A x (2 P a pair)
    and the state (w x)^T B (2 Q P N).  Elementwise: the weights (exp and
    two products: 3 ops a pair) and w folded into x (Q P a head).  Bytes:
    x, y; S; dt, a_cum; B, C."""
    BC, pairs = B * nc, Q * (Q + 1) // 2
    return split_bound(
        BC * (2 * pairs * N + H * (2 * pairs * P + 2 * Q * P * N)),
        BC * H * (3 * pairs + Q * P),
        4 * BC * (2 * Q * H * P + H * P * N + 2 * Q * H + 2 * Q * N),
        SSD_FWD_PASSES)


def ssd_bwd_bound(B, nc, Q, H, P, N):
    """``split_bound`` of the SSD backward.  Products: per (b, chunk)
    C.B^T again and dC, dB against dCB (2 N a pair each); per head dA and
    A^T dy (2 P a pair each), U = B dS^T and (w x)^T dS (2 Q P N each).
    Elementwise: the weights (L, G, A, E, their sums and dCB's: 10 ops a
    pair) and Z (2 Q P).  Bytes: x, dy, dx; dS; dt, a_cum, ddt, da_cum;
    B, C, dB, dC."""
    BC, pairs = B * nc, Q * (Q + 1) // 2
    return split_bound(
        BC * (6 * pairs * N + H * (4 * pairs * P + 4 * Q * P * N)),
        BC * H * (10 * pairs + 2 * Q * P),
        4 * BC * (3 * Q * H * P + H * P * N + 4 * Q * H + 4 * Q * N),
        SSD_BWD_PASSES)


def ssd_case(dev, B, nc, Q, H, P, N, iters, library):
    """ssd_intra and its backward against their plain versions, the
    backward twice (no atomics: bit-identical); inputs as the model makes
    them (softplus-range dt, A in [-16, -1], a_cum its in-chunk cumsum),
    cotangents standard normal."""
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((B, nc, Q, H, P), generator=gen, device=dev)
    dt = torch.rand((B, nc, Q, H), generator=gen, device=dev) * 0.1 + 1e-3
    a = -(1.0 + 15.0 * torch.rand((H,), generator=gen, device=dev))
    a_cum = torch.cumsum(dt * a, dim=2)
    bm, cm = (torch.randn((B, nc, Q, N), generator=gen, device=dev)
              for _ in range(2))
    dy = torch.randn((B, nc, Q, H, P), generator=gen, device=dev)
    ds = torch.randn((B, nc, H, P, N), generator=gen, device=dev)
    args = (x, dt, a_cum, bm, cm)
    tag = f"B{B} nc{nc} Q{Q} H{H} P{P} N{N}"
    got = SK.ssd_intra_kernel(*args)
    err = check(f"ssd_intra {tag}", got, SK.ssd_intra_plain(*args), 1e-4)
    again = SK.ssd_intra_kernel(*args)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("check", kernel=f"ssd_intra repeat {tag}", bit_identical=same)
    if not same:
        raise AssertionError(f"ssd_intra {tag}: two calls differ")
    got = SK.ssd_intra_bwd_kernel(*args, dy, ds)
    bwd_err = check(f"ssd_intra_bwd {tag}", got,
                    SK.ssd_intra_bwd_plain(*args, dy, ds), 1e-4)
    again = SK.ssd_intra_bwd_kernel(*args, dy, ds)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log("check", kernel=f"ssd_intra_bwd repeat {tag}", bit_identical=same)
    if not same:
        raise AssertionError(f"ssd_intra_bwd {tag}: two calls differ")
    del got, again
    if not library:
        return None
    fwd_ms, fwd_by, fwd_passes, fwd_fma_ms = ssd_fwd_bound(B, nc, Q, H, P, N)
    bwd_ms, bwd_by, passes, fma_ms = ssd_bwd_bound(B, nc, Q, H, P, N)
    leaves = [t.detach().requires_grad_(True) for t in args]

    def replaced():
        with torch.enable_grad():
            return torch.autograd.grad(SR.ssd_intra_ref(*leaves), leaves,
                                       (dy, ds))

    res = {"ssd_intra": dict(
        max_abs_err=err,
        ms=time_ms(lambda: SK.ssd_intra_kernel(*args), iters),
        plain_ms=time_ms(lambda: SK.ssd_intra_plain(*args), iters),
        bound=(fwd_ms, fwd_by),
        library_ms=None)}
    res["ssd_intra_bwd"] = dict(
        max_abs_err=bwd_err,
        ms=time_ms(lambda: SK.ssd_intra_bwd_kernel(*args, dy, ds), iters),
        plain_ms=time_ms(lambda: SK.ssd_intra_bwd_plain(*args, dy, ds),
                         iters),
        replaced_ms=time_ms(replaced, iters),
        bound=(bwd_ms, bwd_by),
        library_ms=None)
    log("timing", case=tag, iters=iters,
        **{name: {k: v for k, v in r.items() if k != "max_abs_err"}
           for name, r in res.items()},
        ssd_intra_bound=dict(bound_ms=fwd_ms, by=fwd_by, passes=fwd_passes,
                             bound_fp32_fma_ms=fwd_fma_ms),
        ssd_intra_bwd_bound=dict(bound_ms=bwd_ms, by=bwd_by, passes=passes,
                                 bound_fp32_fma_ms=fma_ms))
    return res


# ---------------------------------------------------------------------------
# Phases 4, 5 and 6
# ---------------------------------------------------------------------------


def smoke_reference(dev, arch):
    """The launcher's path on ``arch``'s smoke config from the same initial
    states, on the card and on the CPU: histories agree."""
    cfg = registry.get_smoke_config(arch)
    args = launch_train.make_parser().parse_args(
        ["--arch", arch, "--clients", "4", "--cohort", "2", "--local-steps",
         "2", "--batch-size", "4", "--server-batch", "8"])
    run_cfg = launch_train.build_run_cfg(args)
    model = build_model(cfg)
    train = make_dataset_for_model(model, 64, seq_len=32, seed=0)
    evald = make_dataset_for_model(model, 16, seq_len=32, seed=1)
    cpu = torch.device("cpu")
    init = AmpereTrainer(model, run_cfg, [], evald, device=cpu)._init_states(
        torch.Generator().manual_seed(0))
    hist = {}
    for d in (dev, cpu):
        tr = AmpereTrainer(model, run_cfg,
                           federate(train, 4, args.alpha, seed=0), evald,
                           device=d)
        dp, sp, ap = tree_map(lambda t: t.to(d), init)
        st = tr.run_device_phase({"device": dp, "aux": ap}, 2)
        store = tr.generate_activations(st, ActivationStore(seed=0))
        tr.run_server_phase(st, sp, store, 2)
        hist[d.type] = tr.history
    for phase in ("device", "server"):
        for a, b in zip(hist["cuda"][phase], hist["cpu"][phase]):
            for key in ("loss", "val_loss"):
                if not abs(a[key] - b[key]) <= 1e-4 * abs(b[key]):
                    raise AssertionError(f"{arch} smoke {phase} {key}: "
                                         f"{a} vs {b}")
    log("reference", arch=cfg.name, cuda=hist["cuda"], cpu=hist["cpu"],
        rel_tol=1e-4)


def full_corpus(n, seq, vocab, seed):
    """The unchanged bigram generator at vocab 257, its ids mapped into
    [0, vocab) by a fixed injection drawn from ``seed``."""
    small = make_lm_dataset(n, seq_len=seq, vocab=257, seed=seed)
    inj = np.random.default_rng(1234).choice(vocab, size=257, replace=False)
    return Dataset({"tokens": inj[small.arrays["tokens"]].astype(np.int32)},
                   small.labels)


def reset_launches():
    for fn in WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_dtype"):
            fn.launches_by_dtype = {}


def read_launches() -> dict:
    """Launches per row of the kernels line."""
    out = {}
    for name in KERNELS:
        if name in BY_DTYPE:
            wrapper, dtype = BY_DTYPE[name]
            out[name] = WRAPPERS[wrapper].launches_by_dtype.get(dtype, 0)
        else:
            out[name] = WRAPPERS[name].launches
    return out


def main_path(dev, arch, quantize=False):
    """One main path through the launcher; with ``quantize`` the store
    keeps and ships int8 activations (one fp32 scale a row).  Returns the
    launches and the history."""
    spec = MAIN_PATHS[arch]
    seq, lr = spec["seq"], spec["lr"]
    cfg = registry.get_config(arch)
    argv = ["--arch", arch, "--clients", "4", "--cohort", "2",
            "--local-steps", "2", "--batch-size", "4", "--server-batch", "8",
            "--seq-len", str(seq), "--lr", str(lr), "--seed", "0"]
    if quantize:
        argv.append("--quantize-acts")
    largs = launch_train.make_parser().parse_args(argv)
    train = full_corpus(TRAIN_SAMPLES, seq, cfg.vocab_size, 0)
    evald = full_corpus(EVAL_SAMPLES, seq, cfg.vocab_size, 1)
    run_cfg = launch_train.build_run_cfg(largs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = launch_train.run_training(
        cfg, run_cfg, train, evald, device=dev,
        device_rounds=DEVICE_ROUNDS, server_epochs=SERVER_EPOCHS)
    launches = read_launches()
    hist = out["history"]
    nbytes = out["store"].bytes_received
    log("main_path_int8" if quantize else "main_path", arch=cfg.name,
        layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=seq, lr=lr,
        seconds=out["seconds"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        device=hist["device"], server=hist["server"], launches=launches,
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        bytes_received=nbytes)
    # a sample ships (seq x d_model) activations, fp32 or int8 with one
    # fp32 scale per token, and its seq int32 labels
    per_sample = (seq * cfg.d_model + seq * 4 if quantize
                  else seq * cfg.d_model * 4) + seq * 4
    check_accounting(cfg, run_cfg, seq, hist, out["store"],
                     TRAIN_SAMPLES * per_sample)
    losses = [r[k] for ph in ("device", "server") for r in hist[ph]
              for k in ("loss", "val_loss")]
    if len(hist["device"]) != DEVICE_ROUNDS or \
            len(hist["server"]) != SERVER_EPOCHS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch} main path history not finite/complete:"
                             f" {hist}")
    # random init sits above ln V; the merged model must have learned
    if not hist["server"][-1]["val_loss"] < math.log(cfg.vocab_size):
        raise AssertionError(f"{arch}: merged model did not train below "
                             f"ln V: {hist}")
    for name in spec["kernels"]:
        if launches[name] <= 0:
            raise AssertionError(f"{arch} main path never launched {name}")
    shapes = {k: tuple(v.shape) for k, v in
              out["merged_params"]["embed"].items()}
    if shapes != {"table": (cfg.vocab_size, cfg.d_model)}:
        raise AssertionError(f"merged params: unexpected {shapes}")
    return launches, hist


def int8_main_path(dev, fp32_hist):
    """The int8 main path against the fp32 one from the same init: the
    upload shrinks to int8 payloads, and ``comm_bytes`` and ``sim_time``
    fall by exactly that upload's bytes and their time on the link."""
    launches, hist = main_path(dev, INT8_ARCH, quantize=True)
    cfg = registry.get_config(INT8_ARCH)
    seq = MAIN_PATHS[INT8_ARCH]["seq"]
    fp32_bytes = TRAIN_SAMPLES * (seq * cfg.d_model * 4 + seq * 4)
    int8_bytes = TRAIN_SAMPLES * (seq * cfg.d_model + seq * 4 + seq * 4)
    saved = fp32_bytes - int8_bytes
    comm_ok = hist["comm_bytes"] == fp32_hist["comm_bytes"] - saved
    time_moved = fp32_hist["sim_time"] - hist["sim_time"]
    time_ok = math.isclose(time_moved, saved / comm_model.BANDWIDTH_BPS,
                           rel_tol=1e-9)
    log("int8_vs_fp32", arch=INT8_ARCH, fp32_bytes=fp32_bytes,
        int8_bytes=int8_bytes, comm_bytes_fp32=fp32_hist["comm_bytes"],
        comm_bytes_int8=hist["comm_bytes"], sim_time_moved_s=time_moved,
        upload_s_saved=saved / comm_model.BANDWIDTH_BPS,
        comm_ok=comm_ok, time_ok=time_ok)
    if not (comm_ok and time_ok):
        raise AssertionError("int8 main path: comm_bytes / sim_time do not "
                             "move by the upload's bytes")
    return launches


def check_accounting(cfg, run_cfg, seq, hist, store, want_bytes, *,
                     rounds=DEVICE_ROUNDS, epochs=SERVER_EPOCHS):
    """A path's bytes and simulated time, recomputed from the port's comm
    model at full width (analytic: no device number): the store holds
    ``want_bytes``, ``comm_bytes`` = rounds x 2K(s_d + s_aux) + those
    bytes, ``sim_time`` = the rounds' slowest clients + the upload + the
    server epochs, in the Runner's order."""
    nbytes = store.bytes_received
    sizes = comm_model.split_sizes(build_model(cfg), run_cfg.split,
                                   seq_len=seq)
    K = run_cfg.fed.clients_per_round
    want_comm = rounds * 2 * K * (sizes.device + sizes.aux) + nbytes
    rng = np.random.default_rng(run_cfg.fed.seed)
    want_time = 0.0              # summed in the Runner's order
    for rnd in range(rounds):
        want_time += aggregation.sample_cohort(rng, run_cfg.fed,
                                               rnd)["round_time"]
    want_time += nbytes / comm_model.BANDWIDTH_BPS
    epoch_s = comm_model.ampere_server_epoch_time(
        build_model(cfg), run_cfg.split, comm_model.TimeModel(),
        n_samples=store.num_samples(), seq_len=seq, sizes=sizes)
    for _ in range(epochs):
        want_time += epoch_s
    got = (nbytes, hist["comm_bytes"], hist["sim_time"])
    want = (want_bytes, want_comm, want_time)
    log("accounting", arch=cfg.name, device_bytes=sizes.device,
        aux_bytes=sizes.aux, server_bytes=sizes.server,
        bytes_received=nbytes, comm_bytes=hist["comm_bytes"],
        sim_time_s=hist["sim_time"], server_epoch_s=epoch_s,
        ok=got == want)
    if got != want:
        raise AssertionError(f"{cfg.name} accounting: (bytes_received, "
                             f"comm_bytes, sim_time) {got} != {want}")


EXPERIMENT_FED = dict(num_clients=4, clients_per_round=2, local_steps=2,
                      device_batch_size=4, server_batch_size=8, seed=0)


def experiment_spec(results_dir) -> ExperimentSpec:
    """The qwen3-1.7b smoke experiment, checkpointed after every round and
    epoch under ``results_dir``."""
    run = RunConfig(arch="qwen3-1.7b", fed=FedConfig(**EXPERIMENT_FED),
                    optim=OptimConfig(name="momentum", lr=0.2,
                                      schedule="inverse_time",
                                      decay_gamma=0.005),
                    checkpoint_every=1)
    return ExperimentSpec(
        name="chip_smoke", arch="qwen3-1.7b", run=run,
        data=DataSpec(train_samples=64, eval_samples=16, seq_len=32),
        max_rounds=2, max_server_epochs=2, patience=50, persist=True,
        results_dir=str(results_dir))


def _histories_close(a, b, what):
    for phase, n in (("device", 2), ("server", 2)):
        if not len(a[phase]) == len(b[phase]) == n:
            raise AssertionError(f"{what}: {phase} {a[phase]} vs {b[phase]}")
        for x, y in zip(a[phase], b[phase]):
            for key in ("loss", "val_loss"):
                if not abs(x[key] - y[key]) <= 1e-4 * abs(y[key]):
                    raise AssertionError(f"{what} {phase} {key}: {x} vs {y}")
            if not abs(x["val_acc"] - y["val_acc"]) <= 1e-2:
                raise AssertionError(f"{what} {phase} val_acc: {x} vs {y}")


def experiment(dev):
    """run_experiment on the card and on the CPU, then a card run killed
    after round 0 and resumed from its workdir."""
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        card = run_experiment(experiment_spec(os.path.join(tmp, "card")),
                              device=dev)
        launches = read_launches()
        cpu = run_experiment(experiment_spec(os.path.join(tmp, "cpu")),
                             device="cpu")
        spec, model, clients, evald = resolve_setup(
            experiment_spec(os.path.join(tmp, "resumed")))
        ctx = SystemContext(model=model, run_cfg=spec.run, clients=clients,
                            eval_data=evald,
                            workdir=os.path.join(spec.results_dir, "ampere"),
                            patience=spec.patience, device=dev)
        dev_state, _ = AmpereSystem().init_state(ctx)
        ctx.trainer.run_device_phase(dev_state, 1)      # killed here
        ctx.trainer.runner.close()
        resumed = run_experiment(spec, device=dev)
    h_card, h_cpu, h_res = (o["results"]["ampere"]["history"]
                            for o in (card, cpu, resumed))
    log("experiment", arch="qwen3-1.7b", card=h_card, cpu=h_cpu,
        resumed=h_res, summary=card["summary"]["ampere"], rel_tol=1e-4,
        launches=launches)
    _histories_close(h_card, h_cpu, "experiment card vs cpu")
    if h_res != h_card:
        raise AssertionError(f"experiment resumed vs uninterrupted: {h_res} "
                             f"vs {h_card}")
    for h in (h_cpu, h_res):
        for key in ("comm_bytes", "sim_time"):
            if h[key] != h_card[key]:
                raise AssertionError(f"experiment {key}: {h[key]} vs "
                                     f"{h_card[key]}")
    # the smoke config computes in fp32: its rows are the *_fp32 ones
    for name in ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd"):
        if launches[f"{name}_fp32"] <= 0:
            raise AssertionError(f"experiment never launched {name}")
    return launches, h_card


def _budget_spec(results_dir, budget_mb, quantize):
    spec = experiment_spec(results_dir)
    run = dataclasses.replace(
        spec.run, device_pool_budget_mb=budget_mb,
        split=dataclasses.replace(spec.run.split,
                                  quantize_activations=quantize))
    return dataclasses.replace(spec, run=run)


class _CountedPrefetcher(uit.DevicePrefetcher):
    """``DevicePrefetcher`` counting the card batches it hands over."""
    batches = 0

    def __iter__(self):
        for batch in super().__iter__():
            if any(t.device.type != "cuda" for t in batch.values()):
                raise AssertionError("the prefetcher yielded a host batch")
            _CountedPrefetcher.batches += 1
            yield batch


def host_streaming(dev, card_hist):
    """The phase 8 experiment on the card with ``device_pool_budget_mb``
    0, fp32 and int8: the device phase uploads each round's batches and
    the server phase streams the store's batches through the
    ``DevicePrefetcher`` (pinned memory, a side stream, an event wait);
    each history equals (``==``) the resident card run's, fp32 against
    phase 8's, int8 against a resident int8 run.  Launches: the two
    streamed runs."""
    with tempfile.TemporaryDirectory() as tmp:
        int8_resident = run_experiment(
            _budget_spec(os.path.join(tmp, "int8"), 1024, True), device=dev)
        prefetcher, uit.DevicePrefetcher = (uit.DevicePrefetcher,
                                            _CountedPrefetcher)
        try:
            reset_launches()
            streamed = {q: run_experiment(
                _budget_spec(os.path.join(tmp, f"stream{q}"), 0, q),
                device=dev) for q in (False, True)}
            launches = read_launches()
        finally:
            uit.DevicePrefetcher = prefetcher
    want = {False: card_hist,
            True: int8_resident["results"]["ampere"]["history"]}
    got = {q: o["results"]["ampere"]["history"] for q, o in streamed.items()}
    log("host_streaming", arch="qwen3-1.7b", budget_mb=0,
        prefetched_batches=_CountedPrefetcher.batches,
        fp32=got[False], int8=got[True], int8_resident=want[True],
        launches=launches)
    # 2 runs x 2 epochs x (64 samples // server batch 8)
    if _CountedPrefetcher.batches != 2 * 2 * 8:
        raise AssertionError(f"host streaming: the prefetcher handed over "
                             f"{_CountedPrefetcher.batches} batches")
    for q in (False, True):
        if got[q] != want[q]:
            raise AssertionError(f"host streaming (int8 {q}) vs resident: "
                                 f"{got[q]} vs {want[q]}")
    for name in ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd"):
        if launches[f"{name}_fp32"] <= 0:
            raise AssertionError(f"host streaming never launched {name}")
    return launches


# ---------------------------------------------------------------------------
# Phases 9 and 10: the paper's vision classifiers
# ---------------------------------------------------------------------------


def profile_vision_step(dev, model, run_cfg, out):
    """A server train step at the server batch from the trained server
    state over the store's first samples, profiled by
    :func:`profile_server_step`."""
    step = steps.make_server_train_step(model, run_cfg)
    bs = run_cfg.fed.server_batch_size
    batch = {k: torch.as_tensor(v[:bs], device=dev)
             for k, v in out["store"].pool().items()}
    state = steps.init_server_state(model, run_cfg,
                                    out["server_state"]["server"])
    profile_server_step(dev, f"vision:{model.cfg.name}", step, state, batch,
                        batch=bs)


def vision_run(dev, arch, lr, epochs=None):
    """One paper classifier at its published config through the launcher
    at ``lr`` (``epochs`` server epochs, ``VISION_EPOCHS`` by default):
    (run_cfg, the launcher's result, launches)."""
    cfg = registry.get_config(arch)
    largs = launch_train.make_parser().parse_args(
        ["--arch", arch, *VISION_ARGS, "--lr", str(lr)])
    run_cfg = launch_train.build_run_cfg(largs)
    model = build_model(cfg)
    train = make_dataset_for_model(model, VISION_TRAIN, seed=0)
    evald = make_dataset_for_model(model, VISION_EVAL, seed=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = launch_train.run_training(
        cfg, run_cfg, train, evald, device=dev, device_rounds=VISION_ROUNDS,
        server_epochs=epochs or VISION_EPOCHS)
    return run_cfg, out, read_launches()


def vision_path(dev, arch):
    """``vision_run`` at ``VISION_LR``: finite losses, the store's and the
    comm model's bytes and times, the merged model through the gate
    (``VISION_MIN_ACC``, ``VISION_LOSS_MARGIN`` under ln(classes)), and
    no hand-written kernel launched (the reference's vision path reaches
    no Pallas kernel)."""
    cfg = registry.get_config(arch)
    model = build_model(cfg)
    lr = VISION_LR[arch]
    run_cfg, out, launches = vision_run(dev, arch, lr)
    hist = out["history"]
    acts = model.activation_spec(1, split_point=run_cfg.split.split_point,
                                 dtype="float32")
    log("vision", arch=cfg.name, family=cfg.family, layers=cfg.num_layers,
        lr=lr, act_shape=list(acts.shape[1:]), seconds=out["seconds"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        device=hist["device"], server=hist["server"],
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        bytes_received=out["store"].bytes_received,
        launches=sum(launches.values()), card=card_line())
    check_accounting(cfg, run_cfg, 0, hist, out["store"],
                     VISION_TRAIN * (math.prod(acts.shape) * 4 + 4),
                     rounds=VISION_ROUNDS, epochs=VISION_EPOCHS)
    losses = [r[k] for ph in ("device", "server") for r in hist[ph]
              for k in ("loss", "val_loss")]
    if len(hist["device"]) != VISION_ROUNDS or \
            len(hist["server"]) != VISION_EPOCHS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{arch}: history not finite/complete: {hist}")
    last = hist["server"][-1]
    if not (last["val_acc"] >= VISION_MIN_ACC and last["val_loss"] <=
            math.log(cfg.num_classes) - VISION_LOSS_MARGIN):
        raise AssertionError(
            f"{arch}: merged model below the gate (acc >= {VISION_MIN_ACC}, "
            f"val loss <= ln {cfg.num_classes} - {VISION_LOSS_MARGIN}): "
            f"{hist}")
    if any(launches.values()):
        raise AssertionError(f"{arch}: the vision path launched a "
                             f"hand-written kernel: {launches}")
    profile_vision_step(dev, model, run_cfg, out)
    return launches


def vision_spec(arch, results_dir) -> ExperimentSpec:
    run = RunConfig(arch=arch, fed=FedConfig(**EXPERIMENT_FED),
                    optim=OptimConfig(name="momentum",
                                      lr=VISION_EXPERIMENT_LR,
                                      schedule="inverse_time",
                                      decay_gamma=0.005))
    return ExperimentSpec(
        name=f"chip_smoke_{arch}", arch=arch, smoke=True, run=run,
        data=DataSpec(train_samples=64, eval_samples=16),
        max_rounds=2, max_server_epochs=2, patience=50,
        results_dir=str(results_dir))


def vision_experiment(dev):
    """The four smoke classifiers through run_experiment on the card and
    on the CPU from the same CPU-seeded init: losses within 1e-4
    relative, accuracies within 1e-2, comm_bytes and sim_time equal (TF32
    is off for cuBLAS and cuDNN, which this tolerance assumes)."""
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for arch in VISION_ARCHS:
            reset_launches()
            card = run_experiment(vision_spec(arch, tmp), device=dev,
                                  write_results=False)
            for name, n in read_launches().items():
                launches[name] = launches.get(name, 0) + n
            # cuDNN's deterministic algorithms (device.pin_deterministic):
            # a second card run repeats the first bit for bit
            again = run_experiment(vision_spec(arch, tmp), device=dev,
                                   write_results=False)
            if again["results"]["ampere"]["history"] != \
                    card["results"]["ampere"]["history"]:
                raise AssertionError(f"{arch} smoke: a second card run "
                                     "differs from the first")
            cpu = run_experiment(vision_spec(arch, tmp), device="cpu",
                                 write_results=False)
            h_card, h_cpu = (o["results"]["ampere"]["history"]
                             for o in (card, cpu))
            log("vision_experiment", arch=f"{arch}-smoke", card=h_card,
                cpu=h_cpu, rel_tol=1e-4)
            _histories_close(h_card, h_cpu, f"{arch} smoke card vs cpu")
            for key in ("comm_bytes", "sim_time"):
                if h_card[key] != h_cpu[key]:
                    raise AssertionError(f"{arch} smoke {key}: "
                                         f"{h_card[key]} vs {h_cpu[key]}")
    if any(launches.values()):
        raise AssertionError(f"vision experiment launched a hand-written "
                             f"kernel: {launches}")
    flags = tf32_flags()
    log("precision", **flags)
    if any(flags.values()):
        raise AssertionError(f"TF32 on after the port's entry points: "
                             f"{flags}")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the synchronous baselines
# ---------------------------------------------------------------------------


def baseline_accounting(cfg, run_cfg, seq, hist, algo, rounds):
    """A baseline's bytes and simulated time, recomputed from the port's
    comm model (analytic: no device number): per round, SFL moves 2K x
    (H iterations of activations and gradients + the device block down and
    up) // 2 x 2, FedAvg 2K x the whole model; the clock adds each round's
    ``epoch_time`` (every SFL variant but PiPar priced as SplitFed, as the
    reference prices it), in the Runner's order."""
    model = build_model(cfg)
    sizes = comm_model.split_sizes(model, run_cfg.split, seq_len=max(seq, 1))
    fed = run_cfg.fed
    K, H, b = fed.clients_per_round, fed.local_steps, fed.device_batch_size
    if algo == "fedavg":
        per_round = 2 * K * comm_model.tree_bytes(
            comm_model.abstract_params(model))
    else:
        per_round = 2 * K * ((2 * sizes.act_per_sample * b * H
                              + 2 * sizes.device) // 2)
    epoch_s = comm_model.epoch_time(
        algo if algo in ("fedavg", "pipar") else "splitfed", model,
        run_cfg.split, comm_model.TimeModel(), n_samples=b * H,
        batch_size=b, seq_len=seq, sizes=sizes)
    want_time = 0.0              # summed in the Runner's order
    for _ in range(rounds):
        want_time += epoch_s
    got = (hist["comm_bytes"], hist["sim_time"])
    want = (rounds * per_round, want_time)
    log("baseline_accounting", arch=cfg.name, algo=algo,
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        per_round_bytes=per_round, round_s=epoch_s, ok=got == want)
    if got != want:
        raise AssertionError(f"{cfg.name} {algo} accounting: (comm_bytes, "
                             f"sim_time) {got} != {want}")


def baseline_path(dev, algo):
    """``algo``'s trainer on full-width, full-depth qwen3-1.7b through
    ``launch.train.run_baseline`` (the main path's corpus, seq and lr, 4
    clients, cohort 2, H 2, device batch 4, ``DEVICE_ROUNDS`` rounds):
    its kernels launched (FedAvg's loss is the reference's from
    materialized logits, so no cross-entropy kernel), every loss finite,
    the merged model's val loss lower after the second round than after
    the first, and the accounting of :func:`baseline_accounting`."""
    arch = BASELINE_ARCH
    seq, lr = MAIN_PATHS[arch]["seq"], MAIN_PATHS[arch]["lr"]
    cfg = registry.get_config(arch)
    largs = launch_train.make_parser().parse_args(
        ["--arch", arch, "--algo", algo, "--clients", "4", "--cohort", "2",
         "--local-steps", "2", "--batch-size", "4", "--seq-len", str(seq),
         "--lr", str(lr), "--seed", "0"])
    run_cfg = launch_train.build_run_cfg(largs)
    train = full_corpus(TRAIN_SAMPLES, seq, cfg.vocab_size, 0)
    evald = full_corpus(EVAL_SAMPLES, seq, cfg.vocab_size, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = launch_train.run_baseline(cfg, run_cfg, train, evald, device=dev,
                                    rounds=DEVICE_ROUNDS)
    launches = read_launches()
    hist = out["history"]
    log("baseline", arch=cfg.name, algo=algo, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=seq, lr=lr,
        seconds=out["seconds"],
        round_s=out["seconds"]["rounds"] / DEVICE_ROUNDS,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        rounds=hist["rounds"], launches=launches,
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        card=card_line())
    del out
    baseline_accounting(cfg, run_cfg, seq, hist, algo, DEVICE_ROUNDS)
    recs = hist["rounds"]
    if len(recs) != DEVICE_ROUNDS or not all(
            math.isfinite(r[k]) for r in recs for k in ("loss", "val_loss")):
        raise AssertionError(f"{algo}: history not finite/complete: {hist}")
    if not recs[1]["val_loss"] < recs[0]["val_loss"]:
        raise AssertionError(f"{algo}: merged val loss did not fall from "
                             f"round 0 to round 1: {recs}")
    for name in BASELINE_KERNELS[algo]:
        if launches[name] <= 0:
            raise AssertionError(f"{algo} never launched {name}")
    if algo == "fedavg" and launches["xent_fwd"] + launches["xent_bwd"]:
        raise AssertionError(f"fedavg launched the xent kernels: {launches}")
    return launches


def paper_comparison(dev):
    """Ampere against SplitFed on the published mobilenet-l through
    ``run_experiment`` (the vision phase's federation, samples, rounds and
    ``VISION_LR``; ``COMPARISON_EPOCHS`` server epochs): both accountings
    ``==`` the comm model's, and the device-server traffic Ampere saves."""
    arch = "mobilenet-l"
    cfg = registry.get_config(arch)
    fed = FedConfig(num_clients=8, clients_per_round=4, local_steps=8,
                    device_batch_size=16, server_batch_size=32,
                    dirichlet_alpha=0.33, seed=0)
    run = RunConfig(arch=arch, fed=fed, optim=OptimConfig(
        name="momentum", lr=VISION_LR[arch], schedule="inverse_time",
        decay_gamma=0.005))
    spec = ExperimentSpec(
        name="chip_smoke_comparison", systems=("ampere", "splitfed"),
        arch=arch, smoke=False, run=run,
        data=DataSpec(train_samples=VISION_TRAIN, eval_samples=VISION_EVAL),
        max_rounds=VISION_ROUNDS, max_server_epochs=COMPARISON_EPOCHS,
        patience=50)
    reset_launches()
    t = time.perf_counter()
    out = run_experiment(spec, device=dev, write_results=False)
    seconds = time.perf_counter() - t
    launches = read_launches()
    amp, sfl = (out["results"][n] for n in ("ampere", "splitfed"))
    acts = build_model(cfg).activation_spec(1, dtype="float32")
    check_accounting(cfg, run, 0, amp["history"], amp["store"],
                     VISION_TRAIN * (math.prod(acts.shape) * 4 + 4),
                     rounds=VISION_ROUNDS, epochs=COMPARISON_EPOCHS)
    baseline_accounting(cfg, run, 0, sfl["history"], "splitfed",
                        VISION_ROUNDS)
    a_bytes = amp["history"]["comm_bytes"]
    s_bytes = sfl["history"]["comm_bytes"]
    log("paper_comparison", arch=cfg.name, seconds=seconds,
        ampere_comm_bytes=a_bytes, splitfed_comm_bytes=s_bytes,
        comm_reduction=1 - a_bytes / s_bytes,
        ampere_sim_time_s=amp["history"]["sim_time"],
        splitfed_sim_time_s=sfl["history"]["sim_time"],
        ampere_final=amp["history"]["server"][-1],
        splitfed_final=sfl["history"]["rounds"][-1], card=card_line())
    if not 0 < a_bytes < s_bytes:
        raise AssertionError(f"comparison: Ampere {a_bytes} B vs SplitFed "
                             f"{s_bytes} B")
    if any(launches.values()):
        raise AssertionError(f"comparison launched a hand-written kernel: "
                             f"{launches}")
    return launches


def baselines_experiment(dev):
    """The seven synchronous systems on the qwen3-1.7b smoke spec through
    run_experiment on the card and on the CPU from the same CPU-seeded
    init: losses within 1e-4 relative, accuracies within 1e-2,
    comm_bytes and sim_time equal (SCAFFOLD's per-client controls only at
    this size)."""
    run = RunConfig(arch="qwen3-1.7b", fed=FedConfig(**EXPERIMENT_FED),
                    optim=OptimConfig(name="momentum", lr=0.2,
                                      schedule="inverse_time",
                                      decay_gamma=0.005))
    spec = ExperimentSpec(
        name="chip_smoke_baselines", systems=SYNC_SYSTEMS,
        arch="qwen3-1.7b", run=run,
        data=DataSpec(train_samples=64, eval_samples=16, seq_len=32),
        max_rounds=2, patience=50)
    reset_launches()
    card = run_experiment(spec, device=dev, write_results=False)
    launches = read_launches()
    cpu = run_experiment(spec, device="cpu", write_results=False)
    for name in SYNC_SYSTEMS:
        h_card, h_cpu = (o["results"][name]["history"] for o in (card, cpu))
        log("baselines_experiment", system=name, card=h_card, cpu=h_cpu,
            rel_tol=1e-4)
        if not len(h_card["rounds"]) == len(h_cpu["rounds"]) == 2:
            raise AssertionError(f"{name}: {h_card} vs {h_cpu}")
        for x, y in zip(h_card["rounds"], h_cpu["rounds"]):
            for key in ("loss", "val_loss"):
                if not abs(x[key] - y[key]) <= 1e-4 * abs(y[key]):
                    raise AssertionError(f"{name} {key}: {x} vs {y}")
            if not abs(x["val_acc"] - y["val_acc"]) <= 1e-2:
                raise AssertionError(f"{name} val_acc: {x} vs {y}")
        for key in ("comm_bytes", "sim_time"):
            if h_card[key] != h_cpu[key]:
                raise AssertionError(f"{name} {key}: {h_card[key]} vs "
                                     f"{h_cpu[key]}")
    # the smoke config computes in fp32: its rows are the *_fp32 ones
    for name in ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd"):
        if launches[f"{name}_fp32"] <= 0:
            raise AssertionError(f"baselines experiment never launched "
                                 f"{name}")
    return launches


def baselines(dev) -> dict:
    """Phase 11: launches by path of (a), (b) and (c)."""
    by_path = {}
    for algo in BASELINE_KERNELS:
        by_path[f"baseline:{algo}"] = baseline_path(dev, algo)
        torch.cuda.empty_cache()
    by_path["paper_comparison"] = paper_comparison(dev)
    torch.cuda.empty_cache()
    by_path["baselines_experiment"] = baselines_experiment(dev)
    torch.cuda.empty_cache()
    return by_path


def tf32_flags() -> dict:
    return {"cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "cublas_allow_tf32": torch.backends.cuda.matmul.allow_tf32}


def _flat(tree, path=""):
    """(path, leaf) pairs of a nested dict/list of tensors."""
    if isinstance(tree, (list, tuple)):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flat(v, f"{path}/{k}")]
    return [(path, tree)]


def _max_rel(got, want):
    """Largest max-abs difference over leaves, each relative to that leaf's
    largest magnitude, and the leaf that has it."""
    return max((float((a - b).abs().max())
                / max(float(b.abs().max()), 1e-30), path)
               for (path, a), (_, b) in zip(_flat(got), _flat(want)))


def server_step_inputs(dev, arch):
    """A server train step of ``arch`` at its main path's shape (8 x seq)
    from the seed: (model, run_cfg, server params, batch)."""
    cfg = registry.get_config(arch)
    seq = MAIN_PATHS[arch]["seq"]
    run_cfg = launch_train.build_run_cfg(launch_train.make_parser().parse_args(
        ["--arch", arch, "--server-batch", "8", "--seq-len", str(seq),
         "--lr", str(MAIN_PATHS[arch]["lr"]), "--seed", "0"]))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg)
    _, srv = splitting.split_params(model, model.init(gen, dev),
                                    run_cfg.split.split_point)
    batch = {"acts": torch.randn((8, seq, cfg.d_model), generator=gen,
                                 device=dev).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size, (8, seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    return model, run_cfg, srv, batch


def _union_us(intervals):
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_step(dev, arch):
    """One server train step of an LM main path at its shape (8 x seq),
    profiled by :func:`profile_server_step`."""
    model, run_cfg, srv, batch = server_step_inputs(dev, arch)
    step = steps.make_server_train_step(model, run_cfg, impl="kernel")
    state = steps.init_server_state(model, run_cfg, srv)
    del srv
    profile_server_step(dev, arch, step, state, batch,
                        seq=MAIN_PATHS[arch]["seq"], batch=8)


def profile_server_step(dev, arch, step, state, inputs, **shape):
    """One server train step under torch.profiler, after one untimed step
    and PROFILE_STEPS steps timed without the profiler (CUDA events; the
    profiler's CPU tracing slows the host's ~10^4 launches a step, so its
    wall time overstates the step): device time by kernel name (the
    PROFILE_TOP largest), the xent and SSD kernels' shares, each SSD
    kernel's time and calls, the device busy share, the union of kernel
    intervals over the unprofiled step's median time (kernel durations do
    not depend on the host), with the share over the profiled step's wall
    time beside it, and the peak memory of the timed steps."""
    state, _ = step(state, inputs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(PROFILE_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, _ = step(state, inputs)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    step_ms_med = float(np.median(step_ms))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        state, m = step(state, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    loss = float(m["loss"])
    del state
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    if device_ms <= 0:
        log("profile", arch=arch, **shape, wall_s=wall, loss=loss,
            step_ms=step_ms_med, step_ms_range=[min(step_ms), max(step_ms)],
            peak_mem_gib=peak_gib, device_time="not measured",
            device_busy_share="not measured")
        return
    union_ms = _union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / 1e3
    xent_ms = sum(ms for name, (ms, _) in by_name.items() if "xent" in name)
    ssd = {name: v for name, v in by_name.items() if "ssd_" in name}
    ssd_ms = sum(ms for ms, _ in ssd.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    log("profile", arch=arch, **shape,
        step_ms=step_ms_med, step_ms_range=[min(step_ms), max(step_ms)],
        wall_s=wall, loss=loss, peak_mem_gib=peak_gib, device_ms=device_ms,
        device_union_ms=union_ms,
        device_busy_share=union_ms / step_ms_med,
        device_busy_share_profiled=union_ms / 1e3 / wall,
        kernels=len(kernels), xent_ms=xent_ms,
        xent_share_of_step=xent_ms / step_ms_med, ssd_ms=ssd_ms,
        ssd_share_of_step=ssd_ms / step_ms_med,
        ssd_kernels=[{"name": name[:120], "ms": ms, "calls": n,
                      "ms_per_call": ms / n}
                     for name, (ms, n) in sorted(ssd.items())],
        top=[{"name": name[:120], "ms": ms, "calls": n}
             for name, (ms, n) in ranked])


def build_with_ptxas_report():
    """Build the library with ``-Xptxas -v`` and print ptxas's own lines
    (registers, spills, static shared memory) for the kernels whose
    mangled names hold one of PTXAS_REPORT; the dynamic shared memory is
    set at launch (PERF.md gives it).  A library already built prints
    nothing."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        path = build.build(verbose=True)
    keep = False
    for line in buf.getvalue().splitlines():
        if "entry function" in line or "Function properties" in line:
            keep = any(p in line for p in PTXAS_REPORT)
        if keep:
            print(line, flush=True)
    return path


def split_backward(dev):
    """One qwen3-1.7b server train step from the same state and batch with
    the fused and the split attention backward, each twice.  The optimizer
    is the launcher's momentum from a zero buffer, so after one step its
    buffer holds the gradient exactly.

    Neither backward has atomics, so in both dtypes two fused steps and
    two split steps must each give bit-identical gradients.  The split
    gradients must match the fused ones within ``SPLIT_TOL`` of each
    leaf's scale: 1e-4 in fp32; 0.05 in the config's bf16 compute, where
    the two routes' different dQ summation orders flip bf16 roundings
    that 27 layers of backward carry into every gradient."""
    arch = "qwen3-1.7b"
    cfg = registry.get_config(arch)
    seq = MAIN_PATHS[arch]["seq"]
    _, run_cfg, srv, batch = server_step_inputs(dev, arch)
    torch.cuda.empty_cache()
    reset_launches()
    result = {}
    for dtype in dict.fromkeys(("float32", cfg.dtype)):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))

        def run(impl):
            step = steps.make_server_train_step(model, run_cfg, impl=impl)
            new, m = step(steps.init_server_state(model, run_cfg, srv), batch)
            return float(m["loss"]), new["opt"]["mu"]

        (l_f, g_f), (l_s, g_s) = run("kernel"), run("kernel:split")
        rel, leaf = _max_rel(g_s, g_f)
        l_s2, g_s2 = run("kernel:split")
        split_same = l_s2 == l_s and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g_s2),
                                              tree_leaves(g_s)))
        del g_s2
        l_f2, g_f2 = run("kernel")
        fused_rel, fused_leaf = _max_rel(g_f2, g_f)
        fused_same = l_f2 == l_f and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(g_f2),
                                              tree_leaves(g_f)))
        del g_f, g_s, g_f2
        result[dtype] = dict(
            loss_fused=l_f, loss_split=l_s, split_vs_fused=rel,
            split_vs_fused_leaf=leaf, split_bit_identical=split_same,
            fused_vs_fused=fused_rel, fused_vs_fused_leaf=fused_leaf,
            fused_bit_identical=fused_same, split_tol=SPLIT_TOL[dtype])
    launches = read_launches()
    log("split_backward", arch=arch, seq=seq, batch=8, launches=launches,
        **result)
    for dtype, r in result.items():
        if not (r["split_bit_identical"] and r["fused_bit_identical"]
                and r["fused_vs_fused"] == 0.0):
            raise AssertionError(f"{dtype}: a backward's grads differ "
                                 f"between two runs: {r}")
        if not r["split_vs_fused"] <= SPLIT_TOL[dtype]:
            raise AssertionError(f"{dtype}: split grads differ from fused "
                                 f"beyond {SPLIT_TOL[dtype]}: {r}")
        if not abs(r["loss_split"] - r["loss_fused"]) <= \
                1e-5 * abs(r["loss_fused"]):
            raise AssertionError(f"{dtype}: split loss vs fused: {r}")
    for name in BY_DTYPE:
        if launches[name] <= 0:
            raise AssertionError(f"split step never launched {name}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = card_line()
    log("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
        **tf32_flags())
    t = time.perf_counter()
    path = build_with_ptxas_report()
    log("build", seconds=time.perf_counter() - t, library=str(path))

    res = fa_case(dev, 8, SEQ_LEN, 8, 2, 128, 0, 0.0, torch.bfloat16,
                  ITERS_ATTENTION, library=True)
    fa_case(dev, 2, SEQ_LEN, 4, 2, 256, 256, 50.0, torch.bfloat16, 1,
            library=False)
    # ragged S, rows past kv_len + window - 1 with no valid key
    fa_case(dev, 2, 300, 4, 2, 128, 64, 0.0, torch.bfloat16, 1,
            library=False, Skv=130, kv_len=120)
    # the fp32 instantiations at the main shape (the split step's fp32
    # pass), at the gemma2-style case and at the ragged one
    res32 = fa_case(dev, 8, SEQ_LEN, 8, 2, 128, 0, 0.0, torch.float32,
                    ITERS_ATTENTION, library=True)
    for name in FA_BY_DTYPE:
        res[f"{name}_fp32"] = res32[name]
    fa_case(dev, 2, SEQ_LEN, 4, 2, 256, 256, 50.0, torch.float32, 1,
            library=False)
    fa_case(dev, 2, 300, 4, 2, 128, 64, 0.0, torch.float32, 1,
            library=False, Skv=130, kv_len=120)
    # xent: the server heads of both main paths (qwen3 untied, T 8 x 511;
    # mamba2 tied, T 8 x 2047), the tied auxiliary head (T 4 x 511),
    # gemma2's softcap, and an fp32 h (the fp32 smoke configs' and the
    # split step's fp32 pass) at the qwen3 shape
    cfg = registry.get_config("qwen3-1.7b")
    T = 8 * (SEQ_LEN - 1)
    res.update(xent_case(dev, T, cfg.d_model, cfg.vocab_size, 0.0, False,
                         ITERS_XENT, library=True))
    mcfg = registry.get_config("mamba2-370m")
    at_mamba2 = xent_case(dev, 8 * (MAIN_PATHS["mamba2-370m"]["seq"] - 1),
                          mcfg.d_model, mcfg.vocab_size, 0.0, True,
                          ITERS_XENT, library=True)
    for name, r in at_mamba2.items():
        bms, by = r.pop("bound")
        res[name]["at_mamba2_shape"] = dict(r, bound_ms=bms, bound_by=by)
    xent_case(dev, 4 * (SEQ_LEN - 1), cfg.d_model, cfg.vocab_size, 0.0,
              True, 1, library=False)
    g2 = registry.get_config("gemma2-2b")
    xent_case(dev, 1024, g2.d_model, g2.vocab_size, g2.final_softcap, True,
              1, library=False)
    res32 = xent_case(dev, T, cfg.d_model, cfg.vocab_size, 0.0, False, 1,
                      library=True, hdt=torch.float32)
    for name in XENT_BY_DTYPE:
        res[f"{name}_fp32"] = res32[name]
    del at_mamba2, res32
    m2 = registry.get_config("mamba2-370m").mamba
    res.update(ssd_case(dev, 8, 8, m2.chunk_size, 32, m2.head_dim,
                        m2.d_state, ITERS_SSD, library=True))
    ssd_case(dev, 4, 8, m2.chunk_size, 16, m2.head_dim, 64, 1, library=False)
    ssd_case(dev, 2, 3, 16, 5, 16, 8, 1, library=False)
    torch.cuda.empty_cache()

    for arch in MAIN_PATHS:
        smoke_reference(dev, arch)
    by_path, hists = {}, {}
    for arch in MAIN_PATHS:
        by_path[arch], hists[arch] = main_path(dev, arch)
    torch.cuda.empty_cache()
    by_path[f"{INT8_ARCH}:int8"] = int8_main_path(dev, hists[INT8_ARCH])
    torch.cuda.empty_cache()
    by_path["experiment"], card_hist = experiment(dev)
    torch.cuda.empty_cache()
    by_path["host_streaming"] = host_streaming(dev, card_hist)
    torch.cuda.empty_cache()
    for arch in VISION_ARCHS:
        by_path[f"vision:{arch}"] = vision_path(dev, arch)
    by_path["vision_experiment"] = vision_experiment(dev)
    torch.cuda.empty_cache()
    by_path.update(baselines(dev))
    for arch in MAIN_PATHS:
        profile_step(dev, arch)
        torch.cuda.empty_cache()
    by_path["split_backward"] = split_backward(dev)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = res[name]
        bms, by = r.pop("bound")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": sum(n[name] for n in by_path.values()),
                     "launches_by_path": {p: n[name]
                                          for p, n in by_path.items()},
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r.get("library_ms"),
                     **{k: r[k] for k in ("ms_range", "library_ms_range",
                                          "bound_passes", "bound_fp32_fma_ms",
                                          "replaced_ms", "at_mamba2_shape")
                        if k in r}})
    log("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
