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
12. Fleet: (a) the port's ``FleetScheduler`` simulates a synchronous
   trace over ``FLEET`` (4 devices of three classes, one a client,
   dropout hazard 0.3, straggler deadline, cohort 2), priced with
   Ampere's per-round latency at full width, and ``AmpereSystem.run``
   trains full-width, full-depth qwen3-1.7b on it (phase 5's corpus, seq
   512, lr 0.02, ``FLEET_ROUNDS`` rounds through
   ``run_fleet_device_phase``, the parallel upload on each profile's
   link, one server epoch): the bf16 attention and xent kernels launch,
   every loss is finite, the merged val loss ends below ln V, and
   ``comm_bytes`` = the plans' 2 x survivors x (s_d + s_aux) +
   ``bytes_received``, ``sim_time`` = the plans' round times + the
   slowest (shard bytes / own link) + the server epoch, in the Runner's
   order.  (b) FedBuff on the same model, corpus and population, its
   async schedule from ``fedbuff_schedule`` (``FLEET_ASYNC``: buffer 2,
   3 in flight, staleness at most 2), ``FLEET_ROUNDS`` aggregations: a
   stale snapshot is trained from, the version ring never holds more
   than s_max + 1 states, the kernels launch, the accounting holds
   (the context holds the population's sync trace, as every fleet run's
   does, so the upload is priced in parallel on each profile's link).  Each logs its rounds' (aggregations') wall seconds,
   its wall time and peak memory beside the card's name and power
   limit.  (c) ``examples/specs/compare_smoke.json``'s seven systems from
   a temporary copy of its trace, at ``COMPARE_ROUNDS`` rounds and
   ``COMPARE_EPOCHS`` server epoch (the spec's 12 and 4 cut for time), on
   the card and on the CPU from the same CPU-seeded init: losses within
   1e-4 relative, accuracies within 1e-2, ``comm_bytes`` and
   ``sim_time`` equal; then FedBuff on the qwen3-1.7b smoke spec with the
   phase's fleet, checkpointed after every aggregation: a card run killed
   after aggregation 1 and rerun from its workdir equals the
   uninterrupted card run bit for bit (history and merged parameters),
   and the rerun itself trains only the aggregations after the
   checkpoint.
13. Cuts: (a) ``CUT_POLICY`` (per profile: the cost model's pick, then
   jetson-slow pinned to cut 2 and phone-3g to 4) over phase 12's
   population gives depths 1, 2 and 4; the sync trace priced per class at
   its cut drives ``AmpereTrainer(cuts=...).run_fleet`` on full-width,
   full-depth qwen3-1.7b (phase 12's corpus and federation,
   ``FLEET_ROUNDS`` rounds, one server epoch): each round's survivors
   train in one bucket per depth on their prefix of the device stack,
   ``prefix_fedavg`` folds them back, the store's shards carry their cut,
   and the server epoch runs one pass per depth entering the server block
   there.  At least two depths in the assignment and the store, a round
   that trains two buckets, the bf16 attention and xent kernels launched,
   every loss finite, the merged val loss below ln V, and ``comm_bytes``
   and ``sim_time`` ``==`` the comm model's with each client priced at
   its own depth (the upload in parallel on each profile's link, the
   server epoch the sum of each depth's); each bucket's wall seconds,
   the round times and the peak memory beside the card's name and power
   limit.  (b) ``examples/specs/cut_smoke.json`` without its
   observability section (14(d) runs it whole), at its 2 rounds and 2
   server epochs, on the card and on the CPU from the same CPU-seeded
   init: the same cut summary, losses within 1e-4 relative, accuracies
   within 1e-2, ``comm_bytes`` and ``sim_time`` equal.
14. Chaos: (a) phase 12's qwen3-1.7b federation and corpus at the main
   path's static cut through ``AmpereSystem.run`` (``CHAOS_ROUNDS``
   rounds, the upload, one server epoch), twice from the same init: under
   an ``InProcessTransport`` with every fault kind of ``CHAOS_FAULTS``
   (drops, corruptions through the frame CRC, duplicates, latency
   spikes, resets; ``CHAOS_RETRY``'s six attempts), ``quorum_frac``
   ``CHAOS_QUORUM`` and observability on, and with neither.  No client is
   excluded; the faulted history less ``comm_bytes`` and ``sim_time``
   equals the clean one bit for bit, and those two are larger; the wire
   total is ``comm_bytes``; retries plus duplicates are above 0; the
   tracer closed every span, dropped nothing and has spans on the
   device, transfer, server and eval tracks; its exported ``trace.json``
   validates and its span log reads back strictly.  Both runs' round
   times, the wire statistics and the peaks beside the card's name and
   power limit.  (b) One device round, the upload and one server epoch of
   (a)'s faulted setup with a ``profile=True`` tracer inside
   ``profile_run`` (``torch.profiler``, CPU and CUDA, NVTX ranges): from
   the profiler's Chrome trace (each kernel tied to its launch by its
   correlation id) every ``fa_fwd_tc_kernel`` launches inside a
   ``flash_fwd`` range, every ``fa_bwd_tc_kernel`` inside
   ``flash_bwd_fused`` and every xent kernel inside ``fused_xent_pallas``,
   on the launching thread, one range per wrapper launch (the forward's
   ranges hold its combine kernel, the backward's its GEMMs); every
   kernel of the round lies inside a tracer span; and per span its
   device time, idle share and top ten device operations (the call-site
   table).  (c) ``examples/specs/chaos_smoke.json`` (faults with torn
   checkpoint and journal writes; vit-s, no hand-written kernel) on the
   card and on the CPU: wire statistics, the tracer's digest and the
   metrics' counters (exclusions included) ``==``, histories within
   phase 12(c)'s gate.  (d) ``examples/specs/cut_smoke.json`` whole, its
   observability section included, on the card: the history ``==``
   13(b)'s card run without it.  Drive it alone with
   ``chip_smoke.chaos_phase(dev, chip_smoke.cuts_experiment(dev)[1])``
   after ``build.build()`` and a CUDA context (~80 s).
15. Streaming: (a) 14(a)'s clean setup (``CHAOS_ROUNDS`` rounds, the
   upload, one server epoch) through ``AmpereSystem.run`` with
   observability on, twice from one init: with the serialized store and
   with a memmap ``StreamingActivationStore`` in a temp dir
   (``STREAM_CAPACITY`` segments, reopening at ``STREAM_LOW_WATERMARK``):
   the 64-sample upload (~268.6 MB fp32) is 4 client segments of 50-80
   MB, so the third put stalls.  The ring's history equals the serialized
   one less ``sim_time``, which is no larger; stalls and the phase
   table's ``overlap_s`` are above 0; the ``consolidate`` span's wall
   seconds of both, each segment's write + fsync and CRC re-verify
   seconds, the ring's stats and both peaks are printed.  (b)
   ``examples/specs/streaming_smoke.json`` (vit-s; memmap ring under
   faults with torn writes) on the card and on the CPU: ring stats, wire
   statistics and counters ``==``; every record within phase 12(c)'s gate
   but the last server epoch's, which diverges in every package and is
   held at ``STREAM_DIVERGED_RTOL``.  (c) ``transport.roles``'
   ``run_server_role`` and ``run_device_role`` in two threads over
   loopback (a port bound from 0), handed (a)'s setup (``setup=``;
   ``SOCKET_TRANSPORT``): the server's history ``==`` (a)'s serialized
   one, ``analytic_transfer_bytes`` its upload bytes, and the measured
   wire bytes exactly the frames': the analytic bytes, the state frame
   (more than the 1,244,659,712-byte fp32 embedding) and the framing;
   the frame counts, the card's peak and the host's ``ru_maxrss``
   printed.  (d) ``python -m repro_torch.launch.run_experiment SPEC
   --role server`` and ``--role device`` as two processes on the card
   (the kernels already built), the qwen3 smoke spec with a socket
   transport: both exit 0 and the server's ``summary.json`` is the two
   roles' CPU run's within phase 12(c)'s gate, every frame before the
   ``done`` frame the same bytes (the ``done`` frame carries the device
   history's floats as JSON, each run's own digits).  Drive it alone with
   ``chip_smoke.streaming_phase(torch.device("cuda", 0))`` after
   ``build.build()`` and a CUDA context.
16. MoE and the hybrid stack.  (a) granite-moe-3b-a800m joins the main
   paths (phases 4, 5 and the profiled step): published widths (d 1536,
   24 / 8 heads of 64, 40 experts top-8 of d 512, capacity factor 1.25,
   V 49155, tied) with 16 of its 32 layers (``MAIN_PATHS``'s ``layers``:
   the full-depth server epoch would not fit the card), seq 512, lr
   ``MAIN_PATHS``'s; its ``comm_bytes`` must be ``MAIN_PATHS``'s
   ``comm_bytes`` (2 rounds x 2K(s_d + s_aux) + the upload, analytic);
   the attention and xent kernels at its shapes (G 3, hd 64; T 8 x 511,
   D 1536, V 49155, tied) in phase 3.  (b) One MoE layer of granite and
   one of qwen2-moe-a2.7b (60 experts top-4 of d 1408, 4 shared of
   1408) at published widths in fp32, params from a seeded generator and
   x (4, 512, D) from numpy, forward and backward of sum(y r) + aux on
   the card and on the CPU: a token whose k-th and (k+1)-th gates lie
   within 1e-6 is a near tie, printed, and its sequence left out; every
   other token must pick the same experts and keep the same choices, and
   y, aux and the grads of x and of every param (run again on the
   sequences without a near tie, at least half of them) agree within
   1e-4 of each leaf's scale.  Then the layer twice on the card in the
   published bf16: y and every grad bit for bit (no slot of the
   dispatch buffer takes more than one non-zero row).  (c) The
   qwen2-moe and jamba-1.5-large-398b smoke configs through phase 4's
   gate, card against CPU, each launching its kernels (jamba: the SSD
   pair at chunk 16 and the attention pair).  (d) One granite MoE layer
   forward and checkpointed backward at the server step's shape (8 x
   512, bf16), timed and profiled: its time beside the step's, split
   into the dispatch's index ops, its GEMMs, top-k and the rest.  Drive
   (b)-(d) alone with ``chip_smoke.moe_phase(torch.device("cuda", 0))``
   after ``build.build()`` and a CUDA context.
17. Serving.  (a) Right after each main path of phase 5, its merged
   params through ``repro_torch.launch.serve.LMServer`` (fp32 KV and
   Mamba caches): ``SERVE_BATCH`` prompts of the path's seq from the
   corpus (seed 2), ``SERVE_NEW`` greedy tokens, three times (untimed;
   timed by the host clock: ``tokens_per_s`` as the reference's CLI
   counts it; each prefill and decode call timed by CUDA events), the
   three ``==``, the logits finite; then ``SERVE_PROFILE_NEW`` tokens
   timed and again under ``torch.profiler`` (kernels, device time by
   kernel category, the busy share over the unprofiled wall time); the prefill launches ``flash_fwd``
   (qwen3-1.7b, granite) or ``ssd_intra`` (mamba2-370m); prefill ms,
   decode ms a token, tokens/s and the peak beside the card's name and
   power limit.  (b) The share of the greedy tokens among the corpus's
   257 mapped ids: above ``SERVE_GATE`` for the trained model, below it
   for a fresh init of the same config (seeded on the card).  (c)
   qwen3-1.7b and mamba2-370m at dtype float32: the logits of the 32
   tokens (the prefill's and each decode step's) equal one forward
   without a cache over prompt + generated tokens within 1e-4 of their
   scale (not granite: MoE capacity is per call).  (d) The qwen3, gemma2,
   mamba2, jamba and qwen2-moe smoke configs' prefill and teacher-forced
   decode logits, card vs CPU from one CPU-seeded init, within 1e-4, each
   launching its fp32 attention or SSD kernel.  Drive it alone with
   ``main_path`` then ``serve_path(dev, arch, merged)`` per arch and
   ``serve_smoke(dev)`` after ``build.build()`` and a CUDA context.
18. Dry-run (``repro_torch.launch.dryrun``, which runs a step on meta
   tensors and counts each rank's FLOPs, bytes, collectives and live
   bytes at dispatch).  (a) The ``--mesh debug`` row (one rank, the plain
   step) of qwen3-1.7b's server step at the main path's shape (8 x 512):
   the same step (``impl="xla"``, ``xent_impl="sharded"``, the dry-run's
   run config: adamw, fp32 moments, block remat) then runs once on the
   card from seeded params, each leaf on a storage of its own, under
   ``FlopCounterMode``: its FLOPs must equal the row's, its
   ``max_memory_allocated`` over what was allocated before its inputs
   must fall within ``DRYRUN_MEM_TOL`` of the row's per-device peak, its
   loss be finite and no hand-written kernel launch; a second step is
   timed (CUDA events) beside the row's ``roofline_seconds``.  (b)
   ``run_cell`` of qwen3-1.7b x decode_32k on the 512-rank multi-pod mesh
   in a subprocess (its fake process group stays there): ``"ok"``, 512
   chips, a per-device peak under 80 GiB.  Drive it alone with
   ``chip_smoke.dryrun_phase(torch.device("cuda", 0))`` after a CUDA
   context (it needs no kernel build).
19. Staticcheck (``repro_torch.staticcheck``).  The CUDA sources built for
   the host with g++ (``staticcheck.host_build``, started beside the nvcc
   build) run the kernel analyzer's record-only tier: every shape the port
   launches (``staticcheck.kernel_configs``), each launch's kernel,
   threads, dynamic shared memory and attribute recorded, no finding
   allowed.  For each recorded (kernel, threads, smem) the card's own view
   through the sources' kernel tables (``build.kernel_attrs``:
   ``cudaFuncGetAttributes`` and the occupancy calculator, after the
   launch site's ``cudaFuncSetAttribute``): at least one block an SM,
   static plus dynamic shared memory within
   ``cudaDevAttrMaxSharedMemoryPerBlockOptin``, and the analyzer's budget
   verdict equal to the card's.  One ``staticcheck_kernel`` line each:
   registers, spill bytes (reported, not asserted), static and dynamic
   shared memory, blocks an SM.  Drive it alone with
   ``chip_smoke.staticcheck_phase(host_build.build_library())`` after
   ``build.build()`` and a CUDA context.

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
runs too), 9, 10, 11, 12, 13, 14, 15 (its (d) launches in processes
of its own, uncounted), 16(a) and (c), 17 (``serve:<arch>``,
``serve_init:<arch>``, ``serve_fp32:<arch>``, ``serve_smoke:<arch>``)
and 18(a) (``dryrun``: none, the xla route),
``launches_by_path`` each run's count; the attention rows are the bf16 tensor-core kernels,
``*_fp32`` the fp32 instantiations behind the same wrappers, counted by
dtype (every one on the tensor cores over bf16 planes, with its bf16
pass count and fp32-FMA bound); the xent rows are a bf16 h, ``*_fp32`` an fp32 h, both on the
tensor cores, counted by h's dtype; the xent rows add their bf16 pass
count, the fp32-FMA bound for comparison and their times at the mamba2
shape; the attention and xent rows their times at granite's shape), the
card line and,
last, ``{"ok": true, "device": {...}}``.
Exits non-zero, printing no result, without a CUDA device or when any
phase fails.
"""

from __future__ import annotations

import bisect
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import resource
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
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
                                     TransportSpec, resolve_setup,
                                     resolve_trace, run_experiment)
from repro_torch.experiments.systems import (FedBuffSystem,  # noqa: E402
                                             fedbuff_schedule)
from repro_torch.fleet import (CutPolicy, FleetConfig,  # noqa: E402
                               FleetEngine, FleetScheduler, make_latency_fn,
                               resolve_cuts, sample_population)
from repro_torch.interop import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as SR  # noqa: E402
from repro_torch.kernels.xent import kernel as XK  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.serve import LMServer  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as TR  # noqa: E402
from repro_torch.observability import Observability  # noqa: E402
from repro_torch.observability.export import (  # noqa: E402
    export_artifacts, read_span_log, validate_chrome_trace)
from repro_torch.observability.profiling import profile_run  # noqa: E402
from repro_torch.staticcheck import host_build  # noqa: E402
from repro_torch.staticcheck import kernel_configs  # noqa: E402
from repro_torch.staticcheck.kernel_analyzer import (  # noqa: E402
    AnalyzerSettings, analyze_config)
from repro_torch.streaming import (StreamingActivationStore,  # noqa: E402
                                   VersionRing)
from repro_torch.transport import (FaultPlan, FaultSpec,  # noqa: E402
                                   FrameReceiver, InProcessTransport,
                                   RetryPolicy, encode_frame, roles)

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
# granite-moe's rate comes from ``scripts/torch_lr_probe.py --arch
# granite-moe-3b-a800m`` (PERF.md, Findings); its depth is cut to 16 of 32
# layers (the full-depth server block is 12.8 GB fp32, and its epoch would
# need about 80 GiB), and ``comm_bytes`` is its analytic count at that depth
GRANITE_LR = 0.05
MAIN_PATHS = {
    "qwen3-1.7b": dict(seq=512, lr=0.02, kernels=(
        "flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd")),
    "mamba2-370m": dict(seq=2048, lr=MAMBA_LR, kernels=(
        "ssd_intra", "ssd_intra_bwd", "xent_fwd", "xent_bwd")),
    "granite-moe-3b-a800m": dict(seq=512, lr=GRANITE_LR, layers=16,
                                 comm_bytes=6_697_582_592, kernels=(
        "flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd")),
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
# phase 12: the fleet.  Four devices of three classes, one a client,
# dropping out mid-round (hazard 0.3) and straggling (deadline 2 x the
# median), cohort 2; the async schedule buffers 2 updates with 3 devices
# in flight and staleness at most 2.  At full width seed 3 gives drops in
# rounds 1 and 2 and stale updates in aggregations 1 and 2.
FLEET_ARCH = "qwen3-1.7b"
FLEET_KERNELS = ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd")
FLEET_ROUNDS = 3
FLEET = dict(n_devices=4, seed=3, p_online0=1.0,
             class_mix=(("jetson-fast", 0.34), ("jetson-slow", 0.33),
                        ("phone-3g", 0.33)),
             mean_session_rounds=50.0, mean_off_rounds=1.0,
             dropout_hazard=0.3, deadline_factor=2.0, min_cohort=1,
             max_cohort=2, init_cohort=2, heartbeat_loss_prob=0.0)
FLEET_ASYNC = dict(async_buffer_size=2, max_staleness=2, max_concurrent=3)
COMPARE_SPEC = ("examples/specs/compare_smoke.json",
                "examples/specs/fleet_trace_smoke.jsonl")
COMPARE_ROUNDS, COMPARE_EPOCHS = 2, 1
# phase 13: heterogeneous cuts over phase 12's population (jetson-fast x
# 2, phone-3g, jetson-slow): the cost model picks cut 1 for every class,
# and the overrides pin jetson-slow to 2 and phone-3g to 4, so the depths
# are 1, 2 and 4; at full width the trace's round 0 trains depths 1 and 2
CUT_POLICY = CutPolicy(mode="per_profile",
                       overrides=(("jetson-slow", 2), ("phone-3g", 4)))
CUT_SPEC = "examples/specs/cut_smoke.json"
# phase 14: chaos.  (a) phase 12's federation at the main path's static
# cut under every fault kind at the reference chaos test's rates; six
# attempts absorb them all (seed 7 excludes no client: every fault
# decision is a pure function of the seed and the message keys, which do
# not depend on the model's width, so a CPU run of the same federation
# tells); (b) its profiled call sites; (c) chaos_smoke.json card vs CPU;
# (d) cut_smoke.json with its observability section
CHAOS_ROUNDS = 3
CHAOS_FAULTS = FaultSpec(seed=7, drop_prob=0.15, corrupt_prob=0.15,
                         duplicate_prob=0.1, latency_spike_prob=0.1,
                         reset_prob=0.05)
CHAOS_RETRY = RetryPolicy(max_attempts=6, base_backoff_s=0.01,
                          max_backoff_s=0.1, attempt_timeout_s=0.2)
CHAOS_QUORUM = 0.5
CHAOS_SPEC = "examples/specs/chaos_smoke.json"
# 14(b): each kernel entry point's profiler range and the kernel families
# launched inside it (the xent range holds the forward, whose combine
# kernel only it launches, and the backward, whose dH / dW GEMM only it
# launches); CHAOS_WINDOW brackets the profiled device round
CALL_SITES = {
    "flash_fwd": ("flash_fwd", ("fa_fwd_tc_kernel",)),
    "flash_bwd_fused": ("flash_bwd_fused", ("fa_bwd_tc_kernel",)),
    "xent": ("fused_xent_pallas", ("xent_split_kernel",
                                   "xent_split_h_kernel",
                                   "xent_tc_logits_kernel",
                                   "xent_combine_kernel",
                                   "xent_tc_gemm_kernel")),
}
CHAOS_WINDOW = "chip_smoke.device_round"
# phase 15: streaming.  (a) phase 14(a)'s clean run with the serialized
# store and with a memmap ring of STREAM_CAPACITY segments that reopens at
# STREAM_LOW_WATERMARK: 64 samples in 4 client shards of ~67 MB, so the
# third put stalls; (b) streaming_smoke.json card vs CPU, whose server
# phase diverges in every package (merged val loss ~4.5 after epoch 0, ~25
# after epoch 1): its last epoch is held at STREAM_DIVERGED_RTOL, the rest
# at phase 12(c)'s gate; (c) the two socket roles in two threads at full
# width; (d) the two roles as two processes of the command line on the
# qwen3 smoke spec.  The full-width state frame (the fp32 embedding alone
# is 1,244,659,712 bytes) needs more than the spec's default one-second
# attempt deadline
STREAM_CAPACITY = 2
STREAM_LOW_WATERMARK = 0
STREAM_SPEC = "examples/specs/streaming_smoke.json"
STREAM_DIVERGED_RTOL = 1e-3
SOCKET_TRANSPORT = TransportSpec(kind="socket", attempt_timeout_s=300.0)
# a float's shortest repr differs by a few characters between two runs
# whose values differ in the last bits (17 significant digits at most)
DONE_FRAME_SLACK = 8
ROLE_JOIN_S = 900.0
# phase 16: MoE.  (b) one full-width MoE layer of each arch, card vs CPU
# in fp32 on x of MOE_X, a near tie a k-th and (k+1)-th gate within
# MOE_TIE, the rest within MOE_TOL of each leaf's scale; (c) the smoke
# configs card vs CPU and the kernel rows each must launch (fp32 configs:
# the *_fp32 rows)
MOE_LAYER_ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b")
MOE_X = (4, 512)
MOE_TIE = 1e-6
MOE_TOL = 1e-4
_FA_XENT_FP32 = ("flash_fwd_fp32", "flash_bwd_fused_fp32", "xent_fwd_fp32",
                 "xent_bwd_fp32")
MOE_SMOKE = {"qwen2-moe-a2.7b": _FA_XENT_FP32,
             "jamba-1.5-large-398b": _FA_XENT_FP32 + ("ssd_intra",
                                                      "ssd_intra_bwd")}
# phase 17: serving.  (a) each main path's merged model right after the
# path, through ``launch.serve.LMServer``: SERVE_BATCH prompts of the
# path's seq from the corpus (seed 2), SERVE_NEW greedy tokens, the
# kernels each prefill must launch; (b) the share of the greedy tokens
# among the corpus's 257 mapped ids, above SERVE_GATE for the trained
# model and below it for a fresh init of the same config; (c) SERVE_FP32
# at dtype float32: every generated token's logits equal a no-cache
# forward over prompt + tokens within SERVE_TOL of their scale (not
# granite: MoE capacity is per call, so a decoded token is routed against
# one token's capacity and a forward against S tokens'); (d) SERVE_SMOKE's
# prefill and teacher-forced decode logits (SERVE_SMOKE_SHAPE: batch,
# prompt, last position), card vs CPU within SERVE_TOL.  The gate sits
# between the shares measured on the card (PERF.md, PR 32 run 1): trained
# 1.0 (qwen3, granite) and 0.5 (mamba2), fresh init 0.0-0.0078; 0.25
# leaves 0.25 below the lowest trained and 0.24 above the highest init
SERVE_BATCH, SERVE_NEW = 4, 32
SERVE_PROFILE_NEW = 4
SERVE_KERNELS = {"qwen3-1.7b": ("flash_fwd",), "mamba2-370m": ("ssd_intra",),
                 "granite-moe-3b-a800m": ("flash_fwd",)}
SERVE_GATE = 0.25
SERVE_FP32 = ("qwen3-1.7b", "mamba2-370m")
SERVE_TOL = 1e-4
SERVE_SMOKE = ("qwen3-1.7b", "gemma2-2b", "mamba2-370m",
               "jamba-1.5-large-398b", "qwen2-moe-a2.7b")
SERVE_SMOKE_SHAPE = (2, 12, 20)
# phase 18: the dry-run.  (a) the measured step's peak against the --mesh
# debug row's, relative; (b) the production cell, in a subprocess of at
# most DRYRUN_CELL_S seconds
DRYRUN_ARCH = "qwen3-1.7b"
DRYRUN_MEM_TOL = 0.10
DRYRUN_CELL = ("decode_32k", "multi_pod", "decode_step")
DRYRUN_CELL_S = 300
# phase 19: the budget rules of the analyzer the card can confirm, and the
# most seconds the host build may take past the nvcc build
BUDGET_RULES = ("smem-over-budget", "smem-attribute-missing", "block-shape",
                "grid-too-large")
HOST_BUILD_S = 600
ROOT = os.path.dirname(os.path.abspath(__file__))
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


def corpus_ids(vocab) -> np.ndarray:
    """The fixed injection of the corpus's 257 ids into [0, vocab)."""
    return np.random.default_rng(1234).choice(vocab, size=257, replace=False)


def full_corpus(n, seq, vocab, seed):
    """The unchanged bigram generator at vocab 257 (samples drawn from
    ``seed``), its ids mapped into [0, vocab) by ``corpus_ids``."""
    small = make_lm_dataset(n, seq_len=seq, vocab=257, seed=seed)
    inj = corpus_ids(vocab)
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


def main_config(arch):
    """A main path's config: the published one, its depth cut to
    ``MAIN_PATHS[arch]["layers"]`` where the entry has one."""
    cfg = registry.get_config(arch)
    layers = MAIN_PATHS[arch].get("layers")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def main_path(dev, arch, quantize=False):
    """One main path through the launcher; with ``quantize`` the store
    keeps and ships int8 activations (one fp32 scale a row).  Returns the
    launches, the history and the merged params."""
    spec = MAIN_PATHS[arch]
    seq, lr = spec["seq"], spec["lr"]
    cfg = main_config(arch)
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
    if "comm_bytes" in spec and hist["comm_bytes"] != spec["comm_bytes"]:
        raise AssertionError(f"{arch}: comm_bytes {hist['comm_bytes']} != "
                             f"{spec['comm_bytes']}")
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
    return launches, hist, out["merged_params"]


def int8_main_path(dev, fp32_hist):
    """The int8 main path against the fp32 one from the same init: the
    upload shrinks to int8 payloads, and ``comm_bytes`` and ``sim_time``
    fall by exactly that upload's bytes and their time on the link."""
    launches, hist, _ = main_path(dev, INT8_ARCH, quantize=True)
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


# ---------------------------------------------------------------------------
# Phase 12: the fleet
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def timed_calls(owner, name, dev, out: list):
    """Appends the wall seconds of every call of ``owner.name`` to ``out``
    (the card synchronized around each call) while the block runs."""
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize(dev)
        out.append(time.perf_counter() - t)
        return result

    setattr(owner, name, wrapper)
    try:
        yield out
    finally:
        setattr(owner, name, fn)


def fleet_setup():
    """Phase 5's qwen3-1.7b federation and corpus, its model and the
    fleet's device population (one device a client)."""
    arch = FLEET_ARCH
    seq, lr = MAIN_PATHS[arch]["seq"], MAIN_PATHS[arch]["lr"]
    cfg = registry.get_config(arch)
    largs = launch_train.make_parser().parse_args(
        ["--arch", arch, "--clients", "4", "--cohort", "2", "--local-steps",
         "2", "--batch-size", "4", "--server-batch", "8", "--seq-len",
         str(seq), "--lr", str(lr), "--seed", "0"])
    run_cfg = launch_train.build_run_cfg(largs)
    model = build_model(cfg)
    clients = federate(full_corpus(TRAIN_SAMPLES, seq, cfg.vocab_size, 0),
                       run_cfg.fed.num_clients, run_cfg.fed.dirichlet_alpha,
                       seed=run_cfg.seed)
    evald = full_corpus(EVAL_SAMPLES, seq, cfg.vocab_size, 1)
    return cfg, run_cfg, model, clients, evald, sample_population(
        FleetConfig(**FLEET))


def fleet_accounting(name, model, run_cfg, seq, hist, store, plans,
                     clients, bandwidth):
    """A fleet path's bytes and clock, recomputed (analytic: no device
    number): ``comm_bytes`` = the sum over the plans of 2 x survivors x
    (s_d + s_aux) + ``bytes_received``; ``sim_time`` = the plans' round
    times, then the upload (``bandwidth`` a map: each device's shard over
    its own link, the slowest; ``None``: all bytes through the testbed
    link), then the server epochs, summed in the Runner's order."""
    sizes = comm_model.split_sizes(model, run_cfg.split, seq_len=seq)
    nbytes = store.bytes_received
    want_comm = sum(2 * len(p.clients) * (sizes.device + sizes.aux)
                    for p in plans) + nbytes
    want_time = 0.0
    for p in plans:
        want_time += p.round_time
    if bandwidth is None:
        upload_s = nbytes / comm_model.BANDWIDTH_BPS
    else:
        per_sample = nbytes / store.num_samples()
        upload_s = max(len(c.dataset) * per_sample / bandwidth[c.client_id]
                       for c in clients)
    want_time += upload_s
    epoch_s = comm_model.ampere_server_epoch_time(
        model, run_cfg.split, comm_model.TimeModel(),
        n_samples=store.num_samples(), seq_len=seq, sizes=sizes)
    for _ in range(SERVER_EPOCHS):
        want_time += epoch_s
    per = seq * model.cfg.d_model * 4 + seq * 4
    got = (nbytes, hist["comm_bytes"], hist["sim_time"])
    want = (TRAIN_SAMPLES * per, want_comm, want_time)
    log("fleet_accounting", path=name, bytes_received=nbytes,
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        rounds_s=sum(p.round_time for p in plans), upload_s=upload_s,
        server_epoch_s=epoch_s, ok=got == want)
    if got != want:
        raise AssertionError(f"fleet {name} accounting: (bytes_received, "
                             f"comm_bytes, sim_time) {got} != {want}")


def _check_fleet_path(name, cfg, hist, launches, rounds):
    losses = [r[k] for ph in ("device", "server") for r in hist[ph]
              for k in ("loss", "val_loss")]
    if len(hist["device"]) != rounds or \
            len(hist["server"]) != SERVER_EPOCHS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"fleet {name}: history not finite/complete: "
                             f"{hist}")
    if not hist["server"][-1]["val_loss"] < math.log(cfg.vocab_size):
        raise AssertionError(f"fleet {name}: merged model did not train "
                             f"below ln V: {hist}")
    for kernel in FLEET_KERNELS:
        if launches[kernel] <= 0:
            raise AssertionError(f"fleet {name} never launched {kernel}")


def fleet_ampere(dev):
    """12(a): a sync trace from the port's scheduler drives Ampere at full
    width through ``AmpereSystem.run``: ``run_fleet_device_phase``, the
    parallel upload on each profile's link, one server epoch."""
    cfg, run_cfg, model, clients, evald, pop = fleet_setup()
    seq = MAIN_PATHS[FLEET_ARCH]["seq"]
    lat = make_latency_fn(model, run_cfg, algo="ampere", seq_len=seq)
    trace = FleetScheduler(pop, lat, FleetConfig(**FLEET)).simulate(
        FLEET_ROUNDS)
    ctx = SystemContext(model=model, run_cfg=run_cfg, clients=clients,
                        eval_data=evald, trace=trace, population=pop,
                        max_rounds=FLEET_ROUNDS,
                        max_server_epochs=SERVER_EPOCHS, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    round_s = []
    t = time.perf_counter()
    with timed_calls(FleetEngine, "run_round", dev, round_s):
        out = AmpereSystem().run(ctx)
    seconds = time.perf_counter() - t
    launches = read_launches()
    hist = out["history"]
    log("fleet_ampere", arch=cfg.name, seq=seq, seconds=seconds,
        round_s=round_s,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        profiles=[(p.cls, p.bandwidth_bps) for p in pop],
        plans=[(p.clients, p.dropped, p.cohort_size, p.round_time)
               for p in trace.rounds],
        device=hist["device"], server=hist["server"], launches=launches,
        card=card_line())
    fleet_accounting("ampere", model, run_cfg, seq, hist, out["store"],
                     trace.rounds[:FLEET_ROUNDS], clients,
                     {p.device_id: p.bandwidth_bps for p in pop})
    del out
    _check_fleet_path("ampere", cfg, hist, launches, FLEET_ROUNDS)
    if not any(p.dropped for p in trace.rounds):
        raise AssertionError("fleet ampere: the trace dropped no device")
    return launches


def fleet_fedbuff(dev):
    """12(b): FedBuff at full width on the async schedule derived from the
    same population: a stale snapshot is trained from, and the version
    ring never holds more than s_max + 1 states.  The context holds the
    population's sync trace, as ``resolve_trace`` gives it to every fleet
    run, so the upload is priced in parallel on each profile's link."""
    cfg, run_cfg, model, clients, evald, pop = fleet_setup()
    seq = MAIN_PATHS[FLEET_ARCH]["seq"]
    fcfg = FleetConfig(**FLEET, **FLEET_ASYNC)
    lat = make_latency_fn(model, run_cfg, algo="ampere", seq_len=seq)
    sync = FleetScheduler(pop, lat, dataclasses.replace(
        fcfg, async_buffer_size=0)).simulate(FLEET_ROUNDS)
    ctx = SystemContext(model=model, run_cfg=run_cfg, clients=clients,
                        eval_data=evald, trace=sync, population=pop,
                        fleet_cfg=fcfg, max_rounds=FLEET_ROUNDS,
                        max_server_epochs=SERVER_EPOCHS, device=dev)
    schedule = fedbuff_schedule(ctx, FLEET_ROUNDS)
    s_max = max(max(p.staleness) for p in schedule.rounds)
    ring_sizes, agg_s = [], []
    append = VersionRing.append

    def counted_append(ring, version, state):
        append(ring, version, state)
        ring_sizes.append(len(ring))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    VersionRing.append = counted_append
    t = time.perf_counter()
    try:
        with timed_calls(FleetEngine, "run_buffered_round", dev, agg_s):
            out = FedBuffSystem().run(ctx)
    finally:
        VersionRing.append = append
    seconds = time.perf_counter() - t
    launches = read_launches()
    hist = out["history"]
    log("fleet_fedbuff", arch=cfg.name, seq=seq, seconds=seconds,
        aggregation_s=agg_s,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        s_max=s_max, ring_sizes=ring_sizes,
        plans=[(p.clients, p.staleness, p.dropped, p.round_time)
               for p in schedule.rounds],
        device=hist["device"], server=hist["server"], launches=launches,
        card=card_line())
    fleet_accounting("fedbuff", model, run_cfg, seq, hist, out["store"],
                     schedule.rounds, clients,
                     {p.device_id: p.bandwidth_bps for p in pop})
    del out
    _check_fleet_path("fedbuff", cfg, hist, launches, FLEET_ROUNDS)
    if not s_max > 0:
        raise AssertionError(f"fleet fedbuff: no stale update in "
                             f"{schedule.rounds}")
    if len(ring_sizes) != FLEET_ROUNDS or max(ring_sizes) > s_max + 1:
        raise AssertionError(f"fleet fedbuff: ring sizes {ring_sizes}, "
                             f"s_max {s_max}")
    return launches


def fleet_compare(dev):
    """12(c): ``examples/specs/compare_smoke.json``'s seven systems from a
    temporary copy of its trace, ``COMPARE_ROUNDS`` rounds and
    ``COMPARE_EPOCHS`` server epochs (the spec's 12 and 4 cut for time),
    on the card and on the CPU from the same CPU-seeded init."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.jsonl")
        shutil.copy(os.path.join(ROOT, COMPARE_SPEC[1]), trace)
        spec = dataclasses.replace(
            ExperimentSpec.load(os.path.join(ROOT, COMPARE_SPEC[0])),
            trace_path=trace, max_rounds=COMPARE_ROUNDS,
            max_server_epochs=COMPARE_EPOCHS,
            results_dir=os.path.join(tmp, "results"))
        reset_launches()
        t = time.perf_counter()
        card = run_experiment(spec, device=dev, write_results=False)
        seconds = time.perf_counter() - t
        launches = read_launches()
        cpu = run_experiment(spec, device="cpu", write_results=False)
    card_vs_cpu("fleet_compare", spec.systems, card, cpu)
    log("fleet_compare", seconds_card=seconds, launches=launches,
        card=card_line())
    return launches


def card_vs_cpu(phase_name, systems, card, cpu):
    """Two ``run_experiment`` outputs of one spec, card and CPU: each
    system's losses within 1e-4 relative, accuracies within 1e-2,
    ``comm_bytes`` and ``sim_time`` equal."""
    for name in systems:
        h_card, h_cpu = (o["results"][name]["history"] for o in (card, cpu))
        log(phase_name, system=name, card=card["summary"][name],
            cpu=cpu["summary"][name], rel_tol=1e-4)
        for phase in ("device", "server", "rounds"):
            a, b = h_card.get(phase, []), h_cpu.get(phase, [])
            if len(a) != len(b):
                raise AssertionError(f"{name} {phase}: {a} vs {b}")
            for x, y in zip(a, b):
                for key in ("loss", "val_loss"):
                    if not abs(x[key] - y[key]) <= 1e-4 * abs(y[key]):
                        raise AssertionError(f"{name} {phase} {key}: {x} "
                                             f"vs {y}")
                if not abs(x["val_acc"] - y["val_acc"]) <= 1e-2:
                    raise AssertionError(f"{name} {phase} val_acc: {x} vs "
                                         f"{y}")
        for key in ("comm_bytes", "sim_time"):
            if h_card[key] != h_cpu[key]:
                raise AssertionError(f"{name} {key}: {h_card[key]} vs "
                                     f"{h_cpu[key]}")


def fleet_resume(dev):
    """12(c): FedBuff on the qwen3-1.7b smoke spec with the phase's fleet,
    checkpointed after every aggregation: a card run killed after
    aggregation 1 and rerun from its workdir equals the uninterrupted card
    run bit for bit, and the rerun trains only the aggregations after the
    checkpoint (a rerun from scratch would give the same history)."""
    with tempfile.TemporaryDirectory() as tmp:
        def spec(name):
            base = experiment_spec(os.path.join(tmp, name))
            return dataclasses.replace(
                base, systems=("fedbuff",), max_rounds=FLEET_ROUNDS,
                fleet=FleetConfig(**FLEET, **FLEET_ASYNC))

        reset_launches()
        full = run_experiment(spec("full"), device=dev)
        s, model, clients, evald = resolve_setup(spec("resumed"))
        trace, pop = resolve_trace(s, model, s.run, seq_len=s.data.seq_len)
        ctx = SystemContext(model=model, run_cfg=s.run, clients=clients,
                            eval_data=evald, trace=trace, population=pop,
                            fleet_cfg=s.fleet, patience=s.patience,
                            workdir=os.path.join(s.results_dir, "fedbuff"),
                            device=dev)
        dev_state, _ = FedBuffSystem().init_state(ctx)
        ctx.trainer.run_buffered_device_phase(
            dev_state, fedbuff_schedule(ctx, FLEET_ROUNDS), 2)  # killed
        ctx.trainer.runner.close()
        resumed_s = []
        with timed_calls(FleetEngine, "run_buffered_round", dev, resumed_s):
            resumed = run_experiment(s, device=dev)
        launches = read_launches()
    h_full, h_res = (o["results"]["fedbuff"]["history"]
                     for o in (full, resumed))
    # by path: a tree restored from a checkpoint comes back in sorted key
    # order
    p_full, p_res = (dict(_flat(o["results"]["fedbuff"]["merged_params"]))
                     for o in (full, resumed))
    differ = sorted(k for k in p_full.keys() | p_res.keys()
                    if k not in p_full or k not in p_res
                    or not torch.equal(p_full[k], p_res[k]))
    same_params = not differ
    log("fleet_resume", arch="qwen3-1.7b", full=h_full, resumed=h_res,
        resumed_aggregations=len(resumed_s), same_params=same_params,
        params=len(p_full), differ=differ[:8], launches=launches)
    if h_res != h_full or not same_params:
        raise AssertionError(f"fedbuff resumed vs uninterrupted: {h_res} vs "
                             f"{h_full}, same merged params {same_params}")
    if len(resumed_s) != len(h_full["device"]) - 2 or len(resumed_s) < 1:
        raise AssertionError(
            f"fedbuff resumed run trained {len(resumed_s)} aggregations, "
            f"not the {len(h_full['device']) - 2} after its checkpoint")
    if not any(r["staleness_max"] > 0 for r in h_full["device"]):
        raise AssertionError(f"fedbuff smoke: no stale update: {h_full}")
    for name in FLEET_KERNELS:
        if launches[f"{name}_fp32"] <= 0:
            raise AssertionError(f"fedbuff smoke never launched {name}")
    return launches


def fleet(dev) -> dict:
    """Phase 12: launches by path of (a), (b) and (c)."""
    by_path = {}
    for name, fn in (("fleet:ampere", fleet_ampere),
                     ("fleet:fedbuff", fleet_fedbuff),
                     ("fleet_compare", fleet_compare),
                     ("fleet_resume", fleet_resume)):
        by_path[name] = fn(dev)
        torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# Phase 13: heterogeneous cuts
# ---------------------------------------------------------------------------


def cuts_accounting(model, run_cfg, seq, hist, store, plans, clients, cuts,
                    bandwidth):
    """13(a)'s bytes and clock, recomputed (analytic: no device number),
    each client priced at its own cut: ``comm_bytes`` = the sum over the
    plans of 2 x the survivors' (s_d + s_aux) at their depths +
    ``bytes_received``; ``sim_time`` = the plans' round times, then the
    upload (each device's shard over its own link, the slowest), then the
    server epoch, the sum over the store's depths of each bucket's epoch
    at its depth, summed in the Runner's order."""
    sizes = {d: comm_model.split_sizes(model, dataclasses.replace(
                 run_cfg.split, split_point=d), seq_len=seq)
             for d in cuts.depths}

    def one_way(c):
        s = sizes[cuts.cut_of(c)]
        return s.device + s.aux

    nbytes = store.bytes_received
    want_comm = sum(2 * sum(one_way(c) for c in p.clients)
                    for p in plans) + nbytes
    want_time = 0.0
    for p in plans:
        want_time += p.round_time
    per_sample = nbytes / store.num_samples()
    upload_s = max(len(c.dataset) * per_sample / bandwidth[c.client_id]
                   for c in clients)
    want_time += upload_s
    epoch_s = sum(
        comm_model.ampere_server_epoch_time(
            model, dataclasses.replace(run_cfg.split, split_point=d),
            comm_model.TimeModel(), n_samples=store.num_samples(cut=d),
            seq_len=seq, sizes=sizes[d])
        for d in store.cut_depths())
    for _ in range(SERVER_EPOCHS):
        want_time += epoch_s
    per = seq * model.cfg.d_model * 4 + seq * 4
    got = (nbytes, hist["comm_bytes"], hist["sim_time"])
    want = (TRAIN_SAMPLES * per, want_comm, want_time)
    log("cuts_accounting", bytes_received=nbytes,
        comm_bytes=hist["comm_bytes"], sim_time_s=hist["sim_time"],
        one_way_bytes={d: s.device + s.aux for d, s in sizes.items()},
        rounds_s=sum(p.round_time for p in plans), upload_s=upload_s,
        server_epoch_s=epoch_s, ok=got == want)
    if got != want:
        raise AssertionError(f"cuts accounting: (bytes_received, "
                             f"comm_bytes, sim_time) {got} != {want}")


def cuts_fleet(dev):
    """13(a): ``CUT_POLICY`` over phase 12's population gives each device
    class its own cut; the sync trace is priced per class at its cut, and
    ``AmpereTrainer(cuts=...).run_fleet`` trains full-width qwen3-1.7b on
    it: a round's survivors trained in one bucket per depth, prefix
    FedAvg, cut-tagged shards, and one server epoch entering the server
    block at each depth."""
    cfg, run_cfg, model, clients, evald, pop = fleet_setup()
    seq = MAIN_PATHS[FLEET_ARCH]["seq"]
    fcfg = FleetConfig(**FLEET)
    cuts = resolve_cuts(CUT_POLICY, model, run_cfg, fcfg, seq_len=seq)
    run_cfg = dataclasses.replace(run_cfg, split=dataclasses.replace(
        run_cfg.split, split_point=cuts.depths[0]))
    lat = make_latency_fn(model, run_cfg, algo="ampere", seq_len=seq,
                          cuts=cuts.by_class)
    trace = FleetScheduler(pop, lat, fcfg).simulate(FLEET_ROUNDS)
    trainer = AmpereTrainer(model, run_cfg, clients, evald, device=dev,
                            cuts=cuts)
    buckets = []         # (round, depth, clients, wall seconds)
    run_round = FleetEngine.run_round

    def timed_round(engine, state, rnd, client_ids, *args, **kwargs):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = run_round(engine, state, rnd, client_ids, *args, **kwargs)
        torch.cuda.synchronize(dev)
        buckets.append((rnd, engine.run.split.split_point, list(client_ids),
                        time.perf_counter() - t))
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    FleetEngine.run_round = timed_round
    t = time.perf_counter()
    try:
        out = trainer.run_fleet(trace, max_rounds=FLEET_ROUNDS,
                                max_server_epochs=SERVER_EPOCHS,
                                population=pop)
    finally:
        FleetEngine.run_round = run_round
    seconds = time.perf_counter() - t
    launches = read_launches()
    hist, store = out["history"], out["store"]
    round_s = [sum(b[3] for b in buckets if b[0] == r)
               for r in range(FLEET_ROUNDS)]
    log("cuts_fleet", arch=cfg.name, seq=seq, seconds=seconds,
        cuts=cuts.summary(), by_client=cuts.by_client, round_s=round_s,
        buckets=buckets,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        plans=[(p.clients, p.dropped, p.cohort_size, p.round_time)
               for p in trace.rounds],
        store_depths={d: store.num_samples(cut=d)
                      for d in store.cut_depths()},
        device=hist["device"], server=hist["server"], launches=launches,
        card=card_line())
    cuts_accounting(model, run_cfg, seq, hist, store, trace.rounds[
        :FLEET_ROUNDS], clients, cuts,
        {p.device_id: p.bandwidth_bps for p in pop})
    del out
    _check_fleet_path("cuts", cfg, hist, launches, FLEET_ROUNDS)
    if len(cuts.depths) < 2 or len(store.cut_depths()) < 2:
        raise AssertionError(f"cuts: depths {cuts.depths} in the "
                             f"assignment, {store.cut_depths()} in the store")
    rounds = [b[0] for b in buckets]
    if not any(rounds.count(r) >= 2 for r in rounds):
        raise AssertionError(f"cuts: no round trained two buckets: "
                             f"{buckets}")
    return launches


def cuts_experiment(dev):
    """13(b): ``examples/specs/cut_smoke.json`` without its observability
    section (14(d) runs it whole), at its 2 rounds and 2 server epochs,
    on the card and on the CPU from the same CPU-seeded init."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = dataclasses.replace(
            ExperimentSpec.load(os.path.join(ROOT, CUT_SPEC)),
            observability=None, results_dir=tmp)
        reset_launches()
        t = time.perf_counter()
        card = run_experiment(spec, device=dev, write_results=False)
        seconds = time.perf_counter() - t
        launches = read_launches()
        cpu = run_experiment(spec, device="cpu", write_results=False)
    cut_summary = card["summary"]["ampere"]["cuts"]
    if cut_summary != cpu["summary"]["ampere"]["cuts"] or \
            cut_summary["uniform"]:
        raise AssertionError(f"cut_smoke cuts: card {cut_summary}, cpu "
                             f"{cpu['summary']['ampere']['cuts']}")
    card_vs_cpu("cuts_experiment", spec.systems, card, cpu)
    log("cuts_experiment", cuts=cut_summary, seconds_card=seconds,
        launches=launches, card=card_line())
    return launches, card["results"]["ampere"]["history"]


def cuts_phase(dev) -> tuple:
    """Phase 13: launches by path of (a) and (b), and (b)'s card
    history (phase 14(d) holds the spec with observability to it)."""
    by_path = {"cuts:ampere": cuts_fleet(dev)}
    torch.cuda.empty_cache()
    by_path["cuts_experiment"], card_hist = cuts_experiment(dev)
    torch.cuda.empty_cache()
    return by_path, card_hist


# ---------------------------------------------------------------------------
# Phase 14: chaos — the fault-injecting transport, quorum-degraded rounds,
# torn writes and span tracing
# ---------------------------------------------------------------------------


def chaos_transport(obs=None):
    """14(a)'s transport: every fault kind of ``CHAOS_FAULTS``, with
    ``CHAOS_RETRY``'s attempts to absorb them."""
    return InProcessTransport(FaultPlan(CHAOS_FAULTS), CHAOS_RETRY, obs=obs)


def chaos_trainer(dev, transport=None, obs=None):
    """Phase 12's qwen3-1.7b federation and corpus in an Ampere trainer at
    the main path's static cut, with ``transport`` and ``obs``."""
    cfg, run_cfg, model, clients, evald, _ = fleet_setup()
    return cfg, AmpereTrainer(
        model, run_cfg, clients, evald, device=dev, transport=transport,
        quorum_frac=CHAOS_QUORUM if transport is not None else 1.0,
        obs=obs)


def chaos_run(dev, faulty: bool) -> dict:
    """One 14(a) run through ``AmpereSystem.run``: ``CHAOS_ROUNDS`` i.i.d.
    rounds, the upload and one server epoch; faulty: under
    :func:`chaos_transport` with observability on, else with neither.
    Each round's ``_device_round`` is timed (the card synchronized around
    it)."""
    obs = Observability() if faulty else None
    transport = chaos_transport(obs) if faulty else None
    cfg, tr = chaos_trainer(dev, transport, obs)
    ctx = SystemContext(model=tr.model, run_cfg=tr.run, clients=tr.clients,
                        eval_data=tr.eval_data, max_rounds=CHAOS_ROUNDS,
                        max_server_epochs=SERVER_EPOCHS, device=dev,
                        trainer=tr, transport=transport,
                        quorum_frac=tr.quorum_frac, obs=obs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    round_s = []
    t = time.perf_counter()
    with timed_calls(tr, "_device_round", dev, round_s):
        out = AmpereSystem().run(ctx)
    seconds = time.perf_counter() - t
    run = dict(cfg=cfg, hist=out["history"], launches=read_launches(),
               round_s=round_s, seconds=seconds,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               transport=transport, obs=obs)
    del out
    return run


def chaos_full(dev) -> dict:
    """14(a): full-width qwen3-1.7b under every fault kind, then clean.
    No client is excluded, so the faulted history less ``comm_bytes`` and
    ``sim_time`` equals the clean one bit for bit, while those two are
    larger (retries, duplicates, backoff, timeouts and spikes); the
    summary's wire bytes are the history's ``comm_bytes``; the tracer
    closed every span, dropped nothing and has spans on the device,
    transfer, server and eval tracks; its exported ``trace.json``
    validates and its span log reads back strictly."""
    faulted = chaos_run(dev, True)
    torch.cuda.empty_cache()
    clean = chaos_run(dev, False)
    torch.cuda.empty_cache()
    hf, hc = faulted["hist"], clean["hist"]
    obs = faulted["obs"]
    wire = dict(faulted["transport"].stats)
    counters = obs.metrics.to_dict()["counters"]
    trace = obs.tracer.summary()
    with tempfile.TemporaryDirectory() as tmp:
        arts = export_artifacts(obs.tracer, tmp)
        with open(arts["trace_json"]) as f:
            problems = validate_chrome_trace(json.load(f))
        spans = read_span_log(arts["span_log"], strict=True)
    span_tracks = sorted({e.track for e in obs.tracer.events
                          if e.kind == "span"})
    log("chaos", arch=faulted["cfg"].name, rounds=CHAOS_ROUNDS,
        faults=dataclasses.asdict(CHAOS_FAULTS),
        retry=dataclasses.asdict(CHAOS_RETRY), quorum_frac=CHAOS_QUORUM,
        round_s_faulted=faulted["round_s"], round_s_clean=clean["round_s"],
        seconds_faulted=faulted["seconds"], seconds_clean=clean["seconds"],
        peak_mem_gib_faulted=faulted["peak_mem_gib"],
        peak_mem_gib_clean=clean["peak_mem_gib"], wire=wire,
        comm_bytes=[hf["comm_bytes"], hc["comm_bytes"]],
        sim_time_s=[hf["sim_time"], hc["sim_time"]], trace=trace,
        span_tracks=span_tracks, spans_read=len(spans),
        trace_json_problems=problems[:5],
        phases=obs.metrics.phase_table(), counters=counters,
        device=hf["device"], server=hf["server"],
        launches=faulted["launches"], card=card_line())
    if wire["failures"] or any(k.startswith("excluded_devices")
                               for k in counters):
        raise AssertionError(f"chaos: a client was excluded: {wire}, "
                             f"{counters}")

    def rest(h):
        return {k: v for k, v in h.items()
                if k not in ("comm_bytes", "sim_time")}

    if rest(hf) != rest(hc):
        raise AssertionError(f"chaos: the faulted trajectory differs from "
                             f"the clean one: {rest(hf)} vs {rest(hc)}")
    if not (hf["comm_bytes"] > hc["comm_bytes"]
            and hf["sim_time"] > hc["sim_time"]):
        raise AssertionError(f"chaos: accounting not above the clean run's:"
                             f" {hf['comm_bytes']}, {hf['sim_time']} vs "
                             f"{hc['comm_bytes']}, {hc['sim_time']}")
    if wire["wire_bytes"] != hf["comm_bytes"] or \
            wire["retries"] + wire["duplicates"] <= 0:
        raise AssertionError(f"chaos: wire {wire} vs comm_bytes "
                             f"{hf['comm_bytes']}")
    if trace["open_spans"] or trace["dropped"] or problems or \
            len(spans) != trace["events"] or \
            not {"device", "transfer", "server", "eval"} <= set(span_tracks):
        raise AssertionError(f"chaos: tracer {trace}, span tracks "
                             f"{span_tracks}, trace.json {problems[:5]}, "
                             f"{len(spans)} spans read")
    _check_fleet_path("chaos", faulted["cfg"], hf, faulted["launches"],
                      CHAOS_ROUNDS)
    _check_fleet_path("chaos clean", clean["cfg"], hc, clean["launches"],
                      CHAOS_ROUNDS)
    return {"chaos:faulted": faulted["launches"],
            "chaos:clean": clean["launches"]}


def call_sites(doc: dict, span_names, window: str) -> dict:
    """The profiler's Chrome trace ``doc`` of 14(b), read by launch.

    Each device operation (a kernel, memcpy or memset) is attributed to
    its launch, the runtime call with its correlation id.  Returns, for
    each entry point of ``CALL_SITES``, the kernels of its families, how
    many were launched inside a range of its name on the launching thread,
    and how many such ranges launched one of each family; the kernels
    launched inside the ``window`` range and how many of them lie inside
    some range named in ``span_names`` (on any thread: a backward runs on
    autograd's thread inside the step's span); and, per span name, the
    device time of the operations launched inside its ranges, its idle
    share (one less the union of their intervals within the ranges over
    the ranges' time), and its ``PROFILE_TOP`` operations by device
    time.  Ranges of one name never nest, so the last one starting at or
    before a launch is the only one that can hold it."""
    ev = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ops = []     # (launch ts, launch end, tid, start, end, name, cat)
    unlinked = 0
    for e in ev:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        la = launch.get(e.get("args", {}).get("correlation"))
        if la is None:
            unlinked += 1
            continue
        ops.append((la["ts"], la["ts"] + la["dur"], la["tid"], e["ts"],
                    e["ts"] + e["dur"], e["name"], e["cat"]))
    ops.sort(key=lambda o: o[0])
    ranges = {}  # name -> sorted [(ts, end, tid)]
    for e in ev:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    by_tid = {}
    for name, rs in ranges.items():
        rs.sort()
        for r in rs:
            by_tid.setdefault((name, r[2]), []).append(r)
    starts = {k: [r[0] for r in rs]
              for k, rs in list(ranges.items()) + list(by_tid.items())}

    def holding(name, o, same_thread):
        """The range of ``name`` that holds launch ``o``, or None."""
        key = (name, o[2]) if same_thread else name
        rs = (by_tid if same_thread else ranges).get(key, [])
        i = bisect.bisect_right(starts.get(key, []), o[0]) - 1
        return rs[i] if i >= 0 and rs[i][1] >= o[1] else None

    sites = {}
    for entry, (rng, families) in CALL_SITES.items():
        mine = [o for o in ops if any(f in o[5] for f in families)]
        held = [holding(rng, o, True) for o in mine]
        sites[entry] = {
            "range": rng, "kernels": len(mine),
            "in_range": sum(r is not None for r in held),
            "ranges_by_family": {f: len({r for o, r in zip(mine, held)
                                         if r is not None and f in o[5]})
                                 for f in families}}
    win = ranges.get(window, [])
    in_window = [o for o in ops if o[6] == "kernel"
                 and any(w[0] <= o[0] and o[1] <= w[1] for w in win)]
    spanned = sum(any(holding(n, o, False) is not None for n in span_names)
                  for o in in_window)
    op_starts = [o[0] for o in ops]
    table = {}
    for name in span_names:
        dev_us, busy_us, span_us, by_op = 0.0, 0.0, 0.0, {}
        for t0, t1, _ in ranges.get(name, []):
            span_us += t1 - t0
            mine = [o for o in ops[bisect.bisect_left(op_starts, t0):
                                   bisect.bisect_right(op_starts, t1)]
                    if o[1] <= t1]
            for o in mine:
                dev_us += o[4] - o[3]
                ms, n = by_op.get(o[5], (0.0, 0))
                by_op[o[5]] = (ms + (o[4] - o[3]) / 1e3, n + 1)
            busy_us += _union_us([(max(o[3], t0), min(o[4], t1))
                                  for o in mine if o[4] > t0 and o[3] < t1])
        if span_us:
            top = sorted(by_op.items(), key=lambda kv: -kv[1][0])
            table[name] = {
                "ranges": len(ranges[name]), "wall_ms": span_us / 1e3,
                "device_ms": dev_us / 1e3,
                "idle_share": 1.0 - busy_us / span_us,
                "top": [{"name": k[:100], "ms": ms, "calls": n}
                        for k, (ms, n) in top[:PROFILE_TOP]]}
    return {"sites": sites, "window_kernels": len(in_window),
            "window_kernels_in_spans": spanned, "unlinked": unlinked,
            "table": table}


def chaos_profiled(dev) -> dict:
    """14(b): one device round, the upload and one server epoch of 14(a)'s
    faulted setup with a ``profile=True`` tracer inside ``profile_run``.
    Each of ``flash_fwd``, ``flash_bwd_fused``, ``xent_fwd`` and
    ``xent_bwd`` launches inside a range of its entry point's name (one
    range per wrapper launch), every kernel of the round lies inside some
    tracer span, and each span's device time, idle share and top device
    operations are printed: the call-site table."""
    obs = Observability(profile=True)
    cfg, tr = chaos_trainer(dev, chaos_transport(obs), obs)
    dp, srv, ap = tr._init_states(torch.Generator().manual_seed(tr.run.seed))
    store = ActivationStore(seed=tr.run.seed)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        with profile_run(tmp) as prof:
            with torch.profiler.record_function(CHAOS_WINDOW):
                st = tr.run_device_phase({"device": dp, "aux": ap}, 1)
                torch.cuda.synchronize(dev)
            del dp, ap
            tr.generate_activations(st, store)
            tr.run_server_phase(st, srv, store, SERVER_EPOCHS)
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t
        launches = read_launches()
        t = time.perf_counter()
        with open(prof.trace_path) as f:
            doc = json.load(f)
        trace_mb = os.path.getsize(prof.trace_path) / 2 ** 20
    del prof, st, srv, store
    span_names = sorted({e.name for e in obs.tracer.events
                         if e.kind == "span"})
    out = call_sites(doc, span_names, CHAOS_WINDOW)
    del doc
    log("chaos_profile", arch=cfg.name, seconds=seconds,
        read_s=time.perf_counter() - t, trace_mb=trace_mb,
        launches={k: launches[k] for k in FLEET_KERNELS},
        sites=out["sites"], window_kernels=out["window_kernels"],
        window_kernels_in_spans=out["window_kernels_in_spans"],
        unlinked_device_ops=out["unlinked"], card=card_line())
    for name, row in out["table"].items():
        log("call_site", span=name, **row, card=card_line())
    want = {"flash_fwd": {"fa_fwd_tc_kernel": launches["flash_fwd"]},
            "flash_bwd_fused": {
                "fa_bwd_tc_kernel": launches["flash_bwd_fused"]},
            "xent": {"xent_combine_kernel": launches["xent_fwd"],
                     "xent_tc_gemm_kernel": launches["xent_bwd"]}}
    for entry, site in out["sites"].items():
        if not (site["kernels"] > 0
                and site["in_range"] == site["kernels"]
                and site["ranges_by_family"] == {
                    **site["ranges_by_family"], **want[entry]}
                and all(n > 0 for n in want[entry].values())):
            raise AssertionError(f"chaos profile: {entry} kernels outside "
                                 f"their range {site['range']!r}: {site}, "
                                 f"wrapper launches {want[entry]}")
    if not 0 < out["window_kernels"] == out["window_kernels_in_spans"]:
        raise AssertionError(
            f"chaos profile: {out['window_kernels_in_spans']} of the "
            f"round's {out['window_kernels']} kernels inside a tracer span")
    if not {"device.round", "server.epoch"} <= set(out["table"]):
        raise AssertionError(f"chaos profile: spans {sorted(out['table'])}")
    return launches


def chaos_experiment(dev) -> dict:
    """14(c): ``examples/specs/chaos_smoke.json`` (transport, faults with
    torn checkpoint and journal writes, observability; vit-s, so no
    hand-written kernel) on the card and on the CPU from the same
    CPU-seeded init: wire statistics, the tracer's digest and the metrics'
    counters (the exclusions among them) ``==``, and the histories within
    phase 12(c)'s gate (losses 1e-4 relative, accuracies 1e-2,
    ``comm_bytes`` and ``sim_time`` equal)."""
    with tempfile.TemporaryDirectory() as tmp:
        base = ExperimentSpec.load(os.path.join(ROOT, CHAOS_SPEC))
        reset_launches()
        t = time.perf_counter()
        card = run_experiment(dataclasses.replace(
            base, results_dir=os.path.join(tmp, "card")), device=dev,
            write_results=False)
        seconds = time.perf_counter() - t
        launches = read_launches()
        cpu = run_experiment(dataclasses.replace(
            base, results_dir=os.path.join(tmp, "cpu")), device="cpu",
            write_results=False)
    card_vs_cpu("chaos_experiment", base.systems, card, cpu)
    for name in base.systems:
        got, want = (
            (o["summary"][name]["wire"], o["summary"][name]["trace"],
             o["results"][name]["history"]["observability"]["metrics"][
                 "counters"]) for o in (card, cpu))
        log("chaos_experiment", system=name, wire=got[0], trace=got[1],
            excluded={k: v for k, v in got[2].items()
                      if k.startswith("excluded")},
            seconds_card=seconds, launches=launches, card=card_line())
        if got != want:
            raise AssertionError(f"chaos_smoke {name}: card (wire, trace, "
                                 f"counters) {got} vs cpu {want}")
    return launches


def cuts_observed(dev, cut_card_hist) -> dict:
    """14(d): ``examples/specs/cut_smoke.json`` whole, its observability
    section included, on the card: the history equals (``==``) phase
    13(b)'s card run without it, and the tracer closed every span."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = dataclasses.replace(
            ExperimentSpec.load(os.path.join(ROOT, CUT_SPEC)),
            results_dir=tmp)
        reset_launches()
        t = time.perf_counter()
        out = run_experiment(spec, device=dev, write_results=False)
        seconds = time.perf_counter() - t
        launches = read_launches()
    hist = dict(out["results"]["ampere"]["history"])
    digest = hist.pop("observability")
    log("cuts_observed", seconds_card=seconds, trace=digest["tracer"],
        phases=out["summary"]["ampere"]["phases"], launches=launches,
        card=card_line())
    if hist != cut_card_hist:
        raise AssertionError(f"cut_smoke with observability vs without: "
                             f"{hist} vs {cut_card_hist}")
    if digest["tracer"]["open_spans"] or not digest["tracer"]["events"]:
        raise AssertionError(f"cut_smoke tracer: {digest['tracer']}")
    return launches


def chaos_phase(dev, cut_card_hist) -> dict:
    """Phase 14: launches by path of (a), (b), (c) and (d)."""
    by_path = chaos_full(dev)
    for name, fn in (("chaos_profile", chaos_profiled),
                     ("chaos_experiment", chaos_experiment),
                     ("cuts_observed",
                      lambda d: cuts_observed(d, cut_card_hist))):
        by_path[name] = fn(dev)
        torch.cuda.empty_cache()
    return by_path


def _span_wall_s(obs, name) -> list:
    return [e.dur_wall for e in obs.tracer.events
            if e.kind == "span" and e.name == name]


def _host_timed(obj, name, out: list):
    """Appends the wall seconds of every call of ``obj.name`` (a host
    function: no card synchronization) to ``out``."""
    fn = getattr(obj, name)

    def wrapper(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            out.append(time.perf_counter() - t)

    setattr(obj, name, wrapper)


class _StoreGiven(AmpereSystem):
    """Ampere with a store made by the caller."""

    def __init__(self, store):
        self.store = store

    def _make_store(self, tr, ctx):
        return self.store


def streaming_run(dev, ring_dir=None) -> dict:
    """One 15(a) run through ``AmpereSystem.run``: phase 14(a)'s clean
    setup (``CHAOS_ROUNDS`` i.i.d. rounds, the upload, one server epoch)
    with observability on, the serialized store, or a memmap ring under
    ``ring_dir`` whose segment writes (+ fsync) and CRC re-verifies are
    timed."""
    obs = Observability()
    cfg, tr = chaos_trainer(dev, obs=obs)
    system, write_s, verify_s = AmpereSystem(), [], []
    if ring_dir is not None:
        system = _StoreGiven(StreamingActivationStore(
            directory=ring_dir, seed=tr.run.seed,
            capacity_segments=STREAM_CAPACITY,
            low_watermark=STREAM_LOW_WATERMARK, backend="memmap", obs=obs))
        _host_timed(system.store.ring, "_store_blob", write_s)
        _host_timed(system.store.ring, "_verify", verify_s)
    ctx = SystemContext(model=tr.model, run_cfg=tr.run, clients=tr.clients,
                        eval_data=tr.eval_data, max_rounds=CHAOS_ROUNDS,
                        max_server_epochs=SERVER_EPOCHS, device=dev,
                        trainer=tr, obs=obs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t = time.perf_counter()
    out = system.run(ctx)
    seconds = time.perf_counter() - t
    store = out["store"]
    run = dict(cfg=cfg, hist=out["history"], launches=read_launches(),
               seconds=seconds, bytes=store.bytes_received,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               consolidate_s=_span_wall_s(obs, "consolidate"),
               stream_consume_s=_span_wall_s(obs, "stream_consume"),
               phases=obs.metrics.phase_table(), write_s=write_s,
               verify_s=verify_s,
               ring_stats=dict(store.ring.stats) if ring_dir else None)
    del out, store, system
    return run


def streaming_full(dev) -> tuple:
    """15(a): full-width qwen3-1.7b with the serialized store, then with a
    memmap ring of ``STREAM_CAPACITY`` segments in a temp dir: the
    histories ``==`` less ``sim_time``, which the ring's run does not
    exceed; backpressure stalls and ``overlap_s`` above 0.  Returns the
    launches by path, the serialized history and its upload bytes."""
    serial = streaming_run(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ring = streaming_run(dev, os.path.join(tmp, "ring"))
        seg_bytes = sorted(os.path.getsize(os.path.join(tmp, "ring", f))
                           for f in os.listdir(os.path.join(tmp, "ring")))
    torch.cuda.empty_cache()
    hs, hr, stats = serial["hist"], ring["hist"], ring["ring_stats"]
    server_row = [r for r in ring["phases"] if r["phase"] == "server"]
    overlap_s = server_row[0]["overlap_s"] if server_row else 0.0
    log("streaming", arch=serial["cfg"].name, rounds=CHAOS_ROUNDS,
        capacity_segments=STREAM_CAPACITY,
        low_watermark=STREAM_LOW_WATERMARK, ring_stats=stats,
        segment_bytes=seg_bytes,
        upload_bytes=[serial["bytes"], ring["bytes"]],
        ring_write_fsync_s=ring["write_s"], ring_verify_crc_s=ring["verify_s"],
        consolidate_s_serialized=serial["consolidate_s"],
        consolidate_s_ring=ring["consolidate_s"],
        stream_consume_s=ring["stream_consume_s"],
        seconds_serialized=serial["seconds"], seconds_ring=ring["seconds"],
        peak_mem_gib_serialized=serial["peak_mem_gib"],
        peak_mem_gib_ring=ring["peak_mem_gib"],
        sim_time_s=[hs["sim_time"], hr["sim_time"]], overlap_s=overlap_s,
        comm_bytes=[hs["comm_bytes"], hr["comm_bytes"]],
        device=hr["device"], server=hr["server"],
        launches=ring["launches"], card=card_line())

    def rest(h):
        return {k: v for k, v in h.items() if k != "sim_time"}

    if rest(hs) != rest(hr):
        raise AssertionError(f"streaming: the ring's history differs from "
                             f"the serialized one: {rest(hr)} vs {rest(hs)}")
    if not hr["sim_time"] <= hs["sim_time"] or not overlap_s > 0 or \
            not stats["stalls"] > 0 or stats["torn_repairs"] or \
            serial["bytes"] != ring["bytes"]:
        raise AssertionError(f"streaming: sim_time {hr['sim_time']} vs "
                             f"{hs['sim_time']}, overlap_s {overlap_s}, "
                             f"ring {stats}, bytes {serial['bytes']} vs "
                             f"{ring['bytes']}")
    _check_fleet_path("streaming serialized", serial["cfg"], hs,
                      serial["launches"], CHAOS_ROUNDS)
    _check_fleet_path("streaming ring", ring["cfg"], hr, ring["launches"],
                      CHAOS_ROUNDS)
    return ({"streaming:serialized": serial["launches"],
             "streaming:ring": ring["launches"]}, hs, serial["bytes"])


def streaming_experiment(dev) -> dict:
    """15(b): ``examples/specs/streaming_smoke.json`` (vit-s; a memmap ring
    of 4 under faults with a quarter of the writes torn; observability
    on) on the card and on the CPU from the same CPU-seeded init: the ring
    stats, the wire statistics and the counters ``==``; every record but
    the last server epoch's within phase 12(c)'s gate, that one (the run
    diverges) at ``STREAM_DIVERGED_RTOL``."""
    base = ExperimentSpec.load(os.path.join(ROOT, STREAM_SPEC))
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for where, device in (("card", dev), ("cpu", "cpu")):
            reset_launches()
            t = time.perf_counter()
            outs[where] = run_experiment(dataclasses.replace(
                base, results_dir=os.path.join(tmp, where)), device=device,
                write_results=False)
            outs[f"{where}_s"] = time.perf_counter() - t
            if where == "card":
                launches = read_launches()      # before the CPU run
    card, cpu = outs["card"], outs["cpu"]
    h_card, h_cpu = (o["results"]["ampere"]["history"] for o in (card, cpu))
    rel = {f"{ph}{i}_{k}": abs(x[k] - y[k]) / abs(y[k])
           for ph in ("device", "server")
           for i, (x, y) in enumerate(zip(h_card[ph], h_cpu[ph]))
           for k in ("loss", "val_loss")}
    got, want = ((o["results"]["ampere"]["store"].ring.stats,
                  o["summary"]["ampere"]["wire"],
                  o["results"]["ampere"]["history"]["observability"][
                      "metrics"]["counters"]) for o in (card, cpu))
    log("streaming_experiment", ring_stats=got[0], wire=got[1],
        counters={k: v for k, v in got[2].items() if "ring" in k
                  or "overlap" in k}, rel_diff=rel,
        seconds_card=outs["card_s"], seconds_cpu=outs["cpu_s"],
        launches=launches, card=card_line())
    if got != want:
        raise AssertionError(f"streaming_smoke: card (ring, wire, counters) "
                             f"{got} vs cpu {want}")
    last = f"server{len(h_cpu['server']) - 1}_"
    for key, r in rel.items():
        if not r <= (STREAM_DIVERGED_RTOL if key.startswith(last)
                     else 1e-4):
            raise AssertionError(f"streaming_smoke card vs cpu {key}: {r}")
    for ph in ("device", "server"):
        if len(h_card[ph]) != len(h_cpu[ph]) or any(
                abs(x["val_acc"] - y["val_acc"]) > 1e-2
                for x, y in zip(h_card[ph], h_cpu[ph])):
            raise AssertionError(f"streaming_smoke {ph}: {h_card[ph]} vs "
                                 f"{h_cpu[ph]}")
    for key in ("comm_bytes", "sim_time"):
        if h_card[key] != h_cpu[key]:
            raise AssertionError(f"streaming_smoke {key}: {h_card[key]} vs "
                                 f"{h_cpu[key]}")
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _in_thread(fn, *args, **kwargs):
    """``fn`` in a daemon thread: ``(thread, out)``, ``out`` getting
    ``"result"`` or ``"error"``."""
    out = {}

    def run():
        try:
            out["result"] = fn(*args, **kwargs)
        except BaseException as err:
            out["error"] = err

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th, out


def _joined(th, out, what):
    th.join(timeout=ROLE_JOIN_S)
    if th.is_alive():
        raise AssertionError(f"{what}: still running after {ROLE_JOIN_S} s")
    if "error" in out:
        raise AssertionError(f"{what} failed: {out['error']!r}") \
            from out["error"]
    return out["result"]


def _two_roles(spec, device, setup=None, results_dir=None):
    """The server role and the device role in two threads over loopback
    (a port bound from 0): (server result, device result)."""
    port = _free_port()
    srv = _in_thread(roles.run_server_role, spec, port=port,
                     results_dir=results_dir, device=device, setup=setup)
    dev_side = _in_thread(roles.run_device_role, spec, port=port,
                          device=device, setup=setup)
    return (_joined(*srv, "server role"),
            _joined(*dev_side, "device role"))


def socket_full(dev, serial_hist, upload_bytes) -> dict:
    """15(c): the two roles at full width in two threads, handed 15(a)'s
    setup: the server's history ``==`` 15(a)'s serialized run's (records,
    ``comm_bytes``, ``sim_time``), ``analytic_transfer_bytes`` its upload
    bytes, and the measured wire bytes exactly the frames' (no retry):
    the analytic bytes, the state frame, and the framing (frame headers,
    metadata, CRCs, the npz containers, the ``done`` frame)."""
    cfg, run_cfg, model, clients, evald, _ = fleet_setup()
    spec = ExperimentSpec(
        name="socket_full", arch=FLEET_ARCH, smoke=False, run=run_cfg,
        data=DataSpec(train_samples=TRAIN_SAMPLES, eval_samples=EVAL_SAMPLES,
                      seq_len=MAIN_PATHS[FLEET_ARCH]["seq"]),
        max_rounds=CHAOS_ROUNDS, max_server_epochs=SERVER_EPOCHS,
        transport=SOCKET_TRANSPORT)
    frames, hists = [], []
    recv, run_server_phase = FrameReceiver.recv, AmpereTrainer.run_server_phase

    def recording_recv(self):
        f = recv(self)
        stored = 0
        if f.kind == "shard":
            with np.load(io.BytesIO(f.payload)) as z:
                stored = sum(z[k].nbytes for k in z.files)
        frames.append((f.kind, len(encode_frame(f)), stored))
        return f

    def recording_phase(self, *args, **kwargs):
        out = run_server_phase(self, *args, **kwargs)
        hists.append(dict(self.history))
        return out

    FrameReceiver.recv = recording_recv
    AmpereTrainer.run_server_phase = recording_phase
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            server, device = _two_roles(
                spec, dev, setup=(spec, model, clients, evald),
                results_dir=tmp)
    finally:
        FrameReceiver.recv = recv
        AmpereTrainer.run_server_phase = run_server_phase
    seconds = time.perf_counter() - t
    launches = read_launches()
    summary = server["summary"]
    measured, analytic = (summary["measured_wire_bytes"],
                          summary["analytic_transfer_bytes"])
    state = [n for kind, n, _ in frames if kind == "state"]
    stored = sum(st for _, _, st in frames)
    framing = sum(n - st for kind, n, st in frames if kind != "state")
    log("socket", arch=FLEET_ARCH, seconds=seconds,
        measured_wire_bytes=measured, analytic_transfer_bytes=analytic,
        device_sent_bytes=device["sent_bytes"], state_frame_bytes=state,
        framing_bytes=framing, frame_stats=summary["frames"],
        frames={k: sum(1 for f in frames if f[0] == k)
                for k in ("state", "shard", "done")},
        sender_stats=device["stats"], comm_bytes=summary["comm_bytes"],
        sim_time_s=summary["sim_time_s"],
        server=hists[0]["server"] if hists else None,
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        ru_maxrss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        / 2 ** 20, launches=launches, card=card_line())
    if len(hists) != 1 or hists[0] != serial_hist:
        raise AssertionError(f"socket: the server's history {hists} vs the "
                             f"serialized run's {serial_hist}")
    if analytic != upload_bytes or stored != analytic or \
            summary["device_analytic_bytes"] != analytic or \
            len(state) != 1 or \
            not state[0] > cfg.vocab_size * cfg.d_model * 4 > upload_bytes \
            or measured != sum(n for _, n, _ in frames) or \
            measured - analytic != state[0] + framing or \
            device["stats"]["retries"] or summary["frames"]["corrupt"]:
        raise AssertionError(f"socket: wire {measured} vs analytic "
                             f"{analytic} (upload {upload_bytes}, stored "
                             f"{stored}), state {state}, framing {framing}, "
                             f"{device['stats']}, {summary['frames']}")
    _check_fleet_path("socket", cfg, hists[0], launches, CHAOS_ROUNDS)
    return launches


def socket_cli(dev) -> None:
    """15(d): ``python -m repro_torch.launch.run_experiment SPEC --role
    server`` and ``... --role device`` as two processes on the card (the
    kernels already built), the qwen3 smoke spec over a socket; both exit
    0, and the server's ``summary.json`` matches the two roles run on the
    CPU: losses within 1e-4 relative, accuracies within 1e-2, the bytes
    of every frame before the ``done`` frame, the analytic bytes,
    ``comm_bytes`` and ``sim_time`` equal, and the ``done`` frame within
    ``DONE_FRAME_SLACK`` bytes a float of its history."""
    with tempfile.TemporaryDirectory() as tmp:
        spec = dataclasses.replace(experiment_spec(tmp), persist=False,
                                   transport=TransportSpec(kind="socket"))
        path = os.path.join(tmp, "spec.json")
        spec.save(path)
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        # on the card the roles run on the launcher's default device
        cmd = [sys.executable, "-m", "repro_torch.launch.run_experiment",
               path, "--port", str(port)] + (
                   [] if torch.device(dev).type == "cuda"
                   else ["--device", str(dev)])
        t = time.perf_counter()
        procs = []
        try:
            procs.append(subprocess.Popen(
                cmd + ["--role", "server", "--results-dir",
                       os.path.join(tmp, "out")], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            procs.append(subprocess.Popen(
                cmd + ["--role", "device"], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            outs = [p.communicate(timeout=ROLE_JOIN_S)
                    for p in reversed(procs)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        seconds = time.perf_counter() - t
        codes = [p.returncode for p in procs]
        if any(codes):
            raise AssertionError(f"socket cli: exit codes {codes} "
                                 f"(server, device): {outs[1][1][-3000:]} "
                                 f"{outs[0][1][-3000:]}")
        with open(os.path.join(tmp, "out", "summary.json")) as f:
            card = json.load(f)["summary"]
        cpu = _two_roles(spec, "cpu",
                         results_dir=os.path.join(tmp, "cpu"))[0]["summary"]
    # the done frame (measured less device_sent) carries the device
    # history as JSON, whose floats print each run's own last digits
    done = [s["measured_wire_bytes"] - s["device_sent_bytes"]
            for s in (card, cpu)]
    slack = DONE_FRAME_SLACK * (3 * cpu["num_device"] + 1)
    log("socket_cli", seconds=seconds, card=card, cpu=cpu,
        done_frame_bytes=done, done_frame_slack=slack,
        nvidia_smi=card_line())
    same = ("device_sent_bytes", "analytic_transfer_bytes",
            "device_analytic_bytes", "frames", "comm_bytes", "sim_time_s",
            "num_device", "num_server")
    if any(card[k] != cpu[k] for k in same) or \
            not abs(done[0] - done[1]) <= slack or \
            not abs(card["final_val_loss"] - cpu["final_val_loss"]) \
            <= 1e-4 * abs(cpu["final_val_loss"]) or \
            not abs(card["final_val_acc"] - cpu["final_val_acc"]) <= 1e-2:
        raise AssertionError(f"socket cli: card {card} vs cpu {cpu}")


def streaming_phase(dev) -> dict:
    """Phase 15: launches by path of (a), (b) and (c); (d) launches in its
    own processes."""
    by_path, serial_hist, upload_bytes = streaming_full(dev)
    by_path["streaming_experiment"] = streaming_experiment(dev)
    torch.cuda.empty_cache()
    by_path["socket"] = socket_full(dev, serial_hist, upload_bytes)
    torch.cuda.empty_cache()
    socket_cli(dev)
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
    cfg = main_config(arch)
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
    log("profile", arch=arch, **shape, by_category=by_category(by_name),
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


# ---------------------------------------------------------------------------
# Phase 16: MoE and the hybrid stack
# ---------------------------------------------------------------------------


def moe_layer_grads(cfg, params, x, r):
    """{"y", "aux", "x", "params"}: one MoE layer's output and balance
    loss, and the grads of sum(y r) + aux for x and every param, on the
    tensors' device."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    x = x.detach().clone().requires_grad_(True)
    y, aux = MOE.moe_mlp(cfg, p, x)
    g = iter(torch.autograd.grad(torch.sum(y.float() * r) + aux,
                                 tree_leaves(p) + [x]))
    grads = tree_map(lambda _: next(g), p)
    return {"y": y.detach(), "aux": aux.detach(), "x": next(g),
            "params": grads}


def moe_routing(cfg, params, x) -> dict:
    """Each token's experts and kept choices as (B, S, E) masks (free of
    the order within its top k), its near ties (a k-th and (k+1)-th gate
    within MOE_TIE) and near ties inside its top k (which reorder the
    choices but change no slot: a token's choices go to distinct
    experts)."""
    m = cfg.moe
    B, S = x.shape[:2]
    with torch.no_grad():
        gates, _, topi = MOE.route(cfg, params, x)
        _, _, keep = MOE.slots(topi, m.num_experts, MOE.capacity(cfg, S))
        onehot = torch.nn.functional.one_hot(topi, m.num_experts)
        top = torch.sort(gates, dim=-1, descending=True).values
        gaps = top[..., :m.top_k] - top[..., 1:m.top_k + 1]
    return {"sel": onehot.sum(-2).cpu(),
            "kept": (onehot * keep.reshape(B, S, m.top_k, 1)).sum(-2).cpu(),
            "tie": (gaps[..., -1] < MOE_TIE).cpu(),
            "order_tie": (gaps[..., :-1] < MOE_TIE).any(-1).cpu()}


def moe_layer_check(dev, arch) -> dict:
    """16(b) for one arch: routing and keep ``==`` off near ties, y, aux
    and grads within MOE_TOL on the sequences without one (fp32), then
    the published bf16 layer twice on the card, bit for bit."""
    cfg = registry.get_config(arch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    cpu = torch.device("cpu")
    params = MOE.init_moe(torch.Generator().manual_seed(0), cfg, cpu)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, MOE_X + (cfg.d_model,)),
                     dtype=torch.float32)
    r = torch.tensor(rng.normal(0, 1, MOE_X + (cfg.d_model,)),
                     dtype=torch.float32)
    p_d, x_d, r_d = (tree_map(lambda t: t.to(dev), params), x.to(dev),
                     r.to(dev))
    card, host = moe_routing(f32, p_d, x_d), moe_routing(f32, params, x)
    tie = card["tie"] | host["tie"]
    clean = ~tie.any(1)
    sel_ok = bool(torch.equal(card["sel"][~tie], host["sel"][~tie]))
    kept_ok = bool(torch.equal(card["kept"][clean], host["kept"][clean]))
    dropped = int(MOE_X[0] * MOE_X[1] * cfg.moe.top_k - host["kept"].sum())
    idx = torch.nonzero(clean)[:, 0]
    got = moe_layer_grads(f32, p_d, x_d[idx.to(dev)], r_d[idx.to(dev)])
    want = moe_layer_grads(f32, params, x[idx], r[idx])
    rel, leaf = _max_rel(tree_map(lambda t: t.cpu(), got), want)
    # the published bf16 layer, twice on the card
    xb = x_d.to(torch.bfloat16)
    runs = [moe_layer_grads(cfg, p_d, xb, r_d) for _ in range(2)]
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(runs[0]), tree_leaves(runs[1])))
    with torch.no_grad():
        _, _, topi = MOE.route(cfg, p_d, xb)
        C = MOE.capacity(cfg, MOE_X[1])
        ch_e, pos_c, keep = MOE.slots(topi, cfg.moe.num_experts, C)
        b_idx = torch.arange(MOE_X[0], device=dev)[:, None].expand_as(ch_e)
        rows = torch.zeros((MOE_X[0], cfg.moe.num_experts, C),
                           device=dev).index_put(
            (b_idx, ch_e, pos_c), keep.float(), accumulate=True)
    out = dict(arch=arch, x=list(MOE_X) + [cfg.d_model],
               experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
               capacity=C, shared=cfg.moe.num_shared_experts,
               near_ties=int(tie.sum()),
               near_tie_sequences=int((~clean).sum()),
               order_ties=int((card["order_tie"] | host["order_tie"]).sum()),
               compared_sequences=int(clean.sum()), experts_equal=sel_ok,
               keep_equal=kept_ok, dropped_fp32=dropped, max_rel=rel,
               max_rel_leaf=leaf, tol=MOE_TOL,
               aux_card=float(got["aux"]), aux_cpu=float(want["aux"]),
               bf16_bit_identical=same,
               bf16_dropped=int((~keep).sum()),
               bf16_max_kept_rows_per_slot=float(rows.max()))
    log("moe_layer", **out)
    if not (sel_ok and kept_ok and 2 * int(clean.sum()) >= MOE_X[0]
            and rel <= MOE_TOL and same and float(rows.max()) <= 1):
        raise AssertionError(f"{arch} MoE layer card vs CPU: {out}")
    return out


def kernel_category(name: str) -> str:
    """A kernel's share of a step: hand-written (attention, xent, SSD),
    top-k, cumsum (the MoE slot positions), index (the MoE scatter,
    gather and their backwards, the embedding's), GEMM (cuBLAS) or
    other."""
    n = name.lower()
    if any(w.startswith(("fa_", "xent_", "ssd_")) and "kernel" in w
           for w in n.replace("<", " ").replace("(", " ").split()):
        return "hand-written"
    if "topk" in n or "sort" in n:
        return "topk"
    if "scan" in n:
        return "cumsum"
    if "index" in n or "gather" in n or "scatter" in n:
        return "index"
    if any(p in n for p in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "gemm"
    return "other"


def by_category(by_name: dict) -> dict:
    """Device ms and kernel count by ``kernel_category`` of a profile's
    {name: (ms, calls)}."""
    cats = {}
    for name, (t, n) in by_name.items():
        c = cats.setdefault(kernel_category(name), {"ms": 0.0, "kernels": 0})
        c["ms"] += t
        c["kernels"] += n
    return dict(sorted(cats.items()))


def profile_moe_layer(dev):
    """16(d): one granite MoE layer forward and checkpointed backward (the
    server step's remat) at the main path's server shape (8 x seq),
    timed (CUDA events, median of PROFILE_STEPS) and profiled, its
    device time split by ``kernel_category``."""
    arch, batch = MOE_LAYER_ARCHS[0], 8
    cfg = main_config(arch)
    seq = MAIN_PATHS[arch]["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    p = tree_map(lambda t: t.requires_grad_(True),
                 MOE.init_moe(gen, cfg, dev))
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device=dev
                    ).to(torch.bfloat16).requires_grad_(True)

    def layer():
        y, aux = torch.utils.checkpoint.checkpoint(
            MOE.moe_mlp, cfg, p, x, use_reentrant=False)
        torch.autograd.grad(y.float().sum() + aux, tree_leaves(p) + [x])

    layer()
    ms = []
    for _ in range(PROFILE_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        layer()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        layer()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    log("moe_profile", arch=arch, server_layers=cfg.num_layers - 1,
        batch=batch, seq=seq, layer_ms=float(np.median(ms)),
        layer_ms_range=[min(ms), max(ms)],
        device_ms=sum(t for t, _ in by_name.values()),
        by_category=by_category(by_name),
        top=[{"name": name[:120], "ms": t, "calls": n}
             for name, (t, n) in ranked])


def moe_phase(dev) -> dict:
    """16(b)-(d); returns the launches of (c) by path."""
    t = time.perf_counter()
    for arch in MOE_LAYER_ARCHS:
        moe_layer_check(dev, arch)
        torch.cuda.empty_cache()
    by_path = {}
    for arch, rows in MOE_SMOKE.items():
        reset_launches()
        smoke_reference(dev, arch)
        by_path[f"moe_smoke:{arch}"] = launches = read_launches()
        missing = [name for name in rows if launches[name] <= 0]
        if missing:
            raise AssertionError(f"{arch} smoke never launched {missing}")
    profile_moe_layer(dev)
    torch.cuda.empty_cache()
    log("moe_phase", seconds=time.perf_counter() - t,
        launches={p: {k: v for k, v in n.items() if v}
                  for p, n in by_path.items()})
    return by_path


def dryrun_measured(dev) -> dict:
    """18(a): the dry-run's one-rank row of qwen3-1.7b's server step at the
    main path's shape against the same step run on the card."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun
    arch = DRYRUN_ARCH
    seq = MAIN_PATHS[arch]["seq"]
    shape = InputShape(f"main_{seq}", seq, 8, "train")
    t = time.perf_counter()
    row = dryrun.run_cell(arch, "train_4k", "debug", "server_train_step",
                          shape=shape, verbose=False)
    row_s = time.perf_counter() - t
    cfg = main_config(arch)
    run_cfg = dryrun.make_run_cfg(arch, "train_4k")
    model = build_model(cfg)
    step = dryrun.make_step_fn(model, run_cfg, "server_train_step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # each leaf on a storage of its own, as the row's inputs (a split's
    # leaves are views of the whole model's stacked tensors)
    srv = tree_map(torch.clone, splitting.split_params(
        model, model.init(gen, dev), run_cfg.split.split_point)[1])
    state = steps.init_server_state(model, run_cfg, srv)
    del srv
    batch = {"acts": torch.randn((8, seq, cfg.d_model), generator=gen,
                                 device=dev).to(torch.bfloat16),
             "tokens": torch.randint(0, cfg.vocab_size, (8, seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    fcm = FlopCounterMode(display=False)
    with fcm:
        new, m = step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    launches = read_launches()
    loss = float(m["loss"])
    flops = fcm.get_total_flops()
    del new, m
    step_ms = time_runs(lambda: step(state, batch), 1, warmup=0,
                        repeats=3)
    del state, batch
    torch.cuda.empty_cache()
    want_peak = row["peak_mem_gb_per_device"] * 1e9
    mem_rel = abs(peak - want_peak) / want_peak
    out = {"row_flops": row["flops_per_device"], "card_flops": flops,
           "row_peak_bytes": want_peak, "card_peak_bytes": peak,
           "peak_rel_diff": mem_rel,
           "row_peak_gib": want_peak / 2**30, "card_peak_gib": peak / 2**30,
           "roofline_seconds": row["roofline_seconds"],
           "bottleneck": row["bottleneck"],
           "step_ms": float(np.median(step_ms)),
           "step_ms_range": [min(step_ms), max(step_ms)], "loss": loss,
           "row_trace_s": row["trace_s"], "row_s": row_s,
           "row_mem": row["mem"], "hbm_gb": row["hbm_gb_total"]}
    log("dryrun_measured", arch=arch, seq=seq, batch=8, card=card_line(),
        **out)
    if flops != int(row["flops_per_device"]):
        raise AssertionError(f"18(a): the card's FLOPs {flops} != the "
                             f"row's {row['flops_per_device']}")
    if mem_rel > DRYRUN_MEM_TOL:
        raise AssertionError(f"18(a): peak {peak} B vs the row's "
                             f"{want_peak} B: {mem_rel:.3f} apart")
    if not math.isfinite(loss):
        raise AssertionError(f"18(a): loss {loss}")
    if any(launches.values()):
        raise AssertionError(f"18(a): the xla route launched {launches}")
    return launches


def dryrun_cell() -> dict:
    """18(b): one production cell through ``run_cell`` in a subprocess."""
    arch, (shape, mesh, step) = DRYRUN_ARCH, DRYRUN_CELL
    code = ("import json, sys\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'src')!r})\n"
            "from repro_torch.launch import dryrun\n"
            f"row = dryrun.run_cell({arch!r}, {shape!r}, {mesh!r}, "
            f"{step!r}, verbose=False)\n"
            "print(json.dumps(row, default=str))\n")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=DRYRUN_CELL_S, cwd=ROOT)
    seconds = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"18(b): exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    row = json.loads(proc.stdout.strip().splitlines()[-1])
    log("dryrun_cell", seconds=seconds, **row)
    if row["status"] != "ok" or row["chips"] != 512:
        raise AssertionError(f"18(b): {row['status']}, {row['chips']} chips")
    if not row["peak_mem_gb_per_device"] * 1e9 < 80 * 2**30:
        raise AssertionError(f"18(b): peak {row['peak_mem_gb_per_device']}"
                             " GB a device")
    return row


def dryrun_phase(dev) -> dict:
    """18(a)-(b); returns 18(a)'s launches by path (none)."""
    t = time.perf_counter()
    launches = dryrun_measured(dev)
    dryrun_cell()
    log("dryrun_phase", seconds=time.perf_counter() - t)
    return {"dryrun": launches}


def _record_steps(server) -> dict:
    """Wraps ``server``'s prefill and decode steps: each call's ms (CUDA
    events, synchronized at its end) and a copy of the logits it
    returns."""
    rec = {"prefill_ms": [], "decode_ms": [], "logits": []}

    def wrap(fn, key, at):
        def step(*args):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args)
            end.record()
            end.synchronize()
            rec[key].append(start.elapsed_time(end))
            rec["logits"].append(out[at].clone())
            return out
        return step

    server._prefill = wrap(server._prefill, "prefill_ms", 0)
    server._decode = wrap(server._decode, "decode_ms", 1)
    return rec


def profile_generate(server, prompts) -> dict:
    """A short ``generate`` (SERVE_PROFILE_NEW tokens: the profiler's
    bookkeeping of ~3,000 kernels a token is slow) timed by the host
    clock, then again under torch.profiler: kernels, device ms, device
    time by ``kernel_category`` and the busy share (the kernel intervals'
    union over the unprofiled wall time), or "not measured" when the
    trace holds no device time."""
    t = time.perf_counter()
    server.generate(prompts, SERVE_PROFILE_NEW)
    wall_s = time.perf_counter() - t
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        server.generate(prompts, SERVE_PROFILE_NEW)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_busy_share": "not measured"}
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    union_ms = _union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / 1e3
    return {"new_tokens": SERVE_PROFILE_NEW, "kernels": len(kernels),
            "wall_ms": wall_s * 1e3,
            "device_ms": sum(ms for ms, _ in by_name.values()),
            "device_busy_share": union_ms / (wall_s * 1e3),
            "by_category": by_category(by_name)}


def serve_fp32(dev, arch, merged, prompts, max_len) -> dict:
    """17(c): the merged model at dtype float32 through ``LMServer``; the
    logits of its SERVE_NEW tokens (the prefill's and every decode
    step's) against one forward without a cache over the prompt and the
    generated tokens.  Returns the launches."""
    cfg = dataclasses.replace(main_config(arch), dtype="float32")
    model = build_model(cfg)
    reset_launches()
    server = LMServer(model, merged, max_len=max_len, device=dev)
    rec = _record_steps(server)
    tokens = server.generate(prompts, SERVE_NEW)
    got = torch.stack(rec["logits"], dim=1)
    seq = torch.as_tensor(np.concatenate([prompts, tokens[:, :-1]], axis=1),
                          device=dev)
    with torch.inference_mode():
        want = model.apply(server.params, seq, remat="none")["logits"]
    check(f"serve_fp32:{arch}", got, want[:, prompts.shape[1] - 1:],
          SERVE_TOL)
    return read_launches()


def serve_path(dev, arch, merged) -> dict:
    """17(a)-(c) on one main path's merged params: an untimed generate, a
    timed one (host clock), a short one profiled, one with each step timed
    (CUDA events), the three full ones ``==``; the corpus-share gate
    against a fresh init; the fp32 identity.  Returns the launches by path (17(a)'s under
    ``serve:<arch>``)."""
    t0 = time.perf_counter()
    cfg = main_config(arch)
    seq = MAIN_PATHS[arch]["seq"]
    prompts = full_corpus(SERVE_BATCH, seq, cfg.vocab_size, 2
                          ).arrays["tokens"]
    max_len = seq + SERVE_NEW + 1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    server = LMServer(build_model(cfg), merged, max_len=max_len, device=dev)
    first = server.generate(prompts, SERVE_NEW)
    t = time.perf_counter()
    tokens = server.generate(prompts, SERVE_NEW)
    wall = time.perf_counter() - t
    profile = profile_generate(server, prompts)
    rec = _record_steps(server)
    again = server.generate(prompts, SERVE_NEW)
    by_path = {f"serve:{arch}": read_launches()}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not (np.array_equal(first, tokens) and np.array_equal(tokens, again)):
        raise AssertionError(f"serve {arch}: three generates differ")
    if tokens.shape != (SERVE_BATCH, SERVE_NEW) or not all(
            bool(torch.isfinite(lg).all()) for lg in rec["logits"]):
        raise AssertionError(f"serve {arch}: {tokens.shape} or non-finite "
                             f"logits")
    missing = [k for k in SERVE_KERNELS[arch]
               if by_path[f"serve:{arch}"][k] <= 0]
    if missing:
        raise AssertionError(f"serve {arch} never launched {missing}")
    prefill_ms, decode_ms = rec["prefill_ms"][0], rec["decode_ms"]
    del server, rec
    # (b) a fresh init of the same config, the same prompts
    ids = corpus_ids(cfg.vocab_size)
    reset_launches()
    model = build_model(cfg)
    fresh = LMServer(model, model.init(torch.Generator(dev).manual_seed(0),
                                       dev),
                     max_len=max_len, device=dev).generate(prompts,
                                                           SERVE_NEW)
    by_path[f"serve_init:{arch}"] = read_launches()
    torch.cuda.empty_cache()
    share, share_init = (float(np.isin(x, ids).mean())
                         for x in (tokens, fresh))
    per_token = float(np.median(decode_ms))
    log("serve", arch=cfg.name, layers=cfg.num_layers, batch=SERVE_BATCH,
        prompt=seq, new_tokens=SERVE_NEW, prefill_ms=prefill_ms,
        decode_ms_per_token=per_token,
        decode_ms_range=[min(decode_ms), max(decode_ms)],
        decode_tokens_per_s=SERVE_BATCH * 1e3 / per_token, generate_s=wall, tokens_per_s=SERVE_BATCH * SERVE_NEW / wall,
        peak_mem_gib=peak, profile=profile, corpus_share=share,
        corpus_share_init=share_init,
        gate=SERVE_GATE, sample=tokens[0][:8].tolist(),
        launches={k: v for k, v in by_path[f"serve:{arch}"].items() if v},
        card=card_line())
    if not share_init < SERVE_GATE < share:
        raise AssertionError(f"serve {arch}: corpus share {share} (trained) "
                             f"vs {share_init} (init) across {SERVE_GATE}")
    if arch in SERVE_FP32:
        by_path[f"serve_fp32:{arch}"] = serve_fp32(dev, arch, merged,
                                                   prompts, max_len)
        torch.cuda.empty_cache()
    log("serve_path", arch=cfg.name, seconds=time.perf_counter() - t0)
    return by_path


def serve_steps(model, params, tokens, prompt, dev) -> torch.Tensor:
    """Prefill on tokens[:, :prompt], then one decode step a token on the
    rest (teacher-forced): every call's logits, (B, 1 + S - prompt, V),
    on the CPU."""
    prefill = steps.make_prefill_step(model, RunConfig())
    decode = steps.make_decode_step(model, RunConfig())
    caches = TR.init_caches(model.cfg, tokens.shape[0], tokens.shape[1],
                            kv_dtype="float32", device=dev)
    toks = torch.as_tensor(tokens, device=dev)
    with torch.inference_mode():
        logits, caches = prefill(params, toks[:, :prompt], caches)
        out = [logits.clone()]
        for i in range(prompt, tokens.shape[1]):
            _, logits, caches = decode(params, caches, toks[:, i:i + 1], i)
            out.append(logits.clone())
    return torch.stack(out, dim=1).cpu()


def serve_smoke(dev) -> dict:
    """17(d): the smoke configs' prefill and teacher-forced decode steps on
    the card and on the CPU from one CPU-seeded init; the card's launches
    by path."""
    batch, prompt, last = SERVE_SMOKE_SHAPE
    cpu = torch.device("cpu")
    by_path = {}
    for arch in SERVE_SMOKE:
        cfg = registry.get_smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (batch, last)).astype(np.int32)
        reset_launches()
        card = serve_steps(model, tree_map(lambda t: t.to(dev), params),
                           tokens, prompt, dev)
        by_path[f"serve_smoke:{arch}"] = launches = read_launches()
        check(f"serve_smoke:{arch}", card,
              serve_steps(model, params, tokens, prompt, cpu), SERVE_TOL)
        kinds = {cfg.layer_kind(i)[0] for i in range(cfg.num_layers)}
        rows = (("flash_fwd_fp32",) if "attn" in kinds else ()) + (
            ("ssd_intra",) if "mamba" in kinds else ())
        missing = [name for name in rows if launches[name] <= 0]
        if missing:
            raise AssertionError(f"{arch} smoke serving never launched "
                                 f"{missing}")
    return by_path


def staticcheck_phase(host_lib) -> None:
    """Phase 19: the analyzer's record-only tier on the host build, and the
    card's attributes of every (kernel, threads, smem) it recorded."""
    t0 = time.perf_counter()
    lib = build.load()
    table = build.kernel_table(lib)
    optin = ctypes.c_int()
    build.check(lib, lib.rt_smem_optin(ctypes.byref(optin)), "smem optin")
    settings = AnalyzerSettings()
    launched = {}      # (kernel, threads, smem, attr) -> analyzer: in budget
    for cfg in kernel_configs.KERNEL_CONFIGS:
        if cfg.tier != "record":
            continue
        findings, launches, _ = analyze_config(host_lib, cfg, settings)
        other = [f for f in findings if f.rule not in BUDGET_RULES]
        if other:
            raise AssertionError(f"staticcheck {cfg.name}: " + "; ".join(
                f.format() for f in other))
        over = {f.detail.split("/")[0] for f in findings}
        for la in launches:
            key = (la.kernel, math.prod(la.block), la.smem, la.attr)
            launched[key] = la.kernel not in over
    for (kernel, threads, smem, attr), in_budget in sorted(launched.items()):
        if kernel not in table:
            raise AssertionError(f"staticcheck: {kernel} is in no kernel "
                                 "table of the sources")
        a = build.kernel_attrs(lib, table[kernel], threads, smem, attr)
        fits = a["static_smem"] + smem <= optin.value
        card_ok = (a["blocks_per_sm"] >= 1 and fits
                   and smem <= a["max_dyn_smem"]
                   and threads <= a["max_threads"])
        log("staticcheck_kernel", kernel=kernel, threads=threads,
            dyn_smem=smem, attr=attr, **a, fits_optin=fits,
            analyzer_in_budget=in_budget)
        if a["blocks_per_sm"] < 1 or not fits:
            raise AssertionError(f"staticcheck {kernel}: {a}, {smem} B "
                                 f"dynamic, opt-in limit {optin.value}")
        if card_ok != in_budget:
            raise AssertionError(f"staticcheck {kernel}: the analyzer says "
                                 f"{in_budget}, the card {card_ok} ({a})")
    log("staticcheck", seconds=time.perf_counter() - t0,
        launches=len(launched), kernels=len({k[0] for k in launched}),
        configs=sum(c.tier == "record" for c in kernel_configs.KERNEL_CONFIGS),
        smem_optin=optin.value, card=card_line())


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
    host_th, host_out = _in_thread(host_build.build_library)
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
    # granite-moe's server shapes: attention G 3, hd 64; its tied head
    gcfg = registry.get_config("granite-moe-3b-a800m")
    gseq = MAIN_PATHS[gcfg.name]["seq"]
    at_granite = fa_case(dev, 8, gseq, gcfg.num_kv_heads,
                         gcfg.num_heads // gcfg.num_kv_heads, gcfg.head_dim,
                         0, 0.0, torch.bfloat16, ITERS_ATTENTION,
                         library=True)
    at_granite.update(xent_case(dev, 8 * (gseq - 1), gcfg.d_model,
                                gcfg.vocab_size, 0.0, True, ITERS_XENT,
                                library=True))
    for name in ("flash_fwd", "flash_bwd_fused", "xent_fwd", "xent_bwd"):
        r = at_granite[name]
        bms, by = r.pop("bound")
        res[name]["at_granite_shape"] = dict(r, bound_ms=bms, bound_by=by)
    xent_case(dev, 4 * (SEQ_LEN - 1), cfg.d_model, cfg.vocab_size, 0.0,
              True, 1, library=False)
    g2 = registry.get_config("gemma2-2b")
    xent_case(dev, 1024, g2.d_model, g2.vocab_size, g2.final_softcap, True,
              1, library=False)
    res32 = xent_case(dev, T, cfg.d_model, cfg.vocab_size, 0.0, False, 1,
                      library=True, hdt=torch.float32)
    for name in XENT_BY_DTYPE:
        res[f"{name}_fp32"] = res32[name]
    del at_mamba2, at_granite, res32
    m2 = registry.get_config("mamba2-370m").mamba
    res.update(ssd_case(dev, 8, 8, m2.chunk_size, 32, m2.head_dim,
                        m2.d_state, ITERS_SSD, library=True))
    ssd_case(dev, 4, 8, m2.chunk_size, 16, m2.head_dim, 64, 1, library=False)
    ssd_case(dev, 2, 3, 16, 5, 16, 8, 1, library=False)
    torch.cuda.empty_cache()

    for arch in MAIN_PATHS:
        smoke_reference(dev, arch)
    by_path, hists = {}, {}
    t_serve = 0.0
    for arch in MAIN_PATHS:
        by_path[arch], hists[arch], merged = main_path(dev, arch)
        t = time.perf_counter()
        by_path.update(serve_path(dev, arch, merged))
        t_serve += time.perf_counter() - t
        del merged
        torch.cuda.empty_cache()
    t = time.perf_counter()
    by_path.update(serve_smoke(dev))
    log("serve_phase", seconds=t_serve + time.perf_counter() - t)
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
    by_path.update(fleet(dev))
    cut_paths, cut_card_hist = cuts_phase(dev)
    by_path.update(cut_paths)
    t = time.perf_counter()
    by_path.update(chaos_phase(dev, cut_card_hist))
    log("chaos_phase", seconds=time.perf_counter() - t)
    t = time.perf_counter()
    by_path.update(streaming_phase(dev))
    log("streaming_phase", seconds=time.perf_counter() - t)
    for arch in MAIN_PATHS:
        profile_step(dev, arch)
        torch.cuda.empty_cache()
    by_path["split_backward"] = split_backward(dev)
    by_path.update(moe_phase(dev))
    torch.cuda.empty_cache()
    by_path.update(dryrun_phase(dev))
    host_th.join(timeout=HOST_BUILD_S)
    if host_th.is_alive():
        raise AssertionError(f"host build: still running after "
                             f"{HOST_BUILD_S} s")
    if "error" in host_out:
        raise AssertionError(f"host build failed: {host_out['error']!r}") \
            from host_out["error"]
    staticcheck_phase(host_out["result"])

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
                                          "replaced_ms", "at_mamba2_shape",
                                          "at_granite_shape")
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
