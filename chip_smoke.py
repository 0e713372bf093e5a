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
   the main attention shape in fp32 (the CUDA-core instantiations that
   the split step's fp32 pass runs) and a small odd SSD case (the fused
   backward gets an fp32 dO, the split sweeps dO in q's dtype); xent on
   the tensor cores (bf16 h, fp32 w) at the qwen3 shape (untied), the
   tied auxiliary shape (T 2044), gemma2's softcap case (T 1024, V 256000)
   and the mamba2-370m server shape (T 16376, D 1024, V 50280, tied), and
   on the CUDA cores (fp32 h) at the qwen3 shape, each backward twice
   (bit-identical); the SSD backward on all three SSD cases, twice
   (bit-identical); kernel, plain and library times with CUDA events
   (median of ``REPEATS`` timings after ``WARMUP`` calls, their range
   beside it; SSD one timing), and for the SSD backward the route it
   replaced (autograd of the oracle ``ssd_intra_ref``, ``replaced_ms``).
   The build prints ptxas's registers, spills and static shared memory of
   the tensor-core xent kernels and the SSD backward kernels.
4. References: the launcher's path on the qwen3-1.7b and mamba2-370m smoke
   configs from the same initial states on the card (kernels) and on the
   CPU (plain versions); the histories must agree.
5. Main paths: ``repro_torch.launch.train.run_training`` on full-width,
   full-depth qwen3-1.7b (seq 512, lr 0.02) and mamba2-370m (seq 2048, so
   8 chunks of 256 per sequence, lr ``MAMBA_LR``), random init from the
   seed, 4 clients, cohort 2, H 2, device batch 4, 2 device rounds, server
   batch 8, one server epoch over 64 samples, 8 eval samples; each path's
   kernels must have launched, every loss be finite, and the merged
   model's validation loss end below ln V.
6. Profile: one server train step of each main path at its shape (8 x 512
   qwen3-1.7b, 8 x 2048 mamba2-370m) under ``torch.profiler`` after one
   untimed step and 3 steps timed without it (CUDA events): device time
   by kernel name (top 10), the xent and SSD kernels' shares, the device
   busy share (union of kernel intervals over the unprofiled step's median
   time; over the profiled step's wall time beside it), or "not
   measured" when the trace holds no device time, and the peak memory of
   the timed steps.
7. Split backward: one server train step of full-width, full-depth
   qwen3-1.7b (8 x 512) from the same state and batch through
   ``steps.make_server_train_step``, twice with ``impl="kernel"`` and
   twice with ``impl="kernel:split"``, in fp32 and in the config's bf16
   compute: the losses agree, in fp32 every gradient agrees within 1e-4
   of its scale, in bf16 split differs from fused by at most 3x as much
   as fused from itself, the two split runs give bit-identical gradients,
   and every attention kernel launched in both dtypes.

The corpus: ``make_lm_dataset`` builds an O(vocab^2) bigram table, which
cannot exist at V = 151936 or 50280, so the main paths sample the
unchanged generator at vocab 257 and map the ids into [0, V) through a
fixed random injection drawn from the seed; model, head and xent still run
over the full vocabulary.

Tolerances: each kernel output within 1e-4 of its largest magnitude (fp32
accumulation in another order; dQ through atomics in the fused backward).

Prints one line per phase (the last, "total", the script's wall
seconds), then the kernels' JSON line (``launches`` the
sum over the three path runs of 5 and 7, ``launches_by_path`` each run's
count; the attention and xent rows are the bf16 tensor-core kernels,
``*_fp32`` the fp32 CUDA-core ones behind the same wrappers, counted by
dtype; the xent rows add their bf16 pass count, the fp32-FMA bound for
comparison and their times at the mamba2 shape), the card line and,
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
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import splitting, steps  # noqa: E402
from repro_torch.core.uit import AmpereTrainer  # noqa: E402
from repro_torch.data import (ActivationStore, Dataset, federate,  # noqa: E402
                              make_dataset_for_model, make_lm_dataset)
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
TRAIN_SAMPLES = 64
EVAL_SAMPLES = 8
DEVICE_ROUNDS = 2
SERVER_EPOCHS = 1
ITERS_ATTENTION = 20     # timed calls per measurement
REPEATS = 5              # attention: measurements per time, median kept
WARMUP = 3               # attention: untimed calls before them
ITERS_XENT = 2
ITERS_SSD = 10
# kernels whose ptxas report the build phase prints: the xent tensor-core
# kernels, the split pre-pass and the SSD backward
PTXAS_REPORT = ("xent_tc_", "xent_split_", "ssd_bwd_")
PROFILE_TOP = 10         # kernels named in each profile line
PROFILE_STEPS = 3        # unprofiled steps timed before the profiled one
# bf16 split backward: allowed difference from fused, in multiples of the
# fused kernel's run-to-run spread (its dQ atomics) measured in the same run
BF16_SPREAD = 3.0


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
        errs[name] = check(f"{name} {tag}", fn(*bargs, **kw),
                           plain(*bargs, **kw), 1e-4)
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
                                    "library_ms_range")}
           for name, r in res.items()})
    return res


def xent_bound(T, D, V, hdt, backward):
    """(bound ms, by, bf16 passes or None, fp32-FMA bound ms) for an fp32 w:
    bytes of h, w, labels (+ lse, g, dh, dw in the backward) read or
    written once; the tensor-core route (bf16 h) runs the fewest bf16
    passes that carry the fp32 operands to 1e-4 (forward 2, backward
    2 + 3 + 2; a bf16 w would need 1 and 1 + 2 + 2), the CUDA-core route
    one fp32 product per contraction."""
    ops = 2.0 * T * D * V
    nbytes = (T * D * (4 if hdt == torch.float32 else 2) + D * V * 4
              + T * 4 + T * 8)       # + loss, lse out / lse, g in
    if backward:
        nbytes += T * D * 4 + D * V * 4
    fma = bound_ms(nbytes, (3 if backward else 1) * ops, torch.float32)
    if hdt == torch.float32:
        return (*fma, None, fma[0])
    passes = 7 if backward else 2
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
    err = check(f"ssd_intra {tag}", SK.ssd_intra_kernel(*args),
                SK.ssd_intra_plain(*args), 1e-4)
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
    BC, pairs = B * nc, Q * (Q + 1) // 2
    # C.B^T once per (b, chunk) over the causal pairs; per head the weights
    # (3 ops a pair) and the (pairs x P) product; the state: B * w and the
    # (P, Q) x (Q, N) product
    flops = BC * (2 * pairs * N + H * (3 * pairs + 2 * pairs * P)
                  + H * (Q * N + 2 * Q * P * N))
    nbytes = 4 * BC * (2 * Q * H * P + 2 * Q * H + 2 * Q * N + H * P * N)
    # backward: per (b, chunk) C.B^T again and dC, dB against dCB (2 N a
    # pair each); per head dA and A^T dy (2 P a pair each), the weights
    # (L, G, A, E, their sums and dCB's: 10 ops a pair), U = B dS^T and
    # (w x)^T dS (2 Q P N each) and Z (2 Q P)
    bwd_flops = BC * (6 * pairs * N + H * (4 * pairs * P + 10 * pairs
                                           + 4 * Q * P * N + 2 * Q * P))
    # x, dy, dx; dS; dt, a_cum, ddt, da_cum; B, C, dB, dC
    bwd_bytes = 4 * BC * (3 * Q * H * P + H * P * N + 4 * Q * H + 4 * Q * N)
    leaves = [t.detach().requires_grad_(True) for t in args]

    def replaced():
        with torch.enable_grad():
            return torch.autograd.grad(SR.ssd_intra_ref(*leaves), leaves,
                                       (dy, ds))

    res = {"ssd_intra": dict(
        max_abs_err=err,
        ms=time_ms(lambda: SK.ssd_intra_kernel(*args), iters),
        plain_ms=time_ms(lambda: SK.ssd_intra_plain(*args), iters),
        bound=bound_ms(nbytes, flops, torch.float32),
        library_ms=None)}
    res["ssd_intra_bwd"] = dict(
        max_abs_err=bwd_err,
        ms=time_ms(lambda: SK.ssd_intra_bwd_kernel(*args, dy, ds), iters),
        plain_ms=time_ms(lambda: SK.ssd_intra_bwd_plain(*args, dy, ds),
                         iters),
        replaced_ms=time_ms(replaced, iters),
        bound=bound_ms(bwd_bytes, bwd_flops, torch.float32),
        library_ms=None)
    log("timing", case=tag, iters=iters,
        **{name: {k: v for k, v in r.items() if k != "max_abs_err"}
           for name, r in res.items()})
    return res


# ---------------------------------------------------------------------------
# Phases 4, 5 and 6
# ---------------------------------------------------------------------------


def smoke_reference(dev, arch):
    """The launcher's path on ``arch``'s smoke config from the same initial
    states, on the card and on the CPU: histories agree."""
    cfg = registry.get_smoke_config(arch)
    args = launch_train.make_parser().parse_args(
        ["--clients", "4", "--cohort", "2", "--local-steps", "2",
         "--batch-size", "4", "--server-batch", "8"])
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


def main_path(dev, arch):
    spec = MAIN_PATHS[arch]
    seq, lr = spec["seq"], spec["lr"]
    cfg = registry.get_config(arch)
    argv = ["--arch", arch, "--clients", "4", "--cohort", "2",
            "--local-steps", "2", "--batch-size", "4", "--server-batch", "8",
            "--seq-len", str(seq), "--lr", str(lr), "--seed", "0"]
    largs = launch_train.make_parser().parse_args(argv)
    train = full_corpus(TRAIN_SAMPLES, seq, cfg.vocab_size, 0)
    evald = full_corpus(EVAL_SAMPLES, seq, cfg.vocab_size, 1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    out = launch_train.run_training(
        cfg, launch_train.build_run_cfg(largs), train, evald, device=dev,
        device_rounds=DEVICE_ROUNDS, server_epochs=SERVER_EPOCHS)
    launches = read_launches()
    hist = out["history"]
    log("main_path", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=seq, lr=lr,
        seconds=out["seconds"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        device=hist["device"], server=hist["server"], launches=launches)
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
    return launches


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
    """One server train step under torch.profiler, after one untimed step
    and PROFILE_STEPS steps timed without the profiler (CUDA events; the
    profiler's CPU tracing slows the host's ~10^4 launches a step, so its
    wall time overstates the step): device time by kernel name (the
    PROFILE_TOP largest), the xent and SSD kernels' shares, the device
    busy share, the union of kernel intervals over the unprofiled step's
    median time (kernel durations do not depend on the host), with the
    share over the profiled step's wall time beside it, and the peak
    memory of the timed steps."""
    model, run_cfg, srv, batch = server_step_inputs(dev, arch)
    step = steps.make_server_train_step(model, run_cfg, impl="kernel")
    state = steps.init_server_state(model, run_cfg, srv)
    del srv
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = []
    for _ in range(PROFILE_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, _ = step(state, batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    step_ms_med = float(np.median(step_ms))
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
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
        log("profile", arch=arch, wall_s=wall, loss=loss,
            step_ms=step_ms_med, step_ms_range=[min(step_ms), max(step_ms)],
            peak_mem_gib=peak_gib, device_time="not measured",
            device_busy_share="not measured")
        return
    union_ms = _union_us([(e.time_range.start, e.time_range.end)
                          for e in kernels]) / 1e3
    xent_ms = sum(ms for name, (ms, _) in by_name.items() if "xent" in name)
    ssd_ms = sum(ms for name, (ms, _) in by_name.items() if "ssd_" in name)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:PROFILE_TOP]
    log("profile", arch=arch, seq=MAIN_PATHS[arch]["seq"], batch=8,
        step_ms=step_ms_med, step_ms_range=[min(step_ms), max(step_ms)],
        wall_s=wall, loss=loss, peak_mem_gib=peak_gib, device_ms=device_ms,
        device_union_ms=union_ms,
        device_busy_share=union_ms / step_ms_med,
        device_busy_share_profiled=union_ms / 1e3 / wall,
        kernels=len(kernels), xent_ms=xent_ms,
        xent_share_of_step=xent_ms / step_ms_med, ssd_ms=ssd_ms,
        ssd_share_of_step=ssd_ms / step_ms_med,
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

    In fp32 compute the split gradients must match the fused ones within
    1e-4 of each leaf's scale.  In the config's bf16 compute a last-bit
    difference in dQ (the fused kernel's atomics) flips bf16 roundings
    that 27 layers of backward carry into every gradient, so there split
    against fused must stay within ``BF16_SPREAD`` times fused against
    itself in the same run.  In both, two split steps must give
    bit-identical gradients."""
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
        del g_f, g_s, g_f2
        result[dtype] = dict(
            loss_fused=l_f, loss_split=l_s, split_vs_fused=rel,
            split_vs_fused_leaf=leaf, split_bit_identical=split_same,
            fused_vs_fused=fused_rel, fused_vs_fused_leaf=fused_leaf)
        if not split_same:
            raise AssertionError(f"{dtype}: split backward grads differ "
                                 "between two runs")
        if not abs(l_s - l_f) <= 1e-5 * abs(l_f):
            raise AssertionError(f"{dtype}: split loss {l_s} vs fused {l_f}")
    launches = read_launches()
    log("split_backward", arch=arch, seq=seq, batch=8, rel_tol=1e-4,
        launches=launches, **result)
    if not result["float32"]["split_vs_fused"] <= 1e-4:
        raise AssertionError(f"split grads differ from fused: {result}")
    if cfg.dtype != "float32":
        r = result[cfg.dtype]
        if not r["split_vs_fused"] <= BF16_SPREAD * r["fused_vs_fused"]:
            raise AssertionError(f"{cfg.dtype} split grads differ from fused "
                                 f"beyond {BF16_SPREAD}x fused's own spread:"
                                 f" {r}")
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))
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
    # the fp32 CUDA-core instantiations at the main shape (the split
    # step's fp32 pass)
    res32 = fa_case(dev, 8, SEQ_LEN, 8, 2, 128, 0, 0.0, torch.float32,
                    ITERS_ATTENTION, library=True)
    for name in FA_BY_DTYPE:
        res[f"{name}_fp32"] = res32[name]
    # xent: the server heads of both main paths (qwen3 untied, T 8 x 511;
    # mamba2 tied, T 8 x 2047), the tied auxiliary head (T 4 x 511),
    # gemma2's softcap, and the CUDA-core route (fp32 h) at the qwen3 shape
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
    by_path = {arch: main_path(dev, arch) for arch in MAIN_PATHS}
    torch.cuda.empty_cache()
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
