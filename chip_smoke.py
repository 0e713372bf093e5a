#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  ``python3 chip_smoke.py`` from the repository root:

1. Card: name and power limit (nvidia-smi), torch and CUDA versions.
2. Build: every CUDA source under ``src/repro_torch/csrc`` into one sm_90a
   library (``build/repro_torch_kernels/``), timed.
3. Kernels: each of ``flash_fwd``, ``flash_bwd_fused``, ``xent_fwd`` and
   ``xent_bwd`` against its plain PyTorch version on the same inputs, at
   the main path's shapes (qwen3-1.7b: server batch 8 x 512 tokens, Hkv 8,
   G 2, hd 128, bf16; xent T = 8 x 511, D 2048, V 151936) and at a
   gemma2-style case (hd 256, window, softcaps 50 / 30); kernel, plain and
   library times with CUDA events.
4. Reference: the launcher's path on the qwen3-1.7b smoke config from the
   same initial states on the card (kernels) and on the CPU (plain
   versions); the histories must agree.
5. Main path: ``repro_torch.launch.train.run_training`` on full-width,
   full-depth qwen3-1.7b (random init from the seed), seq 512, 4 clients,
   cohort 2, H 2, device batch 4, 2 device rounds, server batch 8, one
   server epoch over 64 samples, 8 eval samples, lr 0.02; every kernel's
   launch count must be > 0, every loss finite, and the merged model's
   validation loss below ln V.

The corpus: ``make_lm_dataset`` builds an O(vocab^2) bigram table, which
cannot exist at V = 151936, so the main path samples the unchanged
generator at vocab 257 and maps the ids into [0, 151936) through a fixed
random injection drawn from the seed; model, head and xent still run over
the full vocabulary.

Tolerances: each kernel output within 1e-4 of its largest magnitude (fp32
accumulation in another order; dQ through atomics).

Prints one line per phase, then the kernels' JSON line, the card line and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA device or when any phase fails.
"""

from __future__ import annotations

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
from repro_torch.core.uit import AmpereTrainer  # noqa: E402
from repro_torch.data import (ActivationStore, Dataset, federate,  # noqa: E402
                              make_dataset_for_model, make_lm_dataset)
from repro_torch.interop import tree_map  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.xent import kernel as XK  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
KERNELS = {
    "flash_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention/kernel.py:104"),
    "flash_bwd_fused": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:407"),
    "xent_fwd": ("src/repro_torch/csrc/xent.cu",
                 "src/repro/kernels/xent/kernel.py:107"),
    "xent_bwd": ("src/repro_torch/csrc/xent.cu",
                 "src/repro/kernels/xent/kernel.py:242"),
}
WRAPPERS = {"flash_fwd": FK.flash_fwd, "flash_bwd_fused": FK.flash_bwd_fused,
            "xent_fwd": XK.xent_fwd, "xent_bwd": XK.xent_bwd}

# The main path's sizes.  LR: the launcher's default 0.2 (momentum 0.9)
# diverges on the random-init full-width server block within one epoch;
# at 0.02 the merged model trains below ln V (PERF.md, Findings).
SEQ_LEN = 512
TRAIN_SAMPLES = 64
EVAL_SAMPLES = 8
DEVICE_ROUNDS = 2
SERVER_EPOCHS = 1
LR = 0.02
ITERS_ATTENTION = 20     # timed calls per measurement
ITERS_XENT = 5


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}, default=float), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got, want, rel_tol: float) -> float:
    """Each output's max abs error must stay within rel_tol of that
    output's largest magnitude; returns the max abs error over outputs."""
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


def fa_case(dev, B, S, Hkv, G, hd, window, cap, dtype, iters, library):
    gen = torch.Generator(device=dev).manual_seed(0)
    BH, BKV = B * Hkv * G, B * Hkv
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
               for s in ((BH, S, hd), (BKV, S, hd), (BKV, S, hd)))
    kw = dict(group=G, causal=True, window=window, softcap=cap,
              scale=1 / math.sqrt(hd), kv_len=S)
    o, lse = FK.flash_fwd(q, k, v, **kw)
    o_p, lse_p = FK.flash_fwd_plain(q, k, v, **kw)
    tag = f"B{B} S{S} Hkv{Hkv} G{G} hd{hd} window{window} cap{cap}"
    fwd_err = check(f"flash_fwd {tag}", (o, lse), (o_p, lse_p), 1e-4)
    do = torch.randn(o.shape, generator=gen, device=dev)
    delta = torch.sum(do * o_p, dim=-1)
    got = FK.flash_bwd_fused(q, k, v, do, lse_p, delta, **kw)
    want = FK.flash_bwd_fused_plain(q, k, v, do, lse_p, delta, **kw)
    bwd_err = check(f"flash_bwd_fused {tag}", got, want, 1e-4)
    if not library:
        return None
    pairs = BH * _valid_pairs(S, S, True, window)
    isz = q.element_size()
    res = {}
    res["flash_fwd"] = dict(
        max_abs_err=fwd_err,
        ms=time_ms(lambda: FK.flash_fwd(q, k, v, **kw), iters),
        plain_ms=time_ms(lambda: FK.flash_fwd_plain(q, k, v, **kw), iters),
        bound=bound_ms((BH + 2 * BKV) * S * hd * isz + BH * S * (hd + 1) * 4,
                       4 * hd * pairs, dtype))
    res["flash_bwd_fused"] = dict(
        max_abs_err=bwd_err,
        ms=time_ms(lambda: FK.flash_bwd_fused(q, k, v, do, lse_p, delta, **kw),
                   iters),
        plain_ms=time_ms(lambda: FK.flash_bwd_fused_plain(
            q, k, v, do, lse_p, delta, **kw), iters),
        bound=bound_ms((BH + 2 * BKV) * S * hd * isz + BH * S * (hd + 2) * 4
                       + (BH + 2 * BKV) * S * hd * 4, 10 * hd * pairs, dtype))
    # yardstick only: one PyTorch call computing the same function
    q4 = q.reshape(B, Hkv * G, S, hd).requires_grad_(True)
    k4 = k.reshape(B, Hkv, S, hd).requires_grad_(True)
    v4 = v.reshape(B, Hkv, S, hd).requires_grad_(True)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def lib_fwd():
        return sdpa(q4, k4, v4, is_causal=True, scale=kw["scale"],
                    enable_gqa=True)

    with torch.no_grad():
        res["flash_fwd"]["library_ms"] = time_ms(lib_fwd, iters)
    out = lib_fwd()
    do4 = do.reshape(B, Hkv * G, S, hd).to(dtype)
    res["flash_bwd_fused"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True),
        iters)
    return res


def xent_case(dev, T, D, V, cap, tied, iters, library):
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((T, D), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((V, D) if tied else (D, V), generator=gen,
                    device=dev) / math.sqrt(D)
    w = w.t() if tied else w
    lab = torch.randint(0, V, (T,), generator=gen, device=dev,
                        dtype=torch.int32)
    loss, lse = XK.xent_fwd(h, w, lab, softcap=cap)
    loss_p, lse_p = XK.xent_fwd_plain(h, w, lab, softcap=cap)
    tag = f"T{T} D{D} V{V} cap{cap} tied{int(tied)}"
    fwd_err = check(f"xent_fwd {tag}", (loss, lse), (loss_p, lse_p), 1e-4)
    del loss_p
    g = torch.full((T,), 1.0 / T, device=dev)
    got = XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap)
    want = XK.xent_bwd_plain(h, w, lab, lse_p, g, softcap=cap)
    bwd_err = check(f"xent_bwd {tag}", got, want, 1e-4)
    del got, want
    if not library:
        return None
    ops = 2.0 * T * D * V
    in_bytes = T * D * 2 + D * V * 4 + T * 4
    res = {"xent_fwd": dict(
        max_abs_err=fwd_err,
        ms=time_ms(lambda: XK.xent_fwd(h, w, lab, softcap=cap), iters),
        plain_ms=time_ms(lambda: XK.xent_fwd_plain(h, w, lab, softcap=cap),
                         iters),
        bound=bound_ms(in_bytes + T * 8, ops, torch.float32))}
    res["xent_bwd"] = dict(
        max_abs_err=bwd_err,
        ms=time_ms(lambda: XK.xent_bwd(h, w, lab, lse_p, g, softcap=cap),
                   iters),
        plain_ms=time_ms(lambda: XK.xent_bwd_plain(h, w, lab, lse_p, g,
                                                   softcap=cap), iters),
        bound=bound_ms(in_bytes + T * 8 + T * D * 4 + D * V * 4, 3 * ops,
                       torch.float32))
    # yardstick only: fp32 logits + F.cross_entropy, and its autograd
    ce = torch.nn.functional.cross_entropy
    hl = h.detach().requires_grad_(True)
    wl = w.detach().requires_grad_(True)
    labl = lab.long()
    with torch.no_grad():
        res["xent_fwd"]["library_ms"] = time_ms(
            lambda: ce(hl.float() @ wl, labl, reduction="none"), iters)
    out = ce(hl.float() @ wl, labl)
    res["xent_bwd"]["library_ms"] = time_ms(
        lambda: torch.autograd.grad(out, (hl, wl), retain_graph=True), iters)
    return res


# ---------------------------------------------------------------------------
# Phases 4 and 5
# ---------------------------------------------------------------------------


def smoke_reference(dev):
    """The launcher's path on the qwen3-1.7b smoke config from the same
    initial states, on the card and on the CPU: histories agree."""
    cfg = registry.get_smoke_config("qwen3-1.7b")
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
                    raise AssertionError(f"smoke {phase} {key}: {a} vs {b}")
    log("reference", arch="qwen3-1.7b-smoke", cuda=hist["cuda"],
        cpu=hist["cpu"], rel_tol=1e-4)


def full_corpus(n, seq, vocab, seed):
    """The unchanged bigram generator at vocab 257, its ids mapped into
    [0, vocab) by a fixed injection drawn from ``seed``."""
    small = make_lm_dataset(n, seq_len=seq, vocab=257, seed=seed)
    inj = np.random.default_rng(1234).choice(vocab, size=257, replace=False)
    return Dataset({"tokens": inj[small.arrays["tokens"]].astype(np.int32)},
                   small.labels)


def main_path(dev):
    cfg = registry.get_config("qwen3-1.7b")
    argv = ["--arch", "qwen3-1.7b", "--clients", "4", "--cohort", "2",
            "--local-steps", "2", "--batch-size", "4", "--server-batch", "8",
            "--seq-len", str(SEQ_LEN), "--lr", str(LR), "--seed", "0"]
    largs = launch_train.make_parser().parse_args(argv)
    train = full_corpus(TRAIN_SAMPLES, SEQ_LEN, cfg.vocab_size, 0)
    evald = full_corpus(EVAL_SAMPLES, SEQ_LEN, cfg.vocab_size, 1)
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    out = launch_train.run_training(
        cfg, launch_train.build_run_cfg(largs), train, evald, device=dev,
        device_rounds=DEVICE_ROUNDS, server_epochs=SERVER_EPOCHS)
    launches = {name: fn.launches for name, fn in WRAPPERS.items()}
    hist = out["history"]
    log("main_path", arch=cfg.name, layers=cfg.num_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=SEQ_LEN, lr=LR,
        seconds=out["seconds"],
        peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        device=hist["device"], server=hist["server"], launches=launches)
    losses = [r[k] for ph in ("device", "server") for r in hist[ph]
              for k in ("loss", "val_loss")]
    if len(hist["device"]) != DEVICE_ROUNDS or \
            len(hist["server"]) != SERVER_EPOCHS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"main path history not finite/complete: {hist}")
    # random init sits above ln V; the merged model must have learned
    if not hist["server"][-1]["val_loss"] < math.log(cfg.vocab_size):
        raise AssertionError(f"merged model did not train below ln V: {hist}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    shapes = {k: tuple(v.shape) for k, v in
              out["merged_params"]["embed"].items()}
    if shapes != {"table": (cfg.vocab_size, cfg.d_model)}:
        raise AssertionError(f"merged params: unexpected {shapes}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0))
    t = time.perf_counter()
    path = build.build()
    log("build", seconds=time.perf_counter() - t, library=str(path))

    res = fa_case(dev, 8, SEQ_LEN, 8, 2, 128, 0, 0.0, torch.bfloat16,
                  ITERS_ATTENTION, library=True)
    fa_case(dev, 2, SEQ_LEN, 4, 2, 256, 256, 50.0, torch.bfloat16, 1,
            library=False)
    cfg = registry.get_config("qwen3-1.7b")
    T = 8 * (SEQ_LEN - 1)
    res.update(xent_case(dev, T, cfg.d_model, cfg.vocab_size, 0.0, False,
                         ITERS_XENT, library=True))
    xent_case(dev, 4 * (SEQ_LEN - 1), cfg.d_model, cfg.vocab_size, 0.0,
              True, 1, library=False)
    g2 = registry.get_config("gemma2-2b")
    xent_case(dev, 1024, g2.d_model, g2.vocab_size, g2.final_softcap, True,
              1, library=False)
    torch.cuda.empty_cache()

    smoke_reference(dev)
    launches = main_path(dev)

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = res[name]
        bms, by = r.pop("bound")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r.get("library_ms")})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
