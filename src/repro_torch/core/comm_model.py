"""Analytic communication/computation cost model (paper §4.2, Eqs. 5,
27-31) and the wall-time simulator, as ``repro.core.comm_model``.

Every byte count is exact: sizes come from a parameter tree initialized
on PyTorch's ``meta`` device (shapes and dtypes, no storage), where the
reference uses ``jax.eval_shape``, so the model prices a 123B-parameter
config without allocating it.  Counts are Python ints and times Python
floats, computed in the reference's order, so both packages give the
same numbers bit for bit.  The hardware constants are the paper's
testbed (Jetson Nano devices, 50 Mbps device-server links, an A6000
server).  A vision model counts one "token" a sample, and its
activations' shape comes from running layers [0, p) on ``meta``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import auxiliary, splitting
from repro_torch.interop import tree_leaves

# Paper testbed constants
DEVICE_GFLOPS = 236.0        # Jetson Nano fp16 ~ 472 GFLOPS peak; ~50% util
SERVER_GFLOPS = 75_000.0     # A6000 tensor-core sustained
BANDWIDTH_BPS = 50e6 / 8.0   # 50 Mbps -> bytes/s
DTYPE_BYTES = 4              # paper transfers fp32


def tree_bytes(tree) -> int:
    return int(sum(math.prod(t.shape) * t.element_size()
                   for t in tree_leaves(tree)))


def abstract_params(model):
    """The model's parameter tree on ``meta``: shapes and dtypes only."""
    # staticcheck: ok=unseeded-rng meta tensors: nothing is drawn
    return model.init(torch.Generator(), "meta")


def _tokens(model, seq_len: int) -> int:
    """Tokens a sample: the sequence for an LM, 1 for a classifier."""
    return seq_len if model.kind == "lm" else 1


@dataclasses.dataclass(frozen=True)
class SplitSizes:
    """Byte sizes for a split at p (the s^(d) / s^(aux) / s^(s) / s^(act)
    of Table 2), plus per-layer parameter sizes for the split-point sweep."""
    device: int              # s^(d)  — device block params (incl. embedding)
    aux: int                 # s^(aux)
    server: int              # s^(s)
    act_per_sample: int      # activation bytes for ONE sample
    per_layer: tuple         # parameter bytes of each layer
    head: int                # output head + final norm bytes (server side)
    embed: int               # embedding bytes (device side, LM only)


def split_sizes(model, split_cfg, *, seq_len: int = 0,
                act_dtype_bytes: Optional[int] = None) -> SplitSizes:
    p = split_cfg.split_point
    params = abstract_params(model)
    dev, srv = model.split_params(params, p)
    # staticcheck: ok=unseeded-rng meta tensors: nothing is drawn
    aux = auxiliary.init_aux(model, torch.Generator(), split_cfg, "meta")
    cfg = model.cfg
    # one sample's activations at the cut, shipped at ``ab`` bytes an
    # element, and its labels (the tokens, or one int32 class)
    acts = model.activation_spec(1, seq_len, split_point=p, dtype="float32")
    ab = act_dtype_bytes or DTYPE_BYTES
    if model.kind == "lm":
        P = cfg.pattern_period
        per_layer = [tree_bytes(splitting.loose_layer(params["blocks"], i, P))
                     for i in range(cfg.num_layers)]
        embed = tree_bytes(params["embed"])
        head = tree_bytes({k: params[k] for k in ("final_norm", "head")
                           if k in params})
        labels = model.input_spec(1, seq_len)
        act = acts.numel() * ab + labels.numel() * labels.element_size()
    else:
        per_layer = [tree_bytes(lp) for lp in params["layers"]]
        embed = 0
        head = tree_bytes(params["head"])
        act = acts.numel() * ab + 4
    return SplitSizes(
        device=tree_bytes(dev), aux=tree_bytes(aux), server=tree_bytes(srv),
        act_per_sample=act, per_layer=tuple(per_layer), head=head,
        embed=embed)


# ---------------------------------------------------------------------------
# Communication volume per algorithm (per device, over training) — Eqs 27-31
# ---------------------------------------------------------------------------


def comm_volume(algo: str, sizes: SplitSizes, *, epochs: int,
                n_samples: int, device_epochs: Optional[int] = None,
                server_epochs: Optional[int] = None,
                act_compress: float = 1.0) -> int:
    """Total device<->server bytes for one device.

    ``epochs`` = N for iterative algorithms; Ampere uses
    ``device_epochs`` (N^(d)) for model exchanges and sends activations
    once.  ``act_compress`` < 1 models activation quantization.
    """
    s_act_total = int(sizes.act_per_sample * n_samples * act_compress)
    if algo == "fedavg":
        s_full = sizes.device + sizes.server
        return 2 * epochs * s_full
    if algo in ("splitfed", "splitfed_mb", "splitfedv2", "pipar"):
        return 2 * epochs * (sizes.device + s_act_total)
    if algo == "scaffold":
        # control variates double the model exchange
        return 2 * epochs * (2 * sizes.device + s_act_total)
    if algo == "splitgp":
        # device also carries (and exchanges) a personal head ~ aux-sized
        return 2 * epochs * (sizes.device + sizes.aux + s_act_total)
    if algo == "ampere":
        nd = device_epochs if device_epochs is not None else epochs
        return 2 * nd * (sizes.device + sizes.aux) + s_act_total
    raise ValueError(f"unknown algo {algo!r}")


def comm_rounds(algo: str, *, epochs: int, iters_per_epoch: int,
                device_epochs: Optional[int] = None) -> int:
    """Transfer events per device (Table 1 semantics: every model /
    activation-batch / gradient-batch transfer is one round)."""
    if algo == "fedavg":
        return 2 * epochs
    if algo in ("splitfed", "splitfed_mb", "splitfedv2", "pipar", "scaffold",
                "splitgp"):
        return 2 * epochs + 2 * epochs * iters_per_epoch
    if algo == "ampere":
        nd = device_epochs if device_epochs is not None else epochs
        return 2 * nd + 1
    raise ValueError(f"unknown algo {algo!r}")


# ---------------------------------------------------------------------------
# On-device computation (Fig. 9) and wall-time (Fig. 8) models
# ---------------------------------------------------------------------------


def device_flops_per_sample(model, split_cfg, algo: str, *,
                            seq_len: int = 0,
                            sizes: Optional[SplitSizes] = None) -> float:
    """Training FLOPs executed ON THE DEVICE per sample (fwd+bwd ~ 3x fwd):
    6 * params_on_device per token."""
    sizes = sizes or split_sizes(model, split_cfg, seq_len=max(seq_len, 1))
    dev_params = sizes.device / 4            # fp32 bytes -> param count
    aux_params = sizes.aux / 4
    tokens = _tokens(model, seq_len)
    if algo == "fedavg":
        total = (sizes.device + sizes.server) / 4
        return 6.0 * total * tokens
    if algo in ("ampere", "splitgp"):
        return 6.0 * (dev_params + aux_params) * tokens
    # splitfed / pipar / scaffold: device block only
    return 6.0 * dev_params * tokens


@dataclasses.dataclass(frozen=True)
class TimeModel:
    device_gflops: float = DEVICE_GFLOPS
    server_gflops: float = SERVER_GFLOPS
    bandwidth: float = BANDWIDTH_BPS
    speed_factor: float = 1.0     # straggler group scaling


def _epoch_terms(algo, model, split_cfg, tm, n_samples, seq_len, sizes):
    """The reference's per-epoch terms, each formed in its order:
    (sizes, t_dev, t_srv, t_model_x, t_act, tokens)."""
    sizes = sizes or split_sizes(model, split_cfg, seq_len=max(seq_len, 1))
    fl_dev = device_flops_per_sample(model, split_cfg, algo, seq_len=seq_len,
                                     sizes=sizes)
    t_dev = fl_dev * n_samples / (tm.device_gflops * 1e9 * tm.speed_factor)
    srv_params = sizes.server / 4
    tokens = _tokens(model, seq_len)
    t_srv = 6.0 * srv_params * tokens * n_samples / (tm.server_gflops * 1e9)
    t_model_x = 2 * (sizes.device + (sizes.aux if algo in ("ampere", "splitgp")
                                     else 0)) / tm.bandwidth
    t_act = 2 * sizes.act_per_sample * n_samples / tm.bandwidth
    return sizes, t_dev, t_srv, t_model_x, t_act, tokens


def _fedavg_parts(sizes, tm, tokens, n_samples):
    t_full = 6.0 * (sizes.device + sizes.server) / 4 * tokens * n_samples \
        / (tm.device_gflops * 1e9 * tm.speed_factor)
    return t_full, 2 * (sizes.device + sizes.server) / tm.bandwidth


def epoch_time(algo: str, model, split_cfg, tm: TimeModel, *,
               n_samples: int, batch_size: int, seq_len: int = 0,
               sizes: Optional[SplitSizes] = None) -> float:
    """Simulated wall-clock seconds for ONE epoch on one device."""
    sizes, t_dev, t_srv, t_model_x, t_act, tokens = _epoch_terms(
        algo, model, split_cfg, tm, n_samples, seq_len, sizes)
    if algo == "fedavg":
        t_full, t_x = _fedavg_parts(sizes, tm, tokens, n_samples)
        return t_full + t_x
    if algo == "ampere":
        # device epoch: local compute + model exchange only
        return t_dev + t_model_x
    if algo == "pipar":
        # overlapped: per-iteration time ~ max of the two pipelines
        return max(t_dev + t_srv, t_act) + t_model_x
    # splitfed / scaffold / splitgp: strictly sequential per iteration
    extra = t_model_x if algo != "scaffold" else 2 * t_model_x
    return t_dev + t_srv + t_act + extra


def ampere_server_epoch_time(model, split_cfg, tm: TimeModel, *,
                             n_samples: int, seq_len: int = 0,
                             sizes: Optional[SplitSizes] = None) -> float:
    sizes = sizes or split_sizes(model, split_cfg, seq_len=max(seq_len, 1))
    tokens = _tokens(model, seq_len)
    return (6.0 * (sizes.server / 4) * tokens * n_samples
            / (tm.server_gflops * 1e9))


def epoch_time_parts(algo: str, model, split_cfg, tm: TimeModel, *,
                     n_samples: int, batch_size: int, seq_len: int = 0,
                     sizes: Optional[SplitSizes] = None):
    """(compute_s, comm_s) decomposition of :func:`epoch_time`, term by
    term (not by subtraction, so :func:`epoch_time` keeps its rounding)."""
    sizes, t_dev, t_srv, t_model_x, t_act, tokens = _epoch_terms(
        algo, model, split_cfg, tm, n_samples, seq_len, sizes)
    if algo == "fedavg":
        return _fedavg_parts(sizes, tm, tokens, n_samples)
    if algo == "ampere":
        return t_dev, t_model_x
    if algo == "pipar":
        return max(t_dev + t_srv, t_act), t_model_x
    extra = t_model_x if algo != "scaffold" else 2 * t_model_x
    return t_dev + t_srv, t_act + extra


# ---------------------------------------------------------------------------
# Cut-layer frontier sweep
# ---------------------------------------------------------------------------


def cut_frontier(model, split_cfg, *, cuts=None, algo: str = "ampere",
                 tm: Optional[TimeModel] = None, n_samples: int,
                 batch_size: int, seq_len: int = 0,
                 device_epochs: int = 1, upload_samples: Optional[int] = None,
                 sizes_by_cut: Optional[dict] = None):
    """Price each candidate cut ``p`` (default: every legal cut in
    ``[1, num_layers - 1]``): one row dict per cut with the block sizes,
    ``act_bytes_per_sample``, ``comm_bytes`` (:func:`comm_volume`),
    ``device_flops_per_sample``, and ``epoch_s`` / ``upload_s`` /
    ``total_s = device_epochs * epoch_s + upload_s``.

    ``upload_samples`` defaults to ``n_samples``; ``sizes_by_cut`` is an
    optional ``{p: SplitSizes}`` cache, filled in place.
    """
    tm = tm or TimeModel()
    cfg = model.cfg
    if cuts is None:
        cuts = range(1, cfg.num_layers)
    n_up = n_samples if upload_samples is None else upload_samples
    rows = []
    for p in cuts:
        sc = dataclasses.replace(split_cfg, split_point=int(p))
        sizes = None if sizes_by_cut is None else sizes_by_cut.get(int(p))
        if sizes is None:
            sizes = split_sizes(model, sc, seq_len=max(seq_len, 1))
            if sizes_by_cut is not None:
                sizes_by_cut[int(p)] = sizes
        e_t = epoch_time(algo, model, sc, tm, n_samples=n_samples,
                         batch_size=batch_size, seq_len=seq_len, sizes=sizes)
        if algo == "ampere":
            upload_s = sizes.act_per_sample * n_up / tm.bandwidth
        else:
            upload_s = 0.0  # iterative algos pay activations inside epoch_s
        rows.append({
            "split_point": int(p),
            "device_bytes": sizes.device,
            "aux_bytes": sizes.aux,
            "server_bytes": sizes.server,
            "act_bytes_per_sample": sizes.act_per_sample,
            "comm_bytes": comm_volume(
                algo, sizes, epochs=device_epochs, n_samples=n_up,
                device_epochs=device_epochs),
            "device_flops_per_sample": device_flops_per_sample(
                model, sc, algo, seq_len=seq_len, sizes=sizes),
            "epoch_s": e_t,
            "upload_s": upload_s,
            "total_s": device_epochs * e_t + upload_s,
        })
    return rows
