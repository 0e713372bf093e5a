"""Mixture-of-Experts with GShard-style capacity dispatch, as
``repro.models.moe``.

Positions within an expert come from an exclusive cumulative sum over the
routing one-hots of each sequence's token-major (S * k) choices; tokens
are scattered into a (B, E, C, D) buffer, the expert FFNs run as batched
products over the expert axis, and the results are gathered back and
combined with the renormalised top-k router weights.  A choice past its
expert's capacity C is dropped: its row is zeroed before the scatter
(into the clamped slot C - 1) and its combine weight is zero.  The batch
axis is the dispatch group (tokens compete for capacity only within their
own sequence).  The load-balancing loss is the reference's: E times the
sum over experts of the mean gate and the top-1 share, times
``router_aux_coef``.

The reference's ``shard(...)`` annotations are left out: they do nothing
on one device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import shard


def init_moe(gen, cfg, device="cpu", lead=()):
    D = cfg.d_model
    m = cfg.moe
    E, F_ = m.num_experts, m.d_expert
    pd = cfg.param_dtype
    lead = tuple(lead)
    std_in, std_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F_)
    p = {
        "router": {"w": L.normal_init(gen, lead + (D, E), std_in, pd, device)},
        "wg": L.normal_init(gen, lead + (E, D, F_), std_in, pd, device),
        "wi": L.normal_init(gen, lead + (E, D, F_), std_in, pd, device),
        "wo": L.normal_init(gen, lead + (E, F_, D), std_out, pd, device),
    }
    if m.num_shared_experts:
        Fs = m.d_shared * m.num_shared_experts
        kw = dict(param_dtype=pd, device=device, lead=lead)
        p["shared"] = {"wg": L.init_dense(gen, D, Fs, **kw),
                       "wi": L.init_dense(gen, D, Fs, **kw),
                       "wo": L.init_dense(gen, Fs, D, **kw)}
        p["shared_gate"] = {"w": L.normal_init(gen, lead + (D, 1), std_in, pd,
                                               device)}
    return p


def capacity(cfg, tokens_per_group: int) -> int:
    m = cfg.moe
    c = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(4, min(tokens_per_group, -(-c // 4) * 4))  # round up to 4


def route(cfg, p, x):
    """The fp32 router: (gates (B, S, E), top-k weights renormalised with
    the 1e-9 floor (B, S, k), top-k experts (B, S, k))."""
    logits = torch.einsum("bsd,de->bse", x.float(), p["router"]["w"].float())
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, cfg.moe.top_k, dim=-1)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    return gates, topw, topi


def slots(topi, num_experts: int, cap: int):
    """Each choice's (expert, clamped slot, kept) over the token-major
    (S * k) choices of each sequence, all (B, S * k)."""
    B = topi.shape[0]
    ch_e = topi.reshape(B, -1)
    onehot = F.one_hot(ch_e, num_experts)
    # exclusive cumsum of the one-hots, read at each choice's own expert
    pos = torch.cumsum(onehot, dim=1).gather(-1, ch_e[..., None])[..., 0] - 1
    return ch_e, torch.clamp(pos, max=cap - 1), pos < cap


def moe_mlp(cfg, p, x):
    """x: (B, S, D) -> (y, aux_loss). B is the dispatch group axis."""
    B, S, D = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, S)
    cd = L.dt(cfg.dtype)

    gates, topw, topi = route(cfg, p, x)
    me = gates.mean(dim=(0, 1))                             # mean gate
    pe = F.one_hot(topi[..., 0], E).float().mean(dim=(0, 1))  # top-1 share
    aux = E * torch.sum(me * pe) * m.router_aux_coef

    ch_e, pos_c, keep = slots(topi, E, C)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    x_ch = x.repeat_interleave(k, dim=1).to(cd)             # (B, S*k, D)
    x_ch = x_ch * keep[..., None].to(cd)
    buf = torch.zeros((B, E, C, D), dtype=cd, device=x.device).index_put(
        (b_idx, ch_e, pos_c), x_ch, accumulate=True)
    buf = shard(buf, "batch", "expert", None, None)

    act = L.activation_fn(cfg.mlp_activation)
    wg, wi, wo = (p[n].to(cd) for n in ("wg", "wi", "wo"))
    h = act(torch.einsum("becd,edf->becf", buf, wg).float()).to(cd)
    h = h * torch.einsum("becd,edf->becf", buf, wi)
    h = shard(h, "batch", "expert", None, None)
    y_buf = torch.einsum("becf,efd->becd", h, wo)
    y_buf = shard(y_buf, "batch", "expert", None, None)

    y_ch = y_buf[b_idx, ch_e, pos_c]                        # (B, S*k, D)
    w_ch = (topw.reshape(B, S * k) * keep).to(cd)
    y = torch.sum((y_ch * w_ch[..., None]).reshape(B, S, k, D), dim=2)

    if "shared" in p:
        sp = p["shared"]
        hs = act(L.dense(sp["wg"], x, cfg.dtype).float()).to(cd)
        hs = hs * L.dense(sp["wi"], x, cfg.dtype)
        ys = L.dense(sp["wo"], hs, cfg.dtype)
        g = torch.sigmoid(torch.einsum(
            "bsd,do->bso", x.float(), p["shared_gate"]["w"].float()))
        y = y + ys * g.to(cd)
    return y, aux
