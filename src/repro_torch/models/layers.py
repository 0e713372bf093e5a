"""Core parameterized layers, functional like ``repro.models.layers``:
``init_*`` builds a param dict of tensors, the apply functions consume it.
Compute dtype and param dtype are decoupled (mixed precision).
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int32": torch.int32,
    "int64": torch.int64,
    "int8": torch.int8,
}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def cast(x, dtype_name: str):
    return x.to(dt(dtype_name))


# ---------------------------------------------------------------------------
# Initializers (same shapes and laws as the JAX package; the numbers differ
# because torch.Generator is not jax.random — parity tests convert JAX params)
# ---------------------------------------------------------------------------


def normal_init(gen, shape, std=0.02, dtype="float32", device="cpu"):
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dt(dtype))


def zeros_init(shape, dtype="float32", device="cpu"):
    return torch.zeros(shape, dtype=dt(dtype), device=device)


def ones_init(shape, dtype="float32", device="cpu"):
    return torch.ones(shape, dtype=dt(dtype), device=device)


def init_dense(gen, in_dim: int, out_dim: int, bias: bool = False,
               param_dtype="float32", device="cpu", lead=()):
    """``lead``: leading stack dims (period-stacked layers)."""
    std = 1.0 / math.sqrt(in_dim)
    p = {"w": normal_init(gen, tuple(lead) + (in_dim, out_dim), std,
                          param_dtype, device)}
    if bias:
        p["b"] = zeros_init(tuple(lead) + (out_dim,), param_dtype, device)
    return p


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

_state = threading.local()


def grad_comm_dtype_active():
    return getattr(_state, "grad_comm", None)


@contextlib.contextmanager
def grad_comm_dtype(dtype_name):
    """While active, weight-gradient matmuls emit their result in
    ``dtype_name`` (accumulation stays fp32); None/empty = off."""
    prev = grad_comm_dtype_active()
    _state.grad_comm = dtype_name or None
    try:
        yield
    finally:
        _state.grad_comm = prev


class _MMLowGrad(torch.autograd.Function):
    """``x @ w`` whose weight gradient is accumulated in fp32 and emitted
    in ``grad_dtype`` (``repro.models.layers._mm_lowgrad``)."""

    @staticmethod
    def forward(ctx, x, w, grad_dtype):
        ctx.save_for_backward(x, w)
        ctx.grad_dtype = grad_dtype
        return x @ w

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        dx = (ct @ w.t()).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1]).float()
        ct2 = ct.reshape(-1, ct.shape[-1]).float()
        dw = (x2.t() @ ct2).to(dt(ctx.grad_dtype))
        return dx, dw, None


def dense(p, x, compute_dtype="bfloat16"):
    w = cast(p["w"], compute_dtype)
    xc = cast(x, compute_dtype)
    gd = grad_comm_dtype_active()
    if gd and p["w"].dtype == dt(gd):
        y = _MMLowGrad.apply(xc, w, gd)
    else:
        y = xc @ w
    if "b" in p:
        y = y + cast(p["b"], compute_dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, param_dtype="float32", device="cpu", lead=()):
    return {"scale": ones_init(tuple(lead) + (dim,), param_dtype, device)}


def rmsnorm(p, x, eps: float = 1e-6, compute_dtype="bfloat16",
            scale_offset: float = 0.0):
    """RMSNorm computed in fp32 (mixed-precision safe)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * (p["scale"].float() + scale_offset)
    return y.to(dt(compute_dtype))


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def init_embedding(gen, vocab: int, dim: int, param_dtype="float32",
                   device="cpu"):
    return {"table": normal_init(gen, (vocab, dim), 1.0 / math.sqrt(dim),
                                 param_dtype, device)}


def embed(p, tokens, compute_dtype="bfloat16", multiplier: float = 1.0):
    y = p["table"][tokens.long()].to(dt(compute_dtype))
    if multiplier != 1.0:
        y = y * torch.tensor(multiplier, dtype=dt(compute_dtype),
                             device=y.device)
    return y


def unembed(p, x, compute_dtype="bfloat16"):
    """Tied head: logits = x @ table.T"""
    return cast(x, compute_dtype) @ cast(p["table"], compute_dtype).t()


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float):
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / head_dim))


def apply_rope(x, positions, theta: float = 10000.0, mrope_sections=()):
    """Rotate pairs (x[..., :half], x[..., half:]).

    x: (B, S, H, hd).  positions: (B, S) int for standard RoPE, or
    (3, B, S) for M-RoPE, whose frequency axis is partitioned into
    ``mrope_sections`` (t, h, w) blocks, each indexed by its own stream.
    """
    half = x.shape[-1] // 2
    freqs = torch.from_numpy(rope_frequencies(x.shape[-1], theta)).to(x.device)
    if mrope_sections:
        if positions.dim() != 3:
            raise ValueError("M-RoPE expects positions of shape (3,B,S)")
        sections = list(mrope_sections)
        if sum(sections) != half:
            raise ValueError(f"mrope sections {sections} do not sum to {half}")
        sec_id = np.concatenate([np.full((s,), i) for i, s in enumerate(sections)])
        pos_sel = positions[torch.from_numpy(sec_id).to(positions.device)]
        angle = torch.einsum("hbs,h->bsh", pos_sel.float(), freqs)
    else:
        if positions.dim() == 3:  # collapse degenerate mrope positions
            positions = positions[0]
        angle = positions.float()[..., None] * freqs  # (B, S, half)
    cos = torch.cos(angle)[..., None, :]  # (B, S, 1, half)
    sin = torch.sin(angle)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------


def softcap(x, cap: float):
    """tanh soft-capping (gemma2): cap * tanh(x / cap)."""
    if not cap:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


def activation_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "geglu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]
