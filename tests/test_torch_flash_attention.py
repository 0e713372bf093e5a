"""Port flash attention against the JAX package.

``repro_torch.kernels.flash_attention.ops.flash_attention`` runs the
kernels' plain versions on CPU tensors; it is held, forward and grad, to
``repro.kernels.flash_attention.ops.flash_attention`` (the Pallas kernels in
interpret mode) on every ``FA_CASES`` row of ``tests/test_kernels.py``,
with ``bwd_strategy="fused"`` and ``"split"`` on both sides, and each
plain version is held to the port's quadratic oracle.  Tolerances are the reference's (tests/test_kernels.py):
2e-5 forward and 1e-4 grad in fp32, 2e-2 in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import attention_ref

FA_CASES = [
    # B, S, Skv, Hkv, G, hd, causal, window, softcap, dtype
    (2, 32, 32, 2, 2, 16, True, 0, 0.0, "float32"),
    (1, 48, 48, 2, 1, 32, True, 0, 0.0, "float32"),    # MHA
    (2, 32, 32, 1, 4, 16, True, 16, 0.0, "float32"),   # MQA + window
    (2, 32, 32, 2, 2, 16, True, 0, 30.0, "float32"),   # softcap
    (1, 40, 40, 2, 2, 16, True, 8, 50.0, "float32"),   # padding + both
    (2, 32, 32, 2, 2, 16, False, 0, 0.0, "float32"),   # bidirectional
    (2, 32, 32, 2, 2, 16, True, 0, 0.0, "bfloat16"),   # low precision
    (2, 20, 20, 2, 2, 16, True, 8, 30.0, "float32"),   # odd S + both
    (1, 24, 40, 2, 2, 16, True, 12, 25.0, "float32"),  # Skv != S + both
    (1, 40, 24, 2, 1, 16, True, 0, 40.0, "float32"),   # Skv < S + softcap
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case):
    B, S, Skv, Hkv, G, hd = case[:6]
    rng = np.random.default_rng(sum(case[:6]) + int(case[8]))
    q = rng.normal(0, 1, (B, S, Hkv, G, hd)).astype(np.float32)
    k = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (B, Skv, Hkv, hd)).astype(np.float32)
    return q, k, v, 1.0 / np.sqrt(hd)


def _tol(dtype):
    return (2e-2, 2e-2) if dtype == "bfloat16" else (2e-5, 1e-4)


def _f32(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else
                      jnp.asarray(x, jnp.float32))


def _check_against_jax(case, strategy):
    causal, window, cap, dtype = case[6:]
    q, k, v, scale = _inputs(case)
    fwd_tol, grad_tol = _tol(dtype)

    jq, jk, jv = (jnp.asarray(a, jnp.dtype(dtype)) for a in (q, k, v))

    def jf(q, k, v):
        o = jfa.flash_attention(q, k, v, causal, window, cap, scale, 16, 16,
                                strategy)
        return jnp.sum(jnp.sin(o.astype(jnp.float32))), o

    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)

    tq, tk, tv = (torch.tensor(a).to(TORCH_DT[dtype]).requires_grad_(True)
                  for a in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal, window, cap, scale, 16, 16,
                             strategy)
    assert to.dtype == TORCH_DT[dtype]        # output keeps the input dtype
    tg = torch.autograd.grad(torch.sum(torch.sin(to.float())), (tq, tk, tv))

    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=fwd_tol, atol=fwd_tol)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=grad_tol,
                                   atol=grad_tol, err_msg=f"d{name}")


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_jax(case):
    _check_against_jax(case, "fused")


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_split_backward_matches_jax(case):
    """The two-sweep backward (flash_bwd_dq, then flash_bwd_dkv) against
    JAX ``bwd_strategy="split"``."""
    _check_against_jax(case, "split")


@pytest.mark.parametrize("case", FA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_versions_match_oracle(case):
    """flash_fwd_plain / flash_bwd_fused_plain in the kernel layout against
    the port's quadratic oracle and its autograd (fp32, 2e-5 / 1e-4)."""
    B, S, Skv, Hkv, G, hd, causal, window, cap, _ = case
    q, k, v, scale = (torch.tensor(a) if isinstance(a, np.ndarray) else a
                      for a in _inputs(case))
    kw = dict(group=G, causal=causal, window=window, softcap=cap, scale=scale,
              kv_len=Skv)
    qk = q.permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, hd)
    kk = k.permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)
    vk = v.permute(0, 2, 1, 3).reshape(B * Hkv, Skv, hd)

    o, lse = K.flash_fwd_plain(qk, kk, vk, **kw)
    q_, k_, v_ = (t.clone().requires_grad_(True) for t in (q, k, v))
    o_ref, lse_ref = attention_ref(q_, k_, v_, causal=causal, window=window,
                                   softcap=cap, scale=scale)
    o_ref_k = o_ref.permute(0, 2, 3, 1, 4).reshape(B * Hkv * G, S, hd)
    lse_ref_k = lse_ref.permute(0, 2, 3, 1).reshape(B * Hkv * G, S)
    np.testing.assert_allclose(o.numpy(), o_ref_k.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref_k.detach().numpy(),
                               rtol=2e-5, atol=2e-5)

    do = torch.tensor(np.random.default_rng(1).normal(0, 1, o.shape),
                      dtype=torch.float32)
    delta = torch.sum(do * o, dim=-1)
    dq, dk, dv = K.flash_bwd_fused_plain(qk, kk, vk, do, lse, delta, **kw)
    do5 = do.reshape(B, Hkv, G, S, hd).permute(0, 3, 1, 2, 4)
    gq, gk, gv = torch.autograd.grad(torch.sum(o_ref * do5), (q_, k_, v_))
    pairs = ((dq, gq.permute(0, 2, 3, 1, 4).reshape(dq.shape)),
             (dk, gk.permute(0, 2, 1, 3).reshape(dk.shape)),
             (dv, gv.permute(0, 2, 1, 3).reshape(dv.shape)))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
    # the split sweeps' plain versions compute the same gradients
    dq_s = K.flash_bwd_dq_plain(qk, kk, vk, do, lse, delta, **kw)
    dk_s, dv_s = K.flash_bwd_dkv_plain(qk, kk, vk, do, lse, delta, **kw)
    for a, (b, _) in zip((dq_s, dk_s, dv_s), pairs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_unknown_bwd_strategy_raises():
    q = torch.zeros((1, 16, 1, 1, 16))
    k = torch.zeros((1, 16, 1, 16))
    with pytest.raises(ValueError, match="bwd_strategy"):
        tfa.flash_attention(q, k, k, bwd_strategy="fuzed")


@pytest.mark.parametrize("fn", ["chunked_attention", "dot_attention"])
@pytest.mark.parametrize("q_offset,kv_valid_len,window", [(0, None, 0),
                                                          (5, 30, 8)])
def test_eager_attention_matches_jax(fn, q_offset, kv_valid_len, window):
    """The eager counterparts: chunked online softmax (``"xla"``) and the
    quadratic decode-path attention, with an offset query block and a
    padded cache; fp32 2e-5."""
    from repro.models import attention as JAt
    from repro_torch.models import attention as TAt

    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (2, 12, 2, 2, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, 40, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, 40, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=20.0, scale=0.25,
              q_offset=q_offset, kv_valid_len=kv_valid_len)
    if fn == "chunked_attention":
        kw["kv_block"] = 16
    want = getattr(JAt, fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **kw)
    got = getattr(TAt, fn)(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                           **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
