"""The port's serving path (``repro_torch.launch.serve``, the prefill and
decode steps, the KV and Mamba caches) against ``repro``'s from the same
params (the JAX init, converted) and the same numpy tokens.

* The Mamba pieces: ``causal_conv1d(state=)`` (fp32 within 1e-5 of its
  scale, bf16 ``==``), ``ssd_chunked(h0=)`` through both impls with
  S % Q != 0 and ``ssd_decode_step``, within 1e-5 of each output's scale;
  the port twin of ``tests/test_kernels.py::
  test_ssd_chunked_matches_sequential_decode`` (1e-4), also from a
  non-zero state.
* Every LM of ``registry.ASSIGNED_ARCHS`` (smoke configs, batch 2, a
  prompt of 12, teacher-forced decode to 20): ``init_caches`` trees
  (paths, shapes, dtypes, zeros) ``==``; the prefill's logits and caches,
  then each decode step's, within 1e-4 of each leaf's scale of the
  reference's ``make_prefill_step`` / ``make_decode_step``, the port's
  ``impl="xla"`` against the reference's ``"xla"`` and ``"kernel"`` (the
  kernels' plain versions here) against ``"pallas"`` (interpret mode).
* The port twin of ``tests/test_models.py::
  test_prefill_decode_matches_full_forward`` (2e-4), through both impls.
* ``LMServer.generate`` tokens ``==`` the reference's on three smoke
  configs, each row compared up to its first step whose top-2 logit
  margin (the reference's, teacher-forced on its own tokens) is under
  ``TIE``.
* The command line prints the reference's JSON keys, and raises without
  a card unless asked for the CPU; a prefill on tensors that are not on
  the CPU reaches a kernel wrapper, which raises here.
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry
from repro.configs.base import RunConfig as JRun
from repro.core import steps as j_steps
from repro.launch import serve as j_serve
from repro.models import build_model as j_build
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import RunConfig as TRun
from repro_torch.core import steps as t_steps
from repro_torch.interop import from_numpy_tree, to_numpy_tree, tree_map
from repro_torch.launch import serve as t_serve
from repro_torch.models import build_model as t_build
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from repro_torch.models import transformer as TT

import torch_experiment_parity as P

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = registry.ASSIGNED_ARCHS
IMPLS = (("xla", "xla"), ("pallas", "kernel"))
B, S_PRE, S_MAX = 2, 12, 20
TOL = 1e-4
# the reference's own prefill/decode-vs-forward archs and tolerance
FULL_FORWARD_ARCHS = ("qwen3-1.7b", "gemma2-2b", "jamba-1.5-large-398b",
                      "mamba2-370m", "qwen2-vl-72b", "musicgen-large")
FULL_FORWARD_TOL = 2e-4
SERVER_ARCHS = ("qwen3-1.7b", "mamba2-370m", "jamba-1.5-large-398b")
SERVER_BATCH, SERVER_PROMPT, SERVER_NEW = 4, 16, 16
# a greedy token is compared only while the reference's top-2 margin is
# at least this (fp32 logits of order 1; the packages differ by ~1e-6)
TIE = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x {scale}"


def _close_trees(got, want, tol, what):
    g = jax.tree_util.tree_flatten_with_path(got)[0]
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, tol, f"{what} {jax.tree_util.keystr(path)}")


def _numpy_copy(tree):
    """Host copies of a tree of tensors (the caches are written in place
    by later steps)."""
    return tree_map(np.copy, to_numpy_tree(tree))


# ---------------------------------------------------------------------------
# The Mamba pieces
# ---------------------------------------------------------------------------


def _conv_inputs(S, W=4, C=6):
    rng = np.random.default_rng(3)
    return (rng.normal(0, 0.5, (W, C)).astype(np.float32),
            rng.normal(0, 0.1, (C,)).astype(np.float32),
            rng.normal(0, 1, (2, S, C)).astype(np.float32),
            rng.normal(0, 1, (2, W - 1, C)).astype(np.float32))


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 5])
def test_causal_conv1d_streaming_matches_jax(S, cd):
    w, b, x, state = _conv_inputs(S)
    jy, jstate = JL.causal_conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  jnp.asarray(x), cd,
                                  state=jnp.asarray(state))
    ty, tstate = TL.causal_conv1d({"w": torch.tensor(w), "b": torch.tensor(b)},
                                  torch.tensor(x), cd,
                                  state=torch.tensor(state))
    assert ty.dtype == tstate.dtype == TL.dt(cd)
    assert tstate.shape == state.shape
    for got, want, what in ((ty, jy, "y"), (tstate, jstate, "state")):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        if cd == "bfloat16":
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            _close(got, want, 1e-5, what)


def _ssd_inputs(S=20, H=2, P_=4, N=8, h0=True):
    rng = np.random.default_rng(4)
    arrays = (rng.normal(0, 1, (B, S, H, P_)),
              np.abs(rng.normal(0, 0.2, (B, S, H))),
              -np.abs(rng.normal(1, 0.3, (H,))),
              rng.normal(0, 1, (B, S, N)),
              rng.normal(0, 1, (B, S, N)),
              rng.normal(0, 1, (B, H, P_, N)) if h0 else None)
    return tuple(None if a is None else a.astype(np.float32) for a in arrays)


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_ssd_chunked_from_a_state_matches_jax(jimpl, timpl):
    """S 20 over chunks of 8: a padded last chunk."""
    *args, h0 = _ssd_inputs()
    jy, jh = JM.ssd_chunked(*map(jnp.asarray, args), 8, h0=jnp.asarray(h0),
                            impl=jimpl)
    ty, th = TM.ssd_chunked(*map(torch.tensor, args), 8,
                            h0=torch.tensor(h0), impl=timpl)
    _close(ty.numpy(), jy, 1e-5, "y")
    _close(th.numpy(), jh, 1e-5, "h_final")


def test_ssd_decode_step_matches_jax():
    xh, dt, A, Bm, Cm, h = _ssd_inputs(S=1)
    args = (xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h)
    jy, jh = JM.ssd_decode_step(*map(jnp.asarray, args))
    ty, th = TM.ssd_decode_step(*map(torch.tensor, args))
    _close(ty.numpy(), jy, 1e-5, "y")
    _close(th.numpy(), jh, 1e-5, "h_new")


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("from_state", [False, True])
def test_ssd_chunked_matches_sequential_decode(impl, from_state):
    """Chunked SSD == the step-by-step recurrence (the duality itself),
    from zero as the reference's test and from a given state."""
    xh, dt, A, Bm, Cm, h0 = map(
        lambda a: None if a is None else torch.tensor(a),
        _ssd_inputs(h0=from_state))
    y_chunk, h_final = TM.ssd_chunked(xh, dt, A, Bm, Cm, chunk=8, h0=h0,
                                      impl=impl)
    h = torch.zeros_like(h_final) if h0 is None else h0
    ys = []
    for t in range(xh.shape[1]):
        y_t, h = TM.ssd_decode_step(xh[:, t], dt[:, t], A, Bm[:, t],
                                    Cm[:, t], h)
        ys.append(y_t)
    np.testing.assert_allclose(y_chunk.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_final.numpy(), h.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Every LM's prefill and decode steps against the reference's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = registry.get_smoke_config(arch)
    params = j_build(cfg).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S_MAX)).astype(np.int32)
    return jax.tree.map(np.asarray, params), toks


@functools.lru_cache(maxsize=None)
def _jax_serve(arch, impl):
    """The reference's prefill on toks[:, :S_PRE], then one decode step a
    token to S_MAX on the same tokens: (logits, caches) after each call."""
    cfg = registry.get_smoke_config(arch)
    model = j_build(cfg)
    params, toks = _setup(arch)
    params = jax.tree.map(jnp.asarray, params)
    prefill = jax.jit(j_steps.make_prefill_step(model, JRun(), impl=impl))
    decode = jax.jit(j_steps.make_decode_step(model, JRun(), impl=impl,
                                              scan=False))
    caches = JT.init_caches(cfg, B, S_MAX, kv_dtype="float32")
    logits, caches = prefill(params, jnp.asarray(toks[:, :S_PRE]), caches)
    out = [(np.asarray(logits), jax.tree.map(np.asarray, caches))]
    for t in range(S_PRE, S_MAX):
        _, logits, caches = decode(params, caches,
                                   jnp.asarray(toks[:, t:t + 1]),
                                   jnp.asarray(t, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return out


def _torch_serve(arch, impl):
    cfg = t_registry.get_smoke_config(arch)
    model = t_build(cfg)
    params, toks = _setup(arch)
    params = from_numpy_tree(params)
    prefill = t_steps.make_prefill_step(model, TRun(), impl=impl)
    decode = t_steps.make_decode_step(model, TRun(), impl=impl)
    caches = TT.init_caches(cfg, B, S_MAX, kv_dtype="float32")
    with torch.inference_mode():
        logits, caches = prefill(params, torch.tensor(toks[:, :S_PRE]),
                                 caches)
        out = [(logits.numpy().copy(), _numpy_copy(caches))]
        for t in range(S_PRE, S_MAX):
            nxt, logits, caches = decode(params, caches,
                                         torch.tensor(toks[:, t:t + 1]), t)
            assert torch.equal(nxt, torch.argmax(logits, dim=-1))
            out.append((logits.numpy().copy(), _numpy_copy(caches)))
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_jax(arch, kv_dtype):
    jc = jax.tree.map(np.asarray, JT.init_caches(
        registry.get_smoke_config(arch), 3, 7, kv_dtype=kv_dtype))
    tc = to_numpy_tree(TT.init_caches(t_registry.get_smoke_config(arch), 3,
                                      7, kv_dtype=kv_dtype))
    jl = jax.tree_util.tree_flatten_with_path(jc)[0]
    tl = jax.tree_util.tree_flatten_with_path(tc)[0]
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        assert (a.shape, a.dtype.name) == (b.shape, b.dtype.name), path
        assert not a.any(), path


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch, jimpl, timpl):
    want = _jax_serve(arch, jimpl)
    got = _torch_serve(arch, timpl)
    assert len(got) == len(want) == 1 + S_MAX - S_PRE
    for i, ((tl, tc), (jl, jc)) in enumerate(zip(got, want)):
        what = "prefill" if i == 0 else f"decode {S_PRE + i - 1}"
        _close(tl, jl, TOL, f"{what} logits")
        _close_trees(tc, jc, TOL, f"{what} caches")


@pytest.mark.parametrize("impl", ["xla", "kernel"])
@pytest.mark.parametrize("arch", FULL_FORWARD_ARCHS)
def test_prefill_decode_matches_full_forward(arch, impl):
    cfg = t_registry.get_smoke_config(arch)
    m = t_build(cfg)
    params, toks = _setup(arch)
    params = from_numpy_tree(params)
    toks = torch.tensor(toks)
    with torch.inference_mode():
        caches = TT.init_caches(cfg, B, S_MAX, kv_dtype="float32")
        pre = m.apply(params, toks[:, :S_PRE], caches=caches, cache_index=0,
                      remat="none", impl=impl)
        assert pre["caches"] is caches
        decoded = [pre["logits"][:, -1]]
        for t in range(S_PRE, S_MAX):
            st = m.apply(params, toks[:, t:t + 1], caches=caches,
                         cache_index=t, remat="none", impl=impl)
            decoded.append(st["logits"][:, 0])
        dec = torch.stack(decoded, dim=1).numpy()
        full = m.apply(params, toks, remat="none", impl=impl)["logits"]
    np.testing.assert_allclose(dec, full[:, S_PRE - 1:].numpy(),
                               rtol=FULL_FORWARD_TOL, atol=FULL_FORWARD_TOL)


# ---------------------------------------------------------------------------
# LMServer and the command line
# ---------------------------------------------------------------------------


def _margins(jserver, prompts, tokens):
    """The reference's top-2 logit margin at each generated position,
    teacher-forced on its own tokens: (B, new_tokens)."""
    Bn, S0 = prompts.shape
    caches = JT.init_caches(jserver.cfg, Bn, jserver.max_len,
                            kv_dtype="float32")
    logits, caches = jserver._prefill(jserver.params, jnp.asarray(prompts),
                                      caches)
    out = [np.asarray(logits)]
    for i in range(tokens.shape[1] - 1):
        _, logits, caches = jserver._decode(
            jserver.params, caches, jnp.asarray(tokens[:, i:i + 1]),
            jnp.asarray(S0 + i, jnp.int32))
        out.append(np.asarray(logits))
    top2 = np.sort(np.stack(out, axis=1), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("arch", SERVER_ARCHS)
def test_lm_server_generates_the_reference_tokens(arch):
    params, _ = _setup(arch)
    max_len = SERVER_PROMPT + SERVER_NEW + 1
    prompts = np.random.default_rng(2).integers(
        0, registry.get_smoke_config(arch).vocab_size,
        (SERVER_BATCH, SERVER_PROMPT), dtype=np.int32)
    jserver = j_serve.LMServer(j_build(registry.get_smoke_config(arch)),
                               jax.tree.map(jnp.asarray, params),
                               max_len=max_len)
    want = jserver.generate(prompts, SERVER_NEW)
    tserver = t_serve.LMServer(t_build(t_registry.get_smoke_config(arch)),
                               from_numpy_tree(params), max_len=max_len,
                               device="cpu")
    got = tserver.generate(prompts, SERVER_NEW)
    assert got.shape == want.shape == (SERVER_BATCH, SERVER_NEW)
    assert got.dtype == np.int32
    margins = _margins(jserver, prompts, want)
    compared = 0
    for row in range(SERVER_BATCH):
        ties = np.flatnonzero(margins[row] < TIE)
        upto = ties[0] if ties.size else SERVER_NEW
        np.testing.assert_array_equal(got[row, :upto], want[row, :upto],
                                      err_msg=f"row {row}")
        compared += upto
    # the guard must leave most of the tokens compared
    assert compared >= SERVER_BATCH * SERVER_NEW * 3 // 4, margins


def test_serve_cli_prints_the_reference_keys(capsys):
    assert j_serve.main(["--arch", "qwen3-1.7b"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "qwen3-1.7b"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    for key in ("arch", "batch", "generated_shape"):
        assert got[key] == want[key]
    assert got["tokens_per_s"] > 0 and len(got["sample"]) == 8


def test_serve_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.main(["--arch", "qwen3-1.7b"])
    model = t_build(t_registry.get_smoke_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_serve.LMServer(model, {})


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-370m"])
def test_prefill_off_the_cpu_reaches_the_kernel_or_raises(arch):
    """On tensors that are not on the CPU (``meta`` here) the prefill
    reaches the attention or SSD kernel's wrapper, which launches or
    raises: no plain-version fallback."""
    cfg = t_registry.get_smoke_config(arch)
    model = t_build(cfg)
    params = model.init(torch.Generator(), "meta")
    caches = TT.init_caches(cfg, B, S_MAX, kv_dtype="float32",
                            device="meta")
    tokens = torch.zeros((B, S_PRE), dtype=torch.int32, device="meta")
    prefill = t_steps.make_prefill_step(model, TRun())
    with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
        prefill(params, tokens, caches)
