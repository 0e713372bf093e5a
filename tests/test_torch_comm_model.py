"""The port's byte and time accounting against ``repro.core.comm_model``.

Every count must be equal (``==``), not close: sizes are Python ints from
shapes and dtypes, and the times are float64 formed in the reference's
order, so a difference means the order (or a shape) differs.  The port
sizes its trees on PyTorch's ``meta`` device, so the full configs (up to
123B parameters) are priced without allocating them.  Also the port's
twins of the LM cases of ``tests/test_comm_model.py``.
"""

import dataclasses

import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.base import SplitConfig as JSplit
from repro.core import comm_model as J
from repro.models import build_model as j_build
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import SplitConfig as TSplit
from repro_torch.core import comm_model as T
from repro_torch.interop import tree_leaves
from repro_torch.models import build_model as t_build

# every registry LM arch the port builds
ARCHS = ["qwen3-1.7b", "gemma2-2b", "qwen1.5-4b", "mistral-large-123b",
         "mamba2-370m", "musicgen-large", "qwen2-vl-72b"]
ALGOS = ["fedavg", "splitfed", "splitfed_mb", "splitfedv2", "pipar",
         "scaffold", "splitgp", "ampere"]
SEQ = 64


def _models(arch, smoke):
    if smoke:
        return (j_build(j_registry.get_smoke_config(arch)),
                t_build(t_registry.get_smoke_config(arch)))
    return (j_build(j_registry.get_config(arch)),
            t_build(t_registry.get_config(arch)))


def _cuts(L, smoke):
    return range(1, L) if smoke else sorted({1, L // 2, L - 1})


def _check_cut(jm, tm_, p, seq):
    js = J.split_sizes(jm, JSplit(split_point=p), seq_len=seq)
    ts = T.split_sizes(tm_, TSplit(split_point=p), seq_len=seq)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js), p
    jt, tt = J.TimeModel(), T.TimeModel()
    for algo in ALGOS:
        kw = dict(epochs=7, n_samples=1000, device_epochs=5)
        assert T.comm_volume(algo, ts, **kw) == J.comm_volume(algo, js, **kw)
        assert T.comm_volume(algo, ts, act_compress=0.25, **kw) == \
            J.comm_volume(algo, js, act_compress=0.25, **kw)
        rk = dict(epochs=7, iters_per_epoch=13, device_epochs=5)
        assert T.comm_rounds(algo, **rk) == J.comm_rounds(algo, **rk)
        assert T.device_flops_per_sample(
            tm_, TSplit(split_point=p), algo, seq_len=seq, sizes=ts) == \
            J.device_flops_per_sample(jm, JSplit(split_point=p), algo,
                                      seq_len=seq, sizes=js)
        ek = dict(n_samples=1000, batch_size=16, seq_len=seq)
        assert T.epoch_time(algo, tm_, TSplit(split_point=p), tt, sizes=ts,
                            **ek) == \
            J.epoch_time(algo, jm, JSplit(split_point=p), jt, sizes=js, **ek)
        assert T.epoch_time_parts(algo, tm_, TSplit(split_point=p), tt,
                                  sizes=ts, **ek) == \
            J.epoch_time_parts(algo, jm, JSplit(split_point=p), jt,
                               sizes=js, **ek)
    assert T.ampere_server_epoch_time(
        tm_, TSplit(split_point=p), tt, n_samples=1000, seq_len=seq,
        sizes=ts) == J.ampere_server_epoch_time(
        jm, JSplit(split_point=p), jt, n_samples=1000, seq_len=seq,
        sizes=js)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_every_cut_equals_reference(arch):
    """Every field of ``split_sizes`` (``per_layer`` included), the
    volumes, rounds, device FLOPs and epoch times of every algorithm, at
    every valid cut of the smoke config."""
    jm, tm_ = _models(arch, smoke=True)
    for p in _cuts(jm.cfg.num_layers, smoke=True):
        _check_cut(jm, tm_, p, SEQ)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_cuts_equal_reference(arch):
    """Cuts {1, L/2, L-1} of the full published config, sized on
    ``meta``."""
    jm, tm_ = _models(arch, smoke=False)
    for p in _cuts(jm.cfg.num_layers, smoke=False):
        _check_cut(jm, tm_, p, 512)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_allocate_nothing(arch):
    """Every leaf of the full config's abstract tree lies on ``meta``, and
    its bytes are the reference's ``eval_shape`` bytes."""
    jm, tm_ = _models(arch, smoke=False)
    leaves = tree_leaves(T.abstract_params(tm_))
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert T.tree_bytes(T.abstract_params(tm_)) == \
        J.tree_bytes(J.abstract_params(jm))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-2b", "mamba2-370m"])
def test_cut_frontier_equals_reference(arch):
    jm, tm_ = _models(arch, smoke=True)
    for algo in ("ampere", "splitfed", "pipar"):
        kw = dict(algo=algo, n_samples=500, batch_size=8, seq_len=SEQ,
                  device_epochs=3, upload_samples=700)
        assert T.cut_frontier(tm_, TSplit(), **kw) == \
            J.cut_frontier(jm, JSplit(), **kw)
    cache = {}
    T.cut_frontier(tm_, TSplit(), n_samples=10, batch_size=2, seq_len=SEQ,
                   sizes_by_cut=cache)
    assert sorted(cache) == list(range(1, tm_.cfg.num_layers))


def test_model_specs_are_meta():
    _, tm_ = _models("qwen3-1.7b", smoke=True)
    x = tm_.input_spec(4, 32)
    a = tm_.activation_spec(4, 32, split_point=1, dtype="float32")
    assert x.device.type == a.device.type == "meta"
    assert tuple(x.shape) == (4, 32) and x.dtype == torch.int32
    assert tuple(a.shape) == (4, 32, tm_.cfg.d_model)
    assert a.dtype == torch.float32
    assert tm_.activation_spec(1, 8).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# twins of the LM cases of tests/test_comm_model.py
# ---------------------------------------------------------------------------

LM_ARCHS = ["qwen3-1.7b", "gemma2-2b", "mamba2-370m"]


def _sizes(arch, p=1):
    m = t_build(t_registry.get_smoke_config(arch))
    return T.split_sizes(m, TSplit(split_point=p), seq_len=64)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_ampere_cheaper_than_sfl(arch):
    sizes = _sizes(arch)
    for n_epochs in (1, 10, 150):
        c_sfl = T.comm_volume("splitfed", sizes, epochs=n_epochs,
                              n_samples=10000)
        c_amp = T.comm_volume("ampere", sizes, epochs=n_epochs,
                              n_samples=10000, device_epochs=n_epochs)
        assert c_amp < c_sfl


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_eq31_sign_predicate(arch):
    """Eq. 31: C_FL - C_Ampere = 2N (s^(s) - s^(aux)) - s^(act)."""
    sizes = _sizes(arch)
    for n in (1, 3, 100):
        c_fl = T.comm_volume("fedavg", sizes, epochs=n, n_samples=5000)
        c_amp = T.comm_volume("ampere", sizes, epochs=n, n_samples=5000,
                              device_epochs=n)
        expect = 2 * n * (sizes.server - sizes.aux) - \
            sizes.act_per_sample * 5000
        assert abs((c_fl - c_amp) - expect) <= 1


def test_eq5_structure():
    """C = 2N * sum(s_l, i<=p) + s_p^o: the model term is linear in N,
    the activation term constant."""
    sizes = _sizes("qwen3-1.7b")
    act = sizes.act_per_sample * 1000
    c10 = T.comm_volume("ampere", sizes, epochs=10, n_samples=1000,
                        device_epochs=10)
    c20 = T.comm_volume("ampere", sizes, epochs=20, n_samples=1000,
                        device_epochs=20)
    assert c20 - act == 2 * (c10 - act)


@pytest.mark.parametrize("epochs,iters", [(1, 1), (3, 17), (150, 1000),
                                          (300, 7)])
def test_round_counts(epochs, iters):
    r_fl = T.comm_rounds("fedavg", epochs=epochs, iters_per_epoch=iters)
    r_sfl = T.comm_rounds("splitfed", epochs=epochs, iters_per_epoch=iters)
    r_amp = T.comm_rounds("ampere", epochs=epochs, iters_per_epoch=iters,
                          device_epochs=epochs)
    assert r_amp == 2 * epochs + 1
    assert r_fl == 2 * epochs
    assert r_sfl == 2 * epochs * (1 + iters)
    assert r_amp <= r_sfl


def test_activation_quantization_reduces_one_shot_term():
    sizes = _sizes("qwen3-1.7b")
    kw = dict(epochs=10, n_samples=10000, device_epochs=10)
    assert T.comm_volume("ampere", sizes, act_compress=0.25, **kw) < \
        T.comm_volume("ampere", sizes, **kw)


def test_split_point_monotonicity_uit():
    """Paper Fig. 6 via Eq. 5: the model-exchange term and the on-device
    compute both grow with the cut."""
    m = t_build(t_registry.get_smoke_config("gemma2-2b"))
    model_terms, comps = [], []
    for p in range(1, m.cfg.num_layers):
        sc = TSplit(split_point=p)
        sizes = T.split_sizes(m, sc, seq_len=64)
        model_terms.append(sizes.device + sizes.aux)
        comps.append(T.device_flops_per_sample(m, sc, "ampere", seq_len=64))
    assert model_terms == sorted(model_terms)
    assert comps == sorted(comps)
    assert model_terms[0] < model_terms[-1]


def test_unknown_algo_and_vision_raise():
    """Unknown algorithms raise.  (The name is kept from when a vision
    arch raised here too; the vision branch is now held to the reference
    by ``test_vision_split_sizes_equal_reference``.)"""
    sizes = _sizes("qwen3-1.7b")
    with pytest.raises(ValueError, match="unknown algo"):
        T.comm_volume("nope", sizes, epochs=1, n_samples=1)
    with pytest.raises(ValueError, match="unknown algo"):
        T.comm_rounds("nope", epochs=1, iters_per_epoch=1)


@pytest.mark.parametrize("arch", ["vit-s", "mobilenet-l"])
def test_vision_split_sizes_equal_reference(arch):
    """The vision branch of split_sizes (was: it raised for a vision
    arch): every cut of the smoke config, one label of 4 bytes a sample."""
    jm = j_build(j_registry.get_smoke_config(arch))
    tm = t_build(t_registry.get_smoke_config(arch))
    for p in range(1, tm.num_layers):
        j = J.split_sizes(jm, JSplit(split_point=p), seq_len=1)
        t = T.split_sizes(tm, TSplit(split_point=p), seq_len=1)
        assert t == T.SplitSizes(**dataclasses.asdict(j)), p
        assert t.embed == 0
