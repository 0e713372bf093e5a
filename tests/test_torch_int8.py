"""int8 activation payloads in the port against the reference:
``repro.runtime.compression``, the store's int8 shards and the int8 run
of ``run_experiment``.

* The store's int8 quantizer and ``dequantize_int8`` bit-identical to
  the reference's ``quantize_int8`` / ``dequantize_int8`` (absmax / 127
  a row, floor 1e-12, round half to even), on rows with ties at .5, zero
  rows and large magnitudes.
* A stored int8 shard's arrays and ``shard_nbytes`` identical to the
  reference store's, with stored bytes = size + rows x 4 (+ labels).
* The server step dequantizes a batch that carries ``acts_scale``: equal
  (1e-5 relative) to the reference's step on the same batch.
* ``run_experiment`` with ``quantize_activations`` on the qwen3-1.7b
  smoke spec: histories within 1e-5 relative (losses), 1e-2 (accuracy),
  ``comm_bytes``, ``sim_time`` and the store's bytes ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_experiment_parity as P
from repro.core import steps as JSt
from repro.data import ActivationStore as JStore
from repro.runtime import compression as JC
from repro_torch.core import steps as TSt
from repro_torch.data import ActivationStore as TStore
from repro_torch.interop import from_numpy_tree
from repro_torch.runtime import compression as TC


def _rows(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 7.0
    x[0, 0] = 0.0                                  # scale floor
    x[0, 1] = np.arange(16) - 8.0                  # absmax 8: .5 ties
    x[1, 2] *= 1e6
    x[2, 3] = 127.0 * np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5] + [0.0] * 9
                               + [127.0])
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dequantize_bit_identical(seed):
    """The store's quantizer (numpy, where the payload is stored) and the
    step's dequantizer against ``repro.runtime.compression``."""
    x = _rows(seed)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    shard, _ = TStore.prepare_shard({"acts": x}, True)
    tq, ts = shard["acts"], shard["acts_scale"]
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tq, np.asarray(jq))
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert ts.shape == (3, 5, 1)
    np.testing.assert_array_equal(
        TC.dequantize_int8(torch.from_numpy(tq), torch.from_numpy(ts)).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))
    # round half to even: the .5 row quantizes to even integers
    assert tq[2, 3, :6].tolist() == [0, 2, 2, 0, -2, 4]


def _dequant(pool):
    return TC.dequantize_int8(torch.from_numpy(pool["acts"]),
                              torch.from_numpy(pool["acts_scale"])).numpy()


@pytest.mark.parametrize("labels", ["tokens", "labels"])
def test_int8_shard_and_bytes_identical(labels, tmp_path):
    rng = np.random.default_rng(5)
    shards = []
    for i in range(3):
        acts = rng.normal(size=(4, 6, 16)) if labels == "tokens" \
            else rng.normal(size=(4, 3, 3, 16))
        lab = (rng.integers(0, 99, (4, 6)) if labels == "tokens"
               else rng.integers(0, 10, (4,))).astype(np.int32)
        shards.append({"acts": acts.astype(np.float32), labels: lab})
    j, t = JStore(quantize_int8=True, seed=1), TStore(
        directory=str(tmp_path), quantize_int8=True, seed=1)
    for cid, sh in zip((2, 0, 2), shards):
        j.add(cid, dict(sh))
        t.add(cid, dict(sh))
        assert TStore.shard_nbytes(sh, True) == JStore.shard_nbytes(sh, True)
        want = sh["acts"].size + (sh["acts"].size // 16) * 4 \
            + sh[labels].nbytes
        assert TStore.shard_nbytes(sh, True) == want
        assert TStore.prepare_shard(sh, True)[1] == want
    assert t.bytes_received == j.bytes_received
    assert t.pool_nbytes() == j.pool_nbytes() == t.bytes_received
    tp, jp = t.pool(), j.pool()
    assert list(tp) == list(jp)
    for k in tp:
        assert tp[k].dtype == jp[k].dtype
        np.testing.assert_array_equal(tp[k], jp[k])
    assert t.pool()["acts"].dtype == np.int8
    np.testing.assert_array_equal(_dequant(t.pool()),
                                  j.pool(dequantize=True)["acts"])
    from repro_torch.data.activation_store import load_store
    back = load_store(str(tmp_path), seed=1)   # clients in file order
    for cid in (0, 2):
        for k, v in j.pool(cid).items():
            np.testing.assert_array_equal(back.pool(cid)[k], v)
        np.testing.assert_array_equal(_dequant(back.pool(cid)),
                                      j.pool(cid, dequantize=True)["acts"])
    np.testing.assert_array_equal(t.epoch_indices(3), j.epoch_indices(3))


def test_server_step_dequantizes_int8_batch():
    import repro.configs.registry as jr
    from repro.configs.base import RunConfig as JRun
    from repro.core import splitting as JS
    from repro.models import build_model as j_build
    from repro_torch.configs import registry as tr
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.models import build_model as t_build

    arch = "qwen3-1.7b"
    jm = j_build(jr.get_smoke_config(arch))
    tm = t_build(tr.get_smoke_config(arch))
    params = jax.tree.map(np.asarray,
                          jax.jit(jm.init)(jax.random.PRNGKey(0)))
    _, srv = JS.split_params(jm, params, 1)
    srv = jax.tree.map(np.asarray, srv)
    rng = np.random.default_rng(2)
    acts = rng.normal(size=(4, 16, jm.cfg.d_model)).astype(np.float32)
    q, s = JStore.prepare_shard({"acts": acts}, True)[0].values()
    batch = {"acts": q, "acts_scale": s,
             "tokens": rng.integers(0, jm.cfg.vocab_size, (4, 16)).astype(
                 np.int32)}
    jst, jm_ = jax.jit(JSt.make_server_train_step(jm, JRun()))(
        JSt.init_server_state(jm, JRun(), srv),
        jax.tree.map(jnp.asarray, batch))
    tst, tm_ = TSt.make_server_train_step(tm, TRun())(
        TSt.init_server_state(tm, TRun(), from_numpy_tree(srv)),
        from_numpy_tree(batch))
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    # the same step on the dequantized fp32 batch gives the same loss
    fp = dict(batch, acts=q.astype(np.float32) * s)
    del fp["acts_scale"]
    _, m2 = TSt.make_server_train_step(tm, TRun())(
        TSt.init_server_state(tm, TRun(), from_numpy_tree(srv)),
        from_numpy_tree(fp))
    assert float(m2["loss"]) == float(tm_["loss"])


def test_run_experiment_int8_matches_reference(tmp_path, monkeypatch):
    fed = dict(num_clients=4, clients_per_round=2, local_steps=2,
               device_batch_size=4, server_batch_size=8, seed=0)
    data = dict(train_samples=64, eval_samples=16, seq_len=32)
    j_spec, t_spec = P.specs("qwen3-1.7b", tmp_path, fed=fed, data=data,
                             rounds=2, epochs=2, quantize=True)
    assert t_spec.validate() == []
    j_out, init, j_store = P.reference_run(j_spec)
    t_out = P.port_run(t_spec, init, monkeypatch)
    t_res, j_res = t_out["results"]["ampere"], j_out["results"]["ampere"]
    P.check_histories(t_res["history"], j_res["history"], 2, 2, rtol=1e-5)
    assert t_res["store"].bytes_received == j_store.bytes_received == \
        64 * (32 * 64 + 32 * 4 + 32 * 4)
    tp, jp = t_res["store"].pool(), j_store.pool()
    assert tp["acts"].dtype == np.int8 and set(tp) == set(jp)
