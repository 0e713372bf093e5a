"""The port's activation streaming (``repro_torch.streaming``: the CRC'd
ring, the ring-backed store, the overlap accountant, the seeded
interleave) and the store's ``streaming_batches``, on the CPU, held to
the reference on the same numpy inputs:

* the shard codec's bytes, and the ring's segments (memmap files and
  in-RAM blobs) on both backends, stats included, ``==``;
* a torn write truncated at the reference's fraction, repaired and
  counted; a corrupt segment rejected; a producer thread against a slow
  consumer under backpressure;
* the streaming store's pool against the plain store and the reference's
  streaming store (both backends x int8), ``sample_arrivals`` ``==``;
* the accountant's ``(dt, overlapped)`` and the interleave draws ``==``;
* ``examples/specs/streaming_smoke.json`` whole through both packages
  (ring stats, wire statistics, tracer digest, counters ``==``), and a
  qwen3 smoke spec streamed in RAM and on disk: its history the
  serialized run's less ``sim_time``, the two backends' histories ``==``,
  the reference's within the parity gate, ``overlap_s`` > 0.
"""

import dataclasses
import json
import pathlib
import threading
import time

import numpy as np
import pytest

import torch_experiment_parity as P
from repro.data.activation_store import ActivationStore as JStore
from repro.experiments import ExperimentSpec as JSpec
from repro.experiments import StreamingSpec as JStreamingSpec
from repro.streaming import ActivationRing as JRing
from repro.streaming import InterleaveSchedule as JSchedule
from repro.streaming import OverlapAccountant as JAccountant
from repro.streaming import StreamingActivationStore as JStreamingStore
from repro.streaming import encode_shard as j_encode_shard
from repro.streaming.ring import HEADER_SIZE as J_HEADER_SIZE
from repro.streaming.ring import _pack_header as j_pack_header
from repro.transport import FaultPlan as JFaultPlan
from repro.transport import FaultSpec as JFaultSpec
from repro_torch.data import ActivationStore
from repro_torch.experiments import (ExperimentSpec, ObservabilitySpec,
                                     StreamingSpec)
from repro_torch.streaming import (ActivationRing, InterleaveSchedule,
                                   OverlapAccountant, SegmentPrefetcher,
                                   StreamingActivationStore, TornSegment,
                                   decode_shard, encode_shard)
from repro_torch.streaming.ring import HEADER_SIZE, _pack_header
from repro_torch.transport import FaultPlan, FaultSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]
STREAMING_SMOKE = str(ROOT / "examples/specs/streaming_smoke.json")
RTOL = 1e-4
DIVERGED_RTOL = 1e-3    # streaming_smoke's last server epoch (it diverges)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with P.one_torch_thread():
        yield


def _shard(i, n=4, d=3):
    rng = np.random.default_rng(i)
    return {"acts": rng.normal(size=(n, d)).astype(np.float32),
            "labels": rng.integers(0, 9, (n,)).astype(np.int32)}


def _blobs(ring, n):
    """The stored bytes of segments ``0..n-1``."""
    if ring.backend == "memory":
        return [bytes(ring._mem_segments[i]) for i in range(n)]
    return [pathlib.Path(ring._seg_path(i)).read_bytes() for i in range(n)]


# ---------------------------------------------------------------------------
# the codec and the ring
# ---------------------------------------------------------------------------


def test_shard_codec_matches_reference_and_roundtrips():
    for i, sh in enumerate([_shard(0), _shard(1, n=7, d=5),
                            {"acts": np.arange(6, dtype=np.int8)
                             .reshape(2, 3),
                             "acts_scale": np.ones((2, 1), np.float32),
                             "tokens": np.zeros((2, 0), np.int32)}]):
        buf = encode_shard(sh)
        assert buf == j_encode_shard(sh) == encode_shard(sh), i
        back = decode_shard(buf)
        assert list(back) == list(sh)
        for k in sh:
            assert back[k].dtype == sh[k].dtype
            assert np.array_equal(back[k], sh[k])
            assert not back[k].flags.writeable     # a view onto the bytes
    assert HEADER_SIZE == J_HEADER_SIZE
    payload = encode_shard(_shard(2))
    assert _pack_header(7, 3, 4, 0.5, 2, payload) == \
        j_pack_header(7, 3, 4, 0.5, 2, payload)


@pytest.mark.parametrize("backend", ["memory", "memmap"])
def test_ring_roundtrip_matches_reference(backend, tmp_path):
    """Nine shards through a ring of 4 (low watermark 2), the consumer
    draining one segment at each stall: the same segment bytes, metadata
    and stats as the reference's ring."""
    rings = {}
    for name, cls in (("t", ActivationRing), ("j", JRing)):
        ring = cls(directory=str(tmp_path / name), backend=backend,
                   capacity_segments=4, low_watermark=2)
        seq = 0
        for i in range(9):
            while not ring.try_put(i % 3, _shard(i), t_arrival=0.25 * i,
                                   cut=i % 2 - 1):
                ring.read(seq)
                ring.ack(seq)
                seq += 1
        ring.close()
        rings[name] = ring
    t, j = rings["t"], rings["j"]
    assert _blobs(t, 9) == _blobs(j, 9)
    assert t.stats == j.stats
    assert t.stats["max_occupancy"] <= 4 and t.stats["stalls"] > 0
    for i in range(9):
        meta, got = t.read(i)
        assert (meta.client, meta.t_arrival, meta.n_samples, meta.cut,
                meta.version) == (i % 3, 0.25 * i, 4, i % 2 - 1, i)
        for k, v in _shard(i).items():
            assert np.array_equal(got[k], v)
    assert [m.seq for m, _ in SegmentPrefetcher(t)] == list(range(9))


def test_torn_write_truncates_as_reference_and_is_repaired(tmp_path):
    """Under one fault plan a segment write tears at the reference's
    fraction (the torn bytes ``==``); every commit of a ring that tears
    all of them is repaired before a reader sees it, and counted."""
    spec = dict(seed=3, torn_write_prob=1.0)
    payload = encode_shard(_shard(4, n=16, d=8))
    header = _pack_header(0, 0, 16, 0.0, -1, payload)
    torn = []
    for name, cls, plan in (("t", ActivationRing,
                             FaultPlan(FaultSpec(**spec))),
                            ("j", JRing, JFaultPlan(JFaultSpec(**spec)))):
        ring = cls(directory=str(tmp_path / f"w{name}"), backend="memmap",
                   fault_plan=plan)
        for seq in range(4):
            ring._write_segment(seq, header, payload)
        torn.append(_blobs(ring, 4))
    assert torn[0] == torn[1]
    assert all(HEADER_SIZE <= len(b) < len(header) + len(payload)
               for b in torn[0])

    rings = {}
    for name, cls, plan in (("t", ActivationRing,
                             FaultPlan(FaultSpec(**spec))),
                            ("j", JRing, JFaultPlan(JFaultSpec(**spec)))):
        ring = cls(directory=str(tmp_path / name), backend="memmap",
                   capacity_segments=16, fault_plan=plan)
        for i in range(5):
            ring.put(0, {"acts": np.full((2, 2), i, np.float32)})
        rings[name] = ring
    t = rings["t"]
    assert t.stats["torn_repairs"] == 5
    assert t.stats == rings["j"].stats
    assert _blobs(t, 5) == _blobs(rings["j"], 5)
    for i in range(5):
        assert np.all(t.read(i)[1]["acts"] == i)


@pytest.mark.parametrize("where", ["payload", "header"])
def test_ring_rejects_corrupt_segment(where, tmp_path):
    ring = ActivationRing(directory=str(tmp_path / "r"), backend="memmap",
                          capacity_segments=4)
    ring.put(0, _shard(0))
    path = pathlib.Path(ring._seg_path(0))
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2 if where == "payload" else 20] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(TornSegment, match="CRC"):
        ring._verify(0)
    path.write_bytes(bytes(blob[:HEADER_SIZE - 1]))
    with pytest.raises(TornSegment, match="short header"):
        ring._verify(0)


def test_ring_backpressure_blocks_and_unblocks_under_slow_consumer():
    ring = ActivationRing(backend="memory", capacity_segments=3,
                          low_watermark=1)
    done = []

    def produce():
        for i in range(12):
            ring.put(0, {"acts": np.full((2, 2), i, np.float32)},
                     timeout=10.0)
        ring.close()
        done.append(True)

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    time.sleep(0.1)
    assert ring.peek_committed() <= 3       # the gate closed at capacity
    seq = 0
    while ring.next_committed(seq, block=True, timeout=10.0):
        _, sh = ring.read(seq)
        assert np.all(sh["acts"] == seq)    # FIFO
        ring.ack(seq)
        seq += 1
        time.sleep(0.005)                   # a slow consumer
    th.join(timeout=10.0)
    assert not th.is_alive()
    assert done and seq == 12
    assert ring.stats["stalls"] > 0
    assert ring.stats["stall_wait_s"] > 0.0
    assert ring.stats["max_occupancy"] <= 3


# ---------------------------------------------------------------------------
# the streaming store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["memory", "memmap"])
@pytest.mark.parametrize("quantize", [False, True])
def test_streaming_store_pool_matches_plain_and_reference(backend, quantize,
                                                          tmp_path):
    raw = [(c, _shard(10 + k, n=8, d=5)) for k, c in enumerate((0, 1, 0, 2))]
    plain = ActivationStore(seed=0, quantize_int8=quantize)
    for c, s in raw:
        plain.add(c, dict(s))
    stores = {}
    for name, cls in (("t", StreamingActivationStore),
                      ("j", JStreamingStore)):
        st = cls(directory=str(tmp_path / name), backend=backend, seed=0,
                 quantize_int8=quantize, capacity_segments=2,
                 low_watermark=0, drain_chunk=1, interleave_seed=5)
        for k, (c, s) in enumerate(raw):
            st.submit(c, dict(s), t_arrival=float(k), cut=k if k else None)
        st.finish()
        stores[name] = st
    st, jst = stores["t"], stores["j"]
    assert st._closed.is_set()
    assert st.bytes_received == plain.bytes_received == jst.bytes_received
    assert st.num_samples() == plain.num_samples() == 32
    assert st.pool_nbytes() == plain.pool_nbytes() == jst.pool_nbytes()
    want, jpool = plain.pool(), jst.pool(dequantize=False)
    got = st.pool()
    assert list(got) == list(want) == list(jpool)
    for k in want:
        assert got[k].flags.writeable       # a fresh array, not a view
        assert np.array_equal(got[k], want[k])
        assert np.array_equal(got[k], jpool[k])
    assert st.ring.stats == jst.ring.stats
    assert st.ring.stats["stalls"] > 0
    assert [t.cut for t in st.ring.metas()] == [-1, 1, 2, 3]
    assert st.cut_depths() == jst.cut_depths() == [1, 2, 3]
    # identically seeded stores draw the same epochs
    for _ in range(2):
        idx = st.epoch_indices(4)
        assert np.array_equal(idx, plain.epoch_indices(4))
        assert np.array_equal(idx, jst.epoch_indices(4))
    # arrivals: one per pool row, in submit order
    arr = st.sample_arrivals()
    assert np.array_equal(arr, jst.sample_arrivals())
    assert np.array_equal(arr, np.repeat([0.0, 1.0, 2.0, 3.0], 8))


# ---------------------------------------------------------------------------
# overlap accounting and the interleave
# ---------------------------------------------------------------------------


def test_overlap_accountant_capacity_model():
    acct = OverlapAccountant(np.array([0.5, 1.0, 1.5, 2.0]),
                             device_end=2.0, per_batch_s=1.0)
    idx = np.array([[3, 1], [0, 2]])
    # batch 0 needs 2 landed samples (ready 1.0) -> done 2.0; batch 1
    # needs 4 (ready 2.0) -> done 3.0: dt 1.0, overlap 1.0
    assert acct.epoch(idx) == (1.0, 1.0)
    assert acct.epoch(idx) == (2.0, 0.0)     # everything landed
    assert acct.total_s == 5.0               # vs 2 + 2 x 2 serialized


def test_overlap_accountant_matches_reference():
    rng = np.random.default_rng(0)
    arrivals = rng.uniform(0, 10, 64)
    accts = [cls(arrivals, device_end=5.0, per_batch_s=0.3)
             for cls in (OverlapAccountant, JAccountant)]
    serialized = 5.0
    for e in range(4):
        idx = rng.permutation(64)[:56].reshape(7, 8)
        got, want = (a.epoch(idx) for a in accts)
        assert got == want, e
        dt, ov = got
        assert dt >= 0.0 and ov >= 0.0
        assert dt + ov == pytest.approx(7 * 0.3)
        serialized += 7 * 0.3
    assert accts[0].total_s == accts[1].total_s <= serialized
    empty = [cls(np.zeros(0), device_end=1.0, per_batch_s=0.5)
             for cls in (OverlapAccountant, JAccountant)]
    idx = np.zeros((3, 2), np.int32)
    assert empty[0].epoch(idx) == empty[1].epoch(idx)


def test_interleave_schedule_matches_reference():
    def draws(cls, seed, chunk, n=32):
        s = cls(seed, chunk)
        return [s.next_drain() for _ in range(n)]

    for seed, chunk in ((4, 3), (0, 1), (9, 8)):
        got = draws(InterleaveSchedule, seed, chunk)
        assert got == draws(JSchedule, seed, chunk)
        assert all(1 <= v <= 2 * chunk for v in got)
    assert draws(InterleaveSchedule, 4, 3) != \
        draws(InterleaveSchedule, 5, 3)
    with pytest.raises(ValueError):
        InterleaveSchedule(0, 0)


# ---------------------------------------------------------------------------
# the plain store's streaming_batches
# ---------------------------------------------------------------------------


def test_streaming_final_epoch_covers_late_shards():
    st = ActivationStore(seed=0)
    st.add(0, {"acts": np.zeros((8, 4), np.float32),
               "labels": np.zeros((8,), np.int32)})
    gen = st.streaming_batches(4)
    first = [next(gen), next(gen)]    # one mid-stream epoch, early pool
    assert all((b["labels"] == 0).all() for b in first)
    st.add(1, {"acts": np.ones((8, 4), np.float32),
               "labels": np.ones((8,), np.int32)})
    st.finish()
    rest = list(gen)
    assert sum(int((b["labels"] == 1).sum()) for b in rest) >= 8
    # the last epoch is one full pass over the complete pool
    tail = np.concatenate([b["labels"] for b in rest[-4:]])
    assert len(tail) == 16
    assert (tail == 0).sum() == 8 and (tail == 1).sum() == 8


def test_streaming_closed_before_iteration_single_epoch():
    data = {"acts": np.arange(32, dtype=np.float32).reshape(8, 4),
            "labels": np.arange(8, dtype=np.int32)}
    st, jst = ActivationStore(seed=0), JStore(seed=0)
    for s in (st, jst):
        s.add(0, data)
        s.finish()
    got = list(st.streaming_batches(4))
    assert len(got) == 2                    # one full epoch, then stop
    want = list(jst.streaming_batches(4))
    for b, jb in zip(got, want, strict=True):
        for k in b:
            assert np.array_equal(b[k], jb[k])
    assert np.array_equal(np.sort(np.concatenate(
        [b["labels"] for b in got])), np.arange(8))


def test_store_async_writer_and_streaming():
    st = ActivationStore(seed=0)
    st.start_writer()
    for cid in range(4):
        st.submit(cid, {"acts": np.ones((8, 4), np.float32) * cid,
                        "labels": np.full((8,), cid, np.int32)})
    st.finish()
    n = 0
    for _ in st.streaming_batches(8):
        n += 1
        if n > 64:
            break
    assert st.num_samples() == 32
    assert n == 4                  # closed: exactly one epoch of 4


# ---------------------------------------------------------------------------
# end to end through run_experiment
# ---------------------------------------------------------------------------


def _counters(out):
    return out["results"]["ampere"]["history"]["observability"]["metrics"][
        "counters"]


def _store_of(out):
    return out["results"]["ampere"]["store"]


def test_streaming_smoke_matches_reference(tmp_path):
    """``streaming_smoke.json`` whole (vit-s; a memmap ring of 4 under
    faults with a quarter of the writes torn; observability on): ring
    stats, wire statistics, tracer digest, counters and the phase table
    (less wall time) ``==``; histories within the parity gate; the
    segments on disk."""
    j_spec = dataclasses.replace(JSpec.load(STREAMING_SMOKE),
                                 results_dir=str(tmp_path / "j"))
    t_spec = dataclasses.replace(ExperimentSpec.load(STREAMING_SMOKE),
                                 results_dir=str(tmp_path / "t"))
    assert t_spec.validate() == []
    assert ExperimentSpec.load(STREAMING_SMOKE).to_json() == \
        JSpec.load(STREAMING_SMOKE).to_json()
    j_out, init, j_store = P.reference_run(j_spec)
    with pytest.MonkeyPatch.context() as mp:
        t_out = P.port_run(t_spec, init, mp)
    t_store = _store_of(t_out)
    assert t_store.ring.backend == "memmap"
    assert t_store.ring.stats == j_store.ring.stats
    assert t_store.ring.stats["stalls"] > 0
    assert t_store.ring.stats["torn_repairs"] > 0
    assert np.array_equal(t_store.sample_arrivals(),
                          j_store.sample_arrivals())
    t_sum, j_sum = t_out["summary"]["ampere"], j_out["summary"]["ampere"]
    assert t_sum["wire"] == j_sum["wire"]
    assert t_sum["trace"] == j_sum["trace"]
    assert "streaming" in t_sum["trace"]["tracks"]
    assert _counters(t_out) == _counters(j_out)
    assert [{k: v for k, v in r.items() if k != "wall_s"}
            for r in t_sum["phases"]] == \
        [{k: v for k, v in r.items() if k != "wall_s"}
         for r in j_sum["phases"]]
    # the spec's server phase diverges in both packages (merged val loss
    # 4.50 after epoch 0, 25.3 after epoch 1): epoch 0 agrees to ~1e-6
    # relative and the blow-up amplifies that ~100x, so the last epoch is
    # held at DIVERGED_RTOL and everything before it at the gate's RTOL
    t_hist = t_out["results"]["ampere"]["history"]
    j_hist = j_out["results"]["ampere"]["history"]
    P.check_histories(dict(t_hist, server=t_hist["server"][:1]),
                      dict(j_hist, server=j_hist["server"][:1]), 2, 1, RTOL)
    assert len(t_hist["server"]) == len(j_hist["server"]) == 2
    t_last, j_last = t_hist["server"][1], j_hist["server"][1]
    assert j_last["val_loss"] > 5 * j_hist["server"][0]["val_loss"]
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(t_last[k], j_last[k], rtol=DIVERGED_RTOL)
    np.testing.assert_allclose(t_last["val_acc"], j_last["val_acc"],
                               atol=1e-2)
    segs = sorted((tmp_path / "t" / "ampere" / "ring").glob("seg_*.bin"))
    assert len(segs) == t_store.ring.stats["segments"]


def test_qwen3_streamed_history_is_the_serialized_one(tmp_path):
    """A qwen3 smoke spec streamed through a ring of 2 (low watermark 0),
    in RAM and on disk: each history ``==`` the serialized run's less
    ``sim_time``, which is smaller; the two backends' histories ``==``
    whole; the reference's streamed run within the parity gate with the
    same ``sim_time`` and ring stats; ``overlap_s`` > 0 in the phase
    table."""
    stream = dict(capacity_segments=2, low_watermark=0, drain_chunk=1)
    j_spec, t_spec = P.specs("qwen3-1.7b", tmp_path / "j", fed=P.LM_FED,
                             data=P.LM_DATA, rounds=2, epochs=2)
    j_spec = dataclasses.replace(j_spec, streaming=JStreamingSpec(
        backend="memory", **stream))
    j_out, init, j_store = P.reference_run(j_spec)
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        outs["serialized"] = P.port_run(t_spec, init, mp)
        for backend in ("memory", "memmap"):
            outs[backend] = P.port_run(dataclasses.replace(
                t_spec, name=f"s_{backend}", persist=True,
                results_dir=str(tmp_path / backend),
                streaming=StreamingSpec(backend=backend, **stream),
                observability=ObservabilitySpec()), init, mp)
    hists = {k: dict(o["results"]["ampere"]["history"])
             for k, o in outs.items()}
    for k in ("memory", "memmap"):
        hists[k].pop("observability")

    def canon(h, drop=("sim_time",)):
        return json.dumps({k: v for k, v in h.items() if k not in drop},
                          sort_keys=True)

    assert canon(hists["memory"]) == canon(hists["serialized"])
    assert hists["memory"]["sim_time"] < hists["serialized"]["sim_time"]
    assert canon(hists["memmap"], ()) == canon(hists["memory"], ())
    P.check_histories(hists["memory"],
                      j_out["results"]["ampere"]["history"], 2, 2, RTOL)
    for k in ("memory", "memmap"):
        store = _store_of(outs[k])
        assert store.ring.backend == k
        assert store.ring.stats == j_store.ring.stats
        assert store.ring.stats["stalls"] > 0
        rows = {r["phase"]: r for r in outs[k]["summary"]["ampere"]["phases"]}
        assert rows["server"]["overlap_s"] > 0.0
        assert _counters(outs[k])["ring_backpressure_stalls{phase=transfer}"] \
            == store.ring.stats["stalls"]
    assert sorted((tmp_path / "memmap" / "ampere" / "ring")
                  .glob("seg_*.bin"))
