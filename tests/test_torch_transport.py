"""The port's transport layer (``repro_torch.transport``), torn-write
injection at the storage boundary and the store's writer thread, each held
to the reference (``repro.transport``, ``repro.runtime``) on the same
inputs: frames, fault decisions, retry timing, wire accounting, quorum
exclusions, journal and checkpoint tears."""

import threading

import numpy as np
import pytest
import torch

import repro.transport as J
import repro_torch.transport as T
from repro.runtime import fault_tolerance as j_ft
from repro.runtime.checkpoint import Checkpointer as JCheckpointer
from repro_torch.data.activation_store import ActivationStore
from repro_torch.experiments.runner import Runner
from repro_torch.runtime import checkpoint as t_ckpt
from repro_torch.runtime import fault_tolerance as t_ft

ALL_FAULTS = dict(seed=1, drop_prob=0.3, corrupt_prob=0.3,
                  duplicate_prob=0.2, latency_spike_prob=0.2,
                  reset_prob=0.1, torn_write_prob=0.3)


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def test_frame_bytes_and_round_trip_match_reference():
    f = dict(kind="shard", msg_id="acts/3/1", payload=b"x" * 1000, sender=3,
             seq=7, meta={"client_id": 3})
    wire = T.encode_frame(T.Frame(**f))
    assert wire == J.encode_frame(J.Frame(**f))
    back, end = T.decode_frame(wire)
    assert back == T.Frame(**f) and end == len(wire)
    # two frames back to back decode in turn, in both packages
    buf = wire + T.encode_frame(T.Frame(kind="ack", msg_id="a"))
    first, end = T.decode_frame(buf)
    second, end2 = T.decode_frame(buf, end)
    assert (first.msg_id, second.kind, end2) == ("acts/3/1", "ack", len(buf))
    assert J.decode_frame(buf, end)[0].kind == "ack"
    assert T.frame_overhead(T.Frame(**f)) == J.frame_overhead(J.Frame(**f))


def test_frame_detects_every_bit_flip():
    wire = T.encode_frame(T.Frame(kind="data", msg_id="m",
                                  payload=b"hello world" * 10))
    for bit in range(0, len(wire) * 8, 7):
        flipped = T.flip_bit(wire, bit)
        assert flipped == J.flip_bit(wire, bit)
        with pytest.raises((T.CorruptFrame, T.TruncatedFrame)):
            T.decode_frame(flipped)


def test_frame_truncation_detected():
    wire = T.encode_frame(T.Frame(kind="data", msg_id="m",
                                  payload=b"z" * 500))
    for cut in (3, 10, len(wire) // 2, len(wire) - 1):
        with pytest.raises(T.TruncatedFrame):
            T.decode_frame(wire[:cut])


def test_one_crc32_and_one_fault_spec():
    """The journal, the checkpoints, the fleet trace and the span log use
    the framing's CRC, and the spec's fault section is the transport's
    class."""
    from repro_torch.experiments import spec as t_spec
    from repro_torch.fleet import scheduler as t_sched
    from repro_torch.observability import export as t_export

    for mod in (t_ft, t_ckpt, t_sched, t_export):
        assert mod.crc32 is T.crc32
    assert t_spec.FaultSpec is T.FaultSpec
    for data in (b"", b"a", bytes(range(256)) * 3):
        assert T.crc32(data) == J.crc32(data)


# ---------------------------------------------------------------------------
# fault plan: every draw the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("faults", [
    ALL_FAULTS, dict(ALL_FAULTS, seed=2), dict(seed=9, drop_prob=0.4),
    dict(seed=5, duplicate_prob=1.0), dict(seed=4, reset_prob=1.0),
    dict(seed=0, perma_fail_devices=(4,)), {},
], ids=["all", "all_seed2", "drop", "dup", "reset", "perma", "none"])
def test_fault_plan_draws_match_reference(faults):
    tp, jp = T.FaultPlan(T.FaultSpec(**faults)), J.FaultPlan(J.FaultSpec(
        **faults))
    assert tp.active == jp.active
    keys = [f"r{i}/up/{i % 5}" for i in range(120)] + ["acts/3/0", "k"]
    for key in keys:
        assert T.stable_hash(7, key, 2) == J.stable_hash(7, key, 2)
        assert tp.torn_write(key) == jp.torn_write(key)
        for attempt in (1, 2, 5):
            assert tp.backoff_jitter(key, attempt) == \
                jp.backoff_jitter(key, attempt)
            for device in (-1, 3, 4):
                t, j = tp.decide(key, attempt, device), \
                    jp.decide(key, attempt, device)
                assert (t.drop, t.corrupt, t.duplicate, t.delay_s,
                        t.reset_frac, t.bit_index, t.delivered) == \
                    (j.drop, j.corrupt, j.duplicate, j.delay_s,
                     j.reset_frac, j.bit_index, j.delivered)


def test_fault_plan_seed_sensitive_perma_fail_and_inactive():
    a = T.FaultPlan(T.FaultSpec(**ALL_FAULTS))
    b = T.FaultPlan(T.FaultSpec(**dict(ALL_FAULTS, seed=2)))
    keys = [f"r{i}" for i in range(200)]
    da = [a.decide(k, 1) for k in keys]
    assert da != [b.decide(k, 1) for k in keys]
    assert any(d.drop for d in da) and any(d.corrupt for d in da)
    assert any(d.duplicate for d in da) and any(d.delay_s for d in da)
    assert any(d.reset_frac is not None for d in da)
    plan = T.FaultPlan(T.FaultSpec(seed=0, perma_fail_devices=(4,)))
    assert plan.active
    assert all(plan.decide("k", att, 4).drop for att in range(1, 9))
    assert plan.decide("k", 1, 3).delivered
    assert not T.FaultPlan(T.FaultSpec()).active
    assert T.FaultSpec(drop_prob=2.0).validate() == \
        J.FaultSpec(drop_prob=2.0).validate() != []


# ---------------------------------------------------------------------------
# retry
# ---------------------------------------------------------------------------


def test_backoff_bounds_match_reference():
    tp = T.RetryPolicy(max_attempts=8, base_backoff_s=0.5, max_backoff_s=2.0)
    jp = J.RetryPolicy(max_attempts=8, base_backoff_s=0.5, max_backoff_s=2.0)
    assert [tp.backoff_s(a, 1.0) for a in (1, 2, 3, 7)] == \
        [0.5, 1.0, 2.0, 2.0]
    for a in range(0, 9):
        for u in (0.0, 0.25, 0.999):
            assert tp.backoff_s(a, u) == jp.backoff_s(a, u)
    assert T.RetryPolicy(max_attempts=0).validate() == \
        J.RetryPolicy(max_attempts=0).validate() != []


def test_retry_policy_call_chains_and_never_oversleeps(monkeypatch):
    import repro_torch.transport.retry as retry_mod

    sleeps = []
    monkeypatch.setattr(retry_mod.time, "sleep", sleeps.append)
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("nope")

    pol = T.RetryPolicy(max_attempts=3, base_backoff_s=0.1,
                        max_backoff_s=1.0)
    with pytest.raises(T.RetryExhaustedError) as ei:
        pol.call(flaky)
    assert len(calls) == 3 and len(sleeps) == 2
    assert isinstance(ei.value.__cause__, OSError)
    assert ei.value.attempts == 3
    assert pol.call(lambda: 42) == 42 and len(sleeps) == 2


def test_with_retries_matches_reference(monkeypatch):
    for mod in (t_ft, j_ft):
        sleeps = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)

        def boom():
            raise OSError("disk")

        with pytest.raises(Exception) as ei:
            mod.with_retries(boom, retries=3, backoff=0.1)
        assert isinstance(ei.value.__cause__, OSError)
        assert sleeps == [0.1, 0.2]          # none after the last attempt
    injected = []
    flaky = iter([OSError("a"), OSError("b"), 5])

    def once():
        v = next(flaky)
        if isinstance(v, Exception):
            raise v
        return v

    assert t_ft.with_retries(once, retries=3, backoff=1.0,
                             sleep_fn=injected.append) == 5
    assert injected == [1.0, 2.0]


# ---------------------------------------------------------------------------
# in-process transport accounting
# ---------------------------------------------------------------------------


def _both(faults=None, **kw):
    retry = dict(max_attempts=kw.pop("max_attempts", 5), base_backoff_s=0.01,
                 max_backoff_s=0.1, attempt_timeout_s=0.2)
    t = T.InProcessTransport(
        T.FaultPlan(T.FaultSpec(**faults)) if faults is not None else None,
        T.RetryPolicy(**retry), **kw)
    j = J.InProcessTransport(
        J.FaultPlan(J.FaultSpec(**faults)) if faults is not None else None,
        J.RetryPolicy(**retry), **kw)
    return t, j


def test_faultfree_transfer_is_exactly_analytic():
    t = T.InProcessTransport()
    res = t.transfer("k1", 12345)
    assert (res.ok, res.wire_bytes, res.extra_time, res.attempts,
            res.first_delivery) == (True, 12345, 0.0, 1, True)
    assert t.transfer("k1", 12345).first_delivery is False
    assert T.cohort_exchange(t, round_key="r0", clients=[3, 1, 4],
                             one_way_bytes=1000) == ([0, 1, 2], 6000, 0.0,
                                                     [])
    assert T.cohort_exchange(None, round_key="r0", clients=[3, 1, 4],
                             one_way_bytes=[10, 20, 30]) == \
        J.cohort_exchange(None, round_key="r0", clients=[3, 1, 4],
                          one_way_bytes=[10, 20, 30])


@pytest.mark.parametrize("faults", [
    ALL_FAULTS, dict(seed=11, drop_prob=0.4), dict(seed=5,
                                                   duplicate_prob=1.0),
    dict(seed=5, reset_prob=1.0), dict(seed=9, corrupt_prob=1.0),
    dict(seed=3, latency_spike_prob=0.5, latency_spike_s=2.0),
], ids=["all", "drop", "dup", "reset", "corrupt", "spike"])
def test_faulted_accounting_matches_reference(faults):
    """The same transfers (payloads through the codec, per-device links,
    repeated keys) give the reference's results, stats and per-round
    deltas."""
    t, j = _both(faults, default_bandwidth_bps=1000.0)
    for i in range(60):
        key = f"acts/{i % 4}/{i // 8}"
        kw = dict(device=i % 4, bandwidth_bps=(None if i % 3 else 500.0))
        payload = bytes([i]) * 64 if i % 5 == 0 else None
        rt = t.transfer(key, 100 + i, payload=payload, **kw)
        rj = j.transfer(key, 100 + i, payload=payload, **kw)
        assert dataclass_tuple(rt) == dataclass_tuple(rj)
        if i % 10 == 9:
            assert t.delta_stats() == j.delta_stats()
    assert t.stats == j.stats
    assert t.faulty == j.faulty


def dataclass_tuple(r):
    return (r.ok, r.wire_bytes, r.extra_time, r.attempts, r.first_delivery)


def test_drop_then_success_counts_both_attempts():
    bw = 1000.0
    plan = T.FaultPlan(T.FaultSpec(seed=11, drop_prob=0.4))
    key = next(k for k in (f"k{i}" for i in range(200))
               if plan.decide(k, 1).drop and plan.decide(k, 2).delivered)
    t = T.InProcessTransport(plan, T.RetryPolicy(
        max_attempts=5, base_backoff_s=0.0, attempt_timeout_s=2.0),
        default_bandwidth_bps=bw)
    res = t.transfer(key, 500)
    assert res.ok and res.attempts == 2 and res.wire_bytes == 1000
    assert res.extra_time == pytest.approx(500 / bw + 2.0)
    assert t.stats["drops"] == 1 and t.stats["delivered"] == 1


def test_quorum_exclusions_and_error_match_reference():
    for n, frac in ((4, 1.0), (4, 0.5), (3, 0.5), (5, 0.001), (7, 0.7)):
        assert T.required_quorum(n, frac) == J.required_quorum(n, frac)
    t, j = _both(dict(seed=0, perma_fail_devices=(7,)), max_attempts=2)
    got = T.cohort_exchange(t, round_key="r1", clients=[5, 7, 9],
                            one_way_bytes=[100, 200, 300], quorum_frac=0.5,
                            bandwidth_bps={5: 50.0, 7: 60.0})
    want = J.cohort_exchange(j, round_key="r1", clients=[5, 7, 9],
                             one_way_bytes=[100, 200, 300],
                             quorum_frac=0.5,
                             bandwidth_bps={5: 50.0, 7: 60.0})
    assert got == want and got[0] == [0, 2] and got[3] == [7]
    with pytest.raises(T.QuorumError) as te:
        T.cohort_exchange(t, round_key="r2", clients=[5, 7, 9],
                          one_way_bytes=100, quorum_frac=1.0)
    with pytest.raises(J.QuorumError) as je:
        J.cohort_exchange(j, round_key="r2", clients=[5, 7, 9],
                          one_way_bytes=100, quorum_frac=1.0)
    assert str(te.value) == str(je.value)
    assert t.stats == j.stats
    with pytest.raises(ValueError, match="entries"):
        T.cohort_exchange(t, round_key="r3", clients=[1, 2],
                          one_way_bytes=[1])


# ---------------------------------------------------------------------------
# torn writes at the storage boundary
# ---------------------------------------------------------------------------


def test_journal_torn_write_injection_matches_reference(tmp_path):
    """Tears cut the same appends at the same fraction as the reference's
    journal (the files are equal byte for byte), a torn record never
    becomes the resume point, and a later intact one wins."""
    spec = dict(seed=3, torn_write_prob=0.5)
    tj = t_ft.RoundJournal(str(tmp_path / "t.jsonl"),
                           fault_plan=T.FaultPlan(T.FaultSpec(**spec)))
    jj = j_ft.RoundJournal(str(tmp_path / "j.jsonl"),
                           fault_plan=J.FaultPlan(J.FaultSpec(**spec)))
    for r in range(12):
        tj.append({"phase": "device", "round": r})
        jj.append({"phase": "device", "round": r})
        assert tj.last() == jj.last()
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    torn = T.FaultPlan(T.FaultSpec(seed=3, torn_write_prob=1.0))
    j2 = t_ft.RoundJournal(str(tmp_path / "j2.jsonl"), fault_plan=torn)
    j2.append({"phase": "device", "round": 0})
    assert j2.last() is None
    j2.fault_plan = None
    j2.append({"phase": "device", "round": 1})
    assert j2.last() == {"phase": "device", "round": 1}


def test_checkpoint_torn_write_injection_falls_back(tmp_path):
    """The CRC is recorded over the intact file, the tear is detected at
    restore and the older snapshot resumes the run, as the reference's
    checkpointer does with the same plan."""
    plan = dict(seed=0, torn_write_prob=1.0)
    tck = t_ckpt.Checkpointer(str(tmp_path / "t"), keep=3)
    jck = JCheckpointer(str(tmp_path / "j"), keep=3)
    for ck, x in ((tck, torch.full((8,), 1.0)), (jck, np.full(8, 1.0))):
        ck.save(1, {"x": x}, {"phase": "p"})
    tck.fault_plan = T.FaultPlan(T.FaultSpec(**plan))
    jck.fault_plan = J.FaultPlan(J.FaultSpec(**plan))
    tck.save(2, {"x": torch.full((8,), 2.0)}, {"phase": "p"})
    jck.save(2, {"x": np.full(8, 2.0)}, {"phase": "p"})
    for ck in (tck, jck):
        got, meta = ck.restore()
        assert meta["step"] == 1 and float(got["x"][0]) == 1.0
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        tck.restore(step=2)

    r = Runner(str(tmp_path / "run"), patience=5,
               fault_plan=T.FaultPlan(T.FaultSpec(seed=0)))
    assert r.ckpt.fault_plan is r.journal.fault_plan is not None
    r.ckpt.save(0, {"x": torch.zeros(4)}, {"phase": "p", "round": 0})
    r.ckpt.fault_plan = T.FaultPlan(T.FaultSpec(**plan))
    r.ckpt.save(1, {"x": torch.ones(4)}, {"phase": "p", "round": 1})
    state, first = r.restore("p", None)
    assert first == 1 and float(state["x"][0]) == 0.0
    r.close()


# ---------------------------------------------------------------------------
# the store's writer thread
# ---------------------------------------------------------------------------


def _shard(i, rows=4):
    return {"acts": np.full((rows, 3), float(i), np.float32),
            "labels": np.arange(rows, dtype=np.int32)}


def test_writer_joins_on_finish_and_queue_is_bounded():
    st = ActivationStore(seed=0, queue_depth=2)
    assert st._q.maxsize == 2
    st.start_writer()
    assert st._writer.daemon is False
    for i in range(8):
        st.submit(i % 2, _shard(i))
    writer = st._writer
    st.finish()
    assert st._writer is None and not writer.is_alive()
    assert st.num_samples() == 32
    sync = ActivationStore(seed=0)
    for i in range(8):
        sync.add(i % 2, _shard(i))
    for k, v in sync.pool().items():
        np.testing.assert_array_equal(st.pool()[k], v)
    assert st.bytes_received == sync.bytes_received
    assert ActivationStore(seed=0)._q.maxsize == 64


def test_writer_backpressure_blocks_the_producer():
    """A full queue blocks ``submit`` until the writer takes a shard."""
    st = ActivationStore(seed=0, queue_depth=1)
    gate = threading.Event()
    store = st._store

    def slow_store(*a):
        gate.wait(10)
        store(*a)

    st._store = slow_store
    st.start_writer()
    st.submit(0, _shard(0))            # taken by the writer, which waits
    st.submit(0, _shard(1))            # fills the queue
    third = threading.Thread(target=st.submit, args=(0, _shard(2)))
    third.start()
    third.join(0.2)
    assert third.is_alive()            # blocked on the full queue
    gate.set()
    third.join(10)
    st.finish()
    assert st.num_samples() == 12


def test_writer_error_is_raised_by_finish_not_dropped():
    """An exception in the writer is raised again by ``finish``, or by
    the next ``submit`` once the writer has hit it (which joins the
    writer), and only once; the writer drains the queue meanwhile, so the
    producer never deadlocks."""
    st = ActivationStore(seed=0, queue_depth=2)
    st.start_writer()
    st.submit(0, _shard(0))
    st.submit(0, {"labels": np.zeros(4, np.int32)})    # no acts: KeyError
    with pytest.raises(KeyError):
        st.finish()
    assert st._writer is None
    st.finish()                        # raised once
    with pytest.raises(RuntimeError, match="start_writer"):
        st.submit(0, _shard(0))

    st = ActivationStore(seed=0, queue_depth=2)
    st.start_writer()
    st.submit(0, {"labels": np.zeros(4, np.int32)})
    for _ in range(1000):
        if st._error is not None:
            break
        threading.Event().wait(0.01)
    with pytest.raises(KeyError):
        st.submit(1, _shard(1))
    assert st._writer is None
    st.finish()


def test_writer_takes_host_copies_of_tensors():
    """A tensor handed to ``submit`` is copied to the host at once: a
    later write to it (the next batch reusing the buffer) does not reach
    the stored shard."""
    st = ActivationStore(seed=0)
    st.start_writer()
    buf = torch.ones((4, 3))
    st.submit(0, {"acts": buf, "labels": np.zeros(4, np.int32)})
    buf.fill_(7.0)
    st.finish()
    np.testing.assert_array_equal(st.pool()["acts"], np.ones((4, 3)))
