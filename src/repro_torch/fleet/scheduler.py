"""Deterministic discrete-event fleet scheduler, as
``repro.fleet.scheduler``: from the same population, latency function and
config it draws the same numbers in the same order, breaks heap ties the
same way and writes the same floats, so a saved trace is the same bytes.

Replaces the implicit "all K clients, lock-step" cohort of
:func:`repro_torch.core.aggregation.sample_cohort` with an explicit event queue
over a population of N >> K simulated devices.  The scheduler owns wall
clock time; everything else is a consumer:

* :class:`repro_torch.runtime.elastic.ElasticCohort` — resized from *measured*
  round durations (grow when rounds beat the target, shrink when they
  blow it; the 0.8x / 1.25x hysteresis lives in ElasticCohort.adjust).
* :class:`repro_torch.runtime.fault_tolerance.Heartbeats` — fed from simulated
  device heartbeat events; cohort selection only considers devices whose
  last beat is within the timeout.
* :class:`repro_torch.runtime.fault_tolerance.RoundJournal` — one record per
  finished round (optional), so a coordinator can replay the schedule.

Event kinds (heap-ordered by (time, seq); seq breaks ties deterministically):

  ``online`` / ``offline``  — churn transitions (exponential sessions)
  ``assign``                — device picked into the active round's cohort
  ``complete``              — device finished its H local steps + exchange
  ``dropout``               — device failed mid-round (churn or hazard)
  ``deadline``              — straggler deadline fired; stragglers dropped
  ``heartbeat``             — periodic liveness beat while online
  ``round_end``             — all participants resolved (or deadline)

The simulation is *time-only*: it decides who trains when, never touching
model math, so one trace can drive both the Ampere trainer and an SFL
baseline — and ``simulate()`` is pure given
(population, latency_fn, seed): same seed => identical event trace.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.profiles import DeviceProfile, FleetConfig
from repro_torch.runtime.elastic import ElasticCohort
from repro_torch.runtime.fault_tolerance import Heartbeats, RoundJournal
from repro_torch.transport.framing import crc32


def required_quorum(n: int, frac: float) -> int:
    """Verified completions needed for a cohort of ``n`` (at least one),
    as ``repro.transport.inprocess.required_quorum``."""
    return max(1, int(math.ceil(frac * n - 1e-9)))


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One scheduled federated round (the trace unit trainers consume).

    Synchronous plans leave ``staleness`` empty.  Buffered-async plans
    (``FleetConfig.async_buffer_size > 0``) fill it with one entry per
    client: how many aggregations happened between the global-model
    version the client trained from and this one (``round_idx -
    staleness[i]`` is the version it started from), and ``weights``
    carry the normalized ``1/sqrt(1+s)`` staleness scaling."""

    round_idx: int
    t_start: float
    t_end: float
    clients: Tuple[int, ...]       # surviving device ids
    weights: Tuple[float, ...]     # aggregation weights over survivors
    dropped: Tuple[int, ...]       # failed / straggler-dropped device ids
    cohort_size: int               # K at selection time (elastic)
    round_time: float              # t_end - t_start
    staleness: Tuple[int, ...] = ()  # async only: per-client staleness

    def as_cohort(self) -> dict:
        """``aggregation.sample_cohort``-shaped dict for legacy consumers.

        Deliberately does NOT carry ``round_time``: the plan's time was
        priced for the algorithm the trace was *scheduled* with, so a
        baseline replaying the cohorts must either re-price it explicitly
        (``dict(p.as_cohort(), round_time=t)`` with
        :func:`repro_torch.fleet.profiles.trace_round_times`) or let the
        replaying trainer's own analytic model price the round."""
        return {"clients": np.asarray(self.clients, np.int64),
                "weights": np.asarray(self.weights, np.float64),
                "dropped": np.asarray(self.dropped, np.int64),
                "cohort_size": self.cohort_size}


@dataclasses.dataclass
class FleetTrace:
    rounds: List[RoundPlan]
    events: List[Tuple[float, str, int, int]]   # (time, kind, device, round)
    cohort_sizes: List[int]                     # elastic K per round

    @property
    def total_time(self) -> float:
        return self.rounds[-1].t_end if self.rounds else 0.0

    @property
    def is_async(self) -> bool:
        """True for buffered-async traces (plans carry staleness)."""
        return bool(self.rounds) and all(p.staleness for p in self.rounds)

    @staticmethod
    def peek_is_async(path: str) -> bool:
        """Cheaply determine a saved trace's kind without a full load:
        stream to the first round record and check for staleness (spec
        validation uses this to reject sync/async system-trace
        mismatches up front)."""
        import json
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec.get("kind") == "round":
                    return bool(rec.get("staleness"))
        return False

    # ------------------------------------------------------------------
    # JSONL (de)serialization — generate a schedule once, replay it
    # anywhere (floats round-trip exactly through repr, so a loaded trace
    # replays byte-identical rounds)
    # ------------------------------------------------------------------
    def save(self, path: str, *, events: bool = True):
        """Stream the trace to JSONL: one header line, one line per
        round, then (optionally) one line per raw scheduler event.
        Round records stream out one at a time — a multi-million-device
        schedule never needs to materialize a second copy in memory."""
        import json
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "header",
                                "format": "fleet-trace-v1",
                                "num_rounds": len(self.rounds)}) + "\n")
            for p in self.rounds:
                rec = {
                    "kind": "round", "round_idx": p.round_idx,
                    "t_start": p.t_start, "t_end": p.t_end,
                    "clients": list(p.clients),
                    "weights": list(p.weights),
                    "dropped": list(p.dropped),
                    "cohort_size": p.cohort_size,
                    "round_time": p.round_time}
                if p.staleness:    # async plans only; sync format unchanged
                    rec["staleness"] = list(p.staleness)
                # per-record CRC over the canonical JSON so a bit flip or
                # tear inside one round line is detected at load, not
                # silently replayed as a different cohort
                rec["_crc"] = crc32(json.dumps(
                    rec, sort_keys=True, separators=(",", ":")).encode())
                f.write(json.dumps(rec) + "\n")
            if events:
                for t, kind, dev, rnd in self.events:
                    f.write(json.dumps({"kind": "event", "t": t, "e": kind,
                                        "dev": dev, "round": rnd}) + "\n")

    @classmethod
    def load(cls, path: str) -> "FleetTrace":
        """Stream a JSONL trace back; tolerates event lines being absent
        (``save(events=False)``) and ignores unknown record kinds so the
        format can grow.  The header's ``num_rounds`` is validated
        against the parsed round count: a trace truncated by a killed
        writer raises instead of silently replaying fewer rounds."""
        import json
        rounds: List[RoundPlan] = []
        events: List[Tuple[float, str, int, int]] = []
        declared = None
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                crc = rec.pop("_crc", None) if isinstance(rec, dict) else None
                if crc is not None and crc != crc32(json.dumps(
                        rec, sort_keys=True, separators=(",", ":")).encode()):
                    raise ValueError(
                        f"trace {path!r} has a corrupt record (CRC "
                        "mismatch — bit flip or torn write); regenerate "
                        f"the trace: {line[:120]!r}")
                kind = rec.get("kind")
                if kind == "header":
                    declared = rec.get("num_rounds")
                elif kind == "round":
                    rounds.append(RoundPlan(
                        round_idx=int(rec["round_idx"]),
                        t_start=float(rec["t_start"]),
                        t_end=float(rec["t_end"]),
                        clients=tuple(int(c) for c in rec["clients"]),
                        weights=tuple(float(w) for w in rec["weights"]),
                        dropped=tuple(int(d) for d in rec["dropped"]),
                        cohort_size=int(rec["cohort_size"]),
                        round_time=float(rec["round_time"]),
                        staleness=tuple(int(s) for s in
                                        rec.get("staleness", ()))))
                elif kind == "event":
                    events.append((float(rec["t"]), str(rec["e"]),
                                   int(rec["dev"]), int(rec["round"])))
        if declared is not None and len(rounds) != int(declared):
            raise ValueError(
                f"trace {path!r} is truncated: header declares "
                f"{int(declared)} rounds but {len(rounds)} were read — the "
                "writer likely died mid-save; regenerate the trace")
        return cls(rounds=rounds, events=events,
                   cohort_sizes=[p.cohort_size for p in rounds])


class _Round:
    """Mutable state of the round currently in flight."""

    __slots__ = ("idx", "t_start", "cohort_size", "pending", "expected",
                 "survivors", "dropped")

    def __init__(self, idx, t_start, cohort_size):
        self.idx = idx
        self.t_start = t_start
        self.cohort_size = cohort_size
        self.pending = {}     # device -> scheduled resolve time
        self.expected = {}    # device -> planned completion (no failures)
        self.survivors = {}   # device -> completion time
        self.dropped = set()


class FleetScheduler:
    """Seeded heap-based simulator producing a :class:`FleetTrace`.

    ``latency_fn(profile) -> seconds`` prices one round on one device
    (see :func:`repro_torch.fleet.profiles.make_latency_fn`); the population
    median of it is the time unit that the config's round-denominated
    churn/heartbeat/target knobs are scaled by.

    ``simulate`` re-seeds all mutable state, so the same scheduler object
    yields the identical trace on every call.
    """

    def __init__(self, population: Sequence[DeviceProfile],
                 latency_fn: Callable[[DeviceProfile], float],
                 cfg: Optional[FleetConfig] = None, *,
                 seed: Optional[int] = None,
                 journal: Optional[RoundJournal] = None,
                 tracer=None):
        self.pop = list(population)
        self.cfg = cfg or FleetConfig(n_devices=len(self.pop))
        self.latency_fn = latency_fn
        self.seed = self.cfg.seed if seed is None else seed
        self.journal = journal
        # optional repro_torch.observability.Tracer: the heap's loop stays
        # as it is, and the finished trace is replayed into sim-domain
        # scheduler spans after simulate()
        self.tracer = tracer
        self._lat = {p.device_id: float(latency_fn(p)) for p in self.pop}
        self.base_latency = float(np.median(list(self._lat.values())))
        self._by_id = {p.device_id: p for p in self.pop}
        # opt-in shared-uplink contention: a device class's profiled
        # bandwidth is one shared link, so N same-class concurrent
        # uploaders each see comm stretched N-fold.  Needs the latency
        # split into (compute, comm) — make_latency_fn exposes ``.parts``;
        # with a plain-lambda latency fn (or shared_uplink=False) the
        # legacy whole-latency pricing is untouched.
        self._parts = None
        parts_fn = getattr(latency_fn, "parts", None)
        if self.cfg.shared_uplink and parts_fn is not None:
            self._parts = {p.device_id: tuple(float(x) for x in parts_fn(p))
                           for p in self.pop}
        self._reset()

    def _reset(self):
        self.rng = np.random.default_rng(self.seed)
        self.heartbeats = Heartbeats(
            timeout=self.cfg.heartbeat_timeout_rounds * self.base_latency)
        self.elastic = None
        if self.cfg.target_round_time_factor > 0:
            self.elastic = ElasticCohort(
                min_clients=self.cfg.min_cohort,
                max_clients=self.cfg.max_cohort,
                current=self.cfg.init_cohort)
        self._target = (self.cfg.target_round_time_factor * self.base_latency
                        if self.elastic else 0.0)

    # ------------------------------------------------------------------
    def cohort_size(self) -> int:
        return self.elastic.current if self.elastic else self.cfg.init_cohort

    def _exp(self, mean_rounds: float) -> float:
        return float(self.rng.exponential(mean_rounds * self.base_latency))

    # ------------------------------------------------------------------
    def simulate(self, num_rounds: int) -> FleetTrace:
        """Produce a ``num_rounds``-round trace.

        Synchronous by default; with ``cfg.async_buffer_size > 0`` each
        "round" is one buffered aggregation (see :meth:`_simulate_async`).
        """
        if self.cfg.async_buffer_size > 0:
            trace = self._simulate_async(num_rounds)
        else:
            trace = self._simulate_sync(num_rounds)
        if self.tracer is not None:
            self.tracer.ingest_fleet_trace(trace)
        return trace

    def _seed_population(self, push, online, next_offline, hb_dt):
        """t=0 churn/heartbeat seeding shared by both simulation modes."""
        for p in self.pop:
            d = p.device_id
            if self.rng.random() < p.p_online0:
                online[d] = True
                off_t = self._exp(p.mean_session_rounds)
                next_offline[d] = off_t
                push(off_t, "offline", d)
                self.heartbeats.beat(d, now=0.0)
                push(hb_dt * (0.5 + 0.5 * self.rng.random()), "heartbeat", d)
            else:
                online[d] = False
                push(self._exp(p.mean_off_rounds), "online", d)

    def _available(self, online, busy, now):
        alive = self.heartbeats.alive(
            [d for d, on in online.items() if on and d not in busy],
            now=now)
        return sorted(int(a) for a in alive)

    def _make_churn_handler(self, online, next_offline, push, events,
                            hb_dt):
        """Online/offline churn handling shared by both simulation modes
        (the subtle re-churn staleness logic lives in exactly one place).

        Returns a closure ``handle(kind, d, t, rnd_idx)`` over the
        caller's loop state; it returns the consumed kind ("online" lets
        the caller react to a device becoming dispatchable), "stale" for
        events obsoleted by a re-churn, or None when ``kind`` is not a
        churn event.  The even hotter *heartbeat* branch is deliberately
        NOT here: it fires for most of a multi-100k-event simulation, so
        both loops inline it to keep the per-event call overhead off the
        hot path.
        """
        exp = self._exp
        by_id = self._by_id
        beat = self.heartbeats.beat

        def handle(kind, d, t, rnd_idx):
            if kind == "online":
                if online.get(d):
                    return "stale"
                online[d] = True
                events.append((t, "online", d, rnd_idx))
                off_t = t + exp(by_id[d].mean_session_rounds)
                next_offline[d] = off_t
                push(off_t, "offline", d)
                beat(d, now=t)
                push(t + hb_dt, "heartbeat", d)
                return "online"
            if kind == "offline":
                # stale if the device re-churned; trust next_offline
                if not online.get(d) or next_offline.get(d, -1.0) > t:
                    return "stale"
                online[d] = False
                events.append((t, "offline", d, rnd_idx))
                push(t + exp(by_id[d].mean_off_rounds), "online", d)
                # mid-round failures were pre-scheduled as dropout events
                return "offline"
            return None

        return handle

    def _price_dispatch(self, d, now, next_offline, n_shared: int = 1):
        """Jittered latency + failure time for one dispatched device.

        ``fail_t`` is None when the device will complete; otherwise the
        earlier of its scheduled churn-off and a mid-round hazard draw.
        ``n_shared`` (shared-uplink mode only) is the number of same-class
        devices transferring concurrently — the comm term stretches
        ``n_shared``-fold while compute is unaffected.  Exactly one rng
        draw either way, so legacy schedules replay bit-identically.
        """
        if self._parts is not None and n_shared > 1:
            comp, comm = self._parts[d]
            lat = (comp + comm * n_shared) * (1.0 + self.cfg.latency_jitter
                                              * self.rng.random())
        else:
            lat = self._lat[d] * (1.0 + self.cfg.latency_jitter
                                  * self.rng.random())
        done_t = now + lat
        fail_t = None
        if next_offline.get(d, np.inf) <= done_t:
            fail_t = next_offline[d]              # churns off mid-round
        if self.rng.random() < self._by_id[d].dropout_hazard:
            hz_t = now + self.rng.random() * lat
            fail_t = hz_t if fail_t is None else min(fail_t, hz_t)
        return lat, done_t, fail_t

    # ------------------------------------------------------------------
    def _simulate_sync(self, num_rounds: int) -> FleetTrace:
        self._reset()
        cfg = self.cfg
        heap: list = []
        seq = [0]

        def push(t, kind, dev=-1, rnd_idx=-1):
            heapq.heappush(heap, (float(t), seq[0], kind, int(dev), rnd_idx))
            seq[0] += 1

        online = {}                 # device_id -> bool
        next_offline = {}           # device_id -> scheduled churn-off time
        busy = set()
        events: List[Tuple[float, str, int, int]] = []
        rounds: List[RoundPlan] = []
        cohort_sizes: List[int] = []
        hb_dt = cfg.heartbeat_interval_rounds * self.base_latency
        cur = _Round(0, 0.0, 0)
        waiting = [False]

        self._seed_population(push, online, next_offline, hb_dt)

        def available(now):
            return self._available(online, busy, now)

        def start_round(now) -> bool:
            avail = available(now)
            if not avail:
                waiting[0] = True
                return False
            waiting[0] = False
            K = min(self.cohort_size(), len(avail))
            chosen = self.rng.choice(np.asarray(avail), size=K,
                                     replace=False)
            nonlocal cur
            cur = _Round(cur.idx, now, K)
            # shared uplink: every chosen same-class device exchanges its
            # model at round start concurrently, splitting the class link
            n_cls = None
            if self._parts is not None:
                n_cls = {}
                for c in chosen:
                    cls = self._by_id[int(c)].cls
                    n_cls[cls] = n_cls.get(cls, 0) + 1
            lats = []
            for d in (int(c) for c in chosen):
                busy.add(d)
                events.append((now, "assign", d, cur.idx))
                lat, done_t, fail_t = self._price_dispatch(
                    d, now, next_offline,
                    n_cls[self._by_id[d].cls] if n_cls else 1)
                lats.append(lat)
                cur.expected[d] = done_t
                if fail_t is not None:
                    cur.pending[d] = fail_t
                    push(fail_t, "dropout", d, cur.idx)
                else:
                    cur.pending[d] = done_t
                    push(done_t, "complete", d, cur.idx)
            if cfg.deadline_factor > 0 and lats:
                push(now + cfg.deadline_factor * float(np.median(lats)),
                     "deadline", -1, cur.idx)
            return True

        def finish_round(now):
            nonlocal cur
            if not cur.survivors:
                # never lose the whole round: keep the fastest participant.
                # Its planned completion may lie beyond the last dropout,
                # so the round ends when IT finishes, not at the failure.
                fastest = min(cur.expected, key=cur.expected.get)
                cur.survivors[fastest] = cur.expected[fastest]
                cur.dropped.discard(fastest)
                now = max(now, cur.expected[fastest])
            ids = tuple(sorted(cur.survivors))
            w = (1.0 / len(ids),) * len(ids)
            for d in cur.expected:
                busy.discard(d)
            plan = RoundPlan(
                round_idx=cur.idx, t_start=cur.t_start, t_end=now,
                clients=ids, weights=w, dropped=tuple(sorted(cur.dropped)),
                cohort_size=cur.cohort_size, round_time=now - cur.t_start)
            rounds.append(plan)
            cohort_sizes.append(cur.cohort_size)
            events.append((now, "round_end", -1, cur.idx))
            if self.elastic is not None:
                self.elastic.adjust(plan.round_time, self._target)
            if self.journal is not None:
                self.journal.append({
                    "phase": "fleet-sched", "round": cur.idx,
                    "t_end": round(now, 9), "clients": list(ids),
                    "dropped": [int(x) for x in plan.dropped],
                    "cohort_size": cur.cohort_size})
            cur = _Round(cur.idx + 1, now, 0)
            return now

        def maybe_advance(now):
            if not cur.pending:
                end = finish_round(now)
                if len(rounds) < num_rounds:
                    start_round(end)

        churn_of = self._make_churn_handler(online, next_offline,
                                            push, events, hb_dt)
        rand = self.rng.random
        beat = self.heartbeats.beat
        loss_prob = cfg.heartbeat_loss_prob
        start_round(0.0)
        while heap and len(rounds) < num_rounds:
            t, _, kind, d, rnd_idx = heapq.heappop(heap)
            if kind == "heartbeat":          # hot path, kept inline
                if online.get(d):
                    # beats can be lost in flight; enough consecutive
                    # losses and cohort selection treats the device as
                    # dead (Heartbeats timeout) until a beat lands again
                    if rand() >= loss_prob:
                        beat(d, now=t)
                        events.append((t, "heartbeat", d, cur.idx))
                    push(t + hb_dt, "heartbeat", d)
            elif kind == "complete":
                if rnd_idx != cur.idx or d not in cur.pending:
                    continue   # stale: round already closed by deadline
                del cur.pending[d]
                cur.survivors[d] = t
                self.heartbeats.beat(d, now=t)
                events.append((t, "complete", d, cur.idx))
                # quorum-degraded close: once the configured fraction of
                # the cohort has verified completions, remaining
                # stragglers are dropped instead of waited for
                if cfg.quorum_frac < 1.0 and cur.pending and \
                        len(cur.survivors) >= required_quorum(
                            cur.cohort_size, cfg.quorum_frac):
                    events.append((t, "quorum", -1, cur.idx))
                    for s in list(cur.pending):
                        del cur.pending[s]
                        cur.dropped.add(s)
                maybe_advance(t)
            elif kind == "dropout":
                if rnd_idx != cur.idx or d not in cur.pending:
                    continue
                del cur.pending[d]
                cur.dropped.add(d)
                events.append((t, "dropout", d, cur.idx))
                maybe_advance(t)
            elif kind == "deadline":
                if rnd_idx != cur.idx or not cur.pending:
                    continue
                events.append((t, "deadline", -1, cur.idx))
                for s in list(cur.pending):
                    del cur.pending[s]
                    cur.dropped.add(s)
                maybe_advance(t)
            elif churn_of(kind, d, t, cur.idx) == "online" and waiting[0]:
                start_round(t)

        return FleetTrace(rounds=rounds, events=events,
                          cohort_sizes=cohort_sizes)

    # ------------------------------------------------------------------
    # Buffered semi-synchronous mode (FedBuff-style)
    # ------------------------------------------------------------------
    def _simulate_async(self, num_rounds: int) -> FleetTrace:
        """Buffered semi-synchronous schedule over the same event queue.

        Up to ``max_concurrent`` devices train at any moment, each from
        the global-model version current when it was dispatched.  A
        completion never closes a round: the update enters the server's
        buffer (unless its staleness exceeds ``max_staleness`` — then it
        is discarded and recorded as dropped) and the freed slot is
        refilled immediately.  When the buffer reaches
        ``async_buffer_size`` the server aggregates: one
        :class:`RoundPlan` whose ``staleness`` records, per client, how
        many aggregations happened since the version it trained from and
        whose ``weights`` carry the normalized ``1/sqrt(1+s)`` scaling
        (:func:`repro_torch.core.aggregation.staleness_weights`).  Stragglers
        therefore overlap later rounds instead of gating the cohort —
        the ``round_end`` event marks the aggregation instant.

        Deterministic like the sync mode: seeded rng, ``(time, seq)``
        heap ordering, no wall clock.
        """
        from repro_torch.core.aggregation import staleness_weights

        self._reset()
        cfg = self.cfg
        M = cfg.async_buffer_size
        C = cfg.max_concurrent if cfg.max_concurrent > 0 else cfg.init_cohort
        S = cfg.max_staleness               # 0 = unbounded
        heap: list = []
        seq = [0]

        def push(t, kind, dev=-1, rnd_idx=-1):
            heapq.heappush(heap, (float(t), seq[0], kind, int(dev), rnd_idx))
            seq[0] += 1

        online = {}
        next_offline = {}
        events: List[Tuple[float, str, int, int]] = []
        rounds: List[RoundPlan] = []
        cohort_sizes: List[int] = []
        hb_dt = cfg.heartbeat_interval_rounds * self.base_latency
        version = [0]               # aggregation counter = round_idx
        # in_flight doubles as the busy set for availability (its key set
        # IS the set of dispatched devices — no parallel state to drift)
        in_flight = {}              # device -> base model version
        buffer: List[Tuple[int, int]] = []          # (device, staleness)
        dropped_since: List[int] = []
        last_agg = [0.0]

        self._seed_population(push, online, next_offline, hb_dt)

        def fill(now):
            """Dispatch available devices into free concurrency slots.

            New dispatches train from the CURRENT global version — the
            plan's per-client staleness is the number of aggregations
            that land between this moment and the update's own.
            """
            free = C - len(in_flight)
            if free <= 0:
                return
            avail = self._available(online, in_flight, now)
            if not avail:
                return
            n = min(free, len(avail))
            chosen = self.rng.choice(np.asarray(avail), size=n,
                                     replace=False)
            for d in (int(c) for c in chosen):
                in_flight[d] = version[0]
                events.append((now, "assign", d, version[0]))
                n_shared = 1
                if self._parts is not None:
                    # async: the class link is split among all in-flight
                    # same-class devices at dispatch time
                    cls = self._by_id[d].cls
                    n_shared = sum(1 for x in in_flight
                                   if self._by_id[x].cls == cls)
                _, done_t, fail_t = self._price_dispatch(
                    d, now, next_offline, n_shared)
                if fail_t is not None:
                    push(fail_t, "dropout", d, version[0])
                else:
                    push(done_t, "complete", d, version[0])

        def aggregate(now):
            pairs = sorted(buffer)
            ids = tuple(d for d, _ in pairs)
            stal = tuple(s for _, s in pairs)
            w = tuple(float(x) for x in staleness_weights(stal))
            dropped = tuple(sorted(set(dropped_since) - set(ids)))
            plan = RoundPlan(
                round_idx=version[0], t_start=last_agg[0], t_end=now,
                clients=ids, weights=w, dropped=dropped,
                cohort_size=len(ids) + len(dropped),
                round_time=now - last_agg[0], staleness=stal)
            rounds.append(plan)
            cohort_sizes.append(plan.cohort_size)
            events.append((now, "round_end", -1, version[0]))
            if self.journal is not None:
                self.journal.append({
                    "phase": "fleet-sched", "round": version[0],
                    "t_end": round(now, 9), "clients": list(ids),
                    "staleness": list(stal),
                    "dropped": [int(x) for x in dropped],
                    "cohort_size": plan.cohort_size})
            buffer.clear()
            dropped_since.clear()
            version[0] += 1
            last_agg[0] = now

        churn_of = self._make_churn_handler(online, next_offline,
                                            push, events, hb_dt)
        rand = self.rng.random
        beat = self.heartbeats.beat
        loss_prob = cfg.heartbeat_loss_prob
        # progress guard: unlike the sync mode (a round closes even when
        # every member drops), only aggregations advance the round count
        # here, while heartbeat/churn events self-perpetuate — a
        # population that can never fill the buffer (e.g. every dispatch
        # fails) would spin forever.  Fail loudly instead.
        guard = 1000 * (len(self.pop) + M)
        since_agg = 0
        fill(0.0)
        while heap and len(rounds) < num_rounds:
            since_agg += 1
            if since_agg > guard:
                raise RuntimeError(
                    f"async fleet simulation made no progress: {guard} "
                    f"events since the last aggregation with the buffer "
                    f"at {len(buffer)}/{M} — the population cannot fill "
                    "the update buffer (all dispatches failing?); lower "
                    "async_buffer_size or fix the churn/hazard config")
            t, _, kind, d, v = heapq.heappop(heap)
            if kind == "heartbeat":          # hot path, kept inline
                if online.get(d):
                    if rand() >= loss_prob:
                        beat(d, now=t)
                        events.append((t, "heartbeat", d, version[0]))
                    push(t + hb_dt, "heartbeat", d)
            elif kind == "complete":
                if in_flight.get(d) != v:
                    continue        # stale: already dropped / re-dispatched
                del in_flight[d]
                self.heartbeats.beat(d, now=t)
                s = version[0] - v
                if S > 0 and s > S:
                    # too stale to incorporate — the async analogue of
                    # the synchronous straggler deadline
                    events.append((t, "stale_drop", d, version[0]))
                    dropped_since.append(d)
                else:
                    events.append((t, "complete", d, version[0]))
                    buffer.append((d, s))
                    if len(buffer) >= M:
                        aggregate(t)
                        since_agg = 0
                fill(t)
            elif kind == "dropout":
                if in_flight.get(d) != v:
                    continue
                del in_flight[d]
                dropped_since.append(d)
                events.append((t, "dropout", d, version[0]))
                fill(t)
            elif churn_of(kind, d, t, version[0]) == "online":
                fill(t)

        return FleetTrace(rounds=rounds, events=events,
                          cohort_sizes=cohort_sizes)
