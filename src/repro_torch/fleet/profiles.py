"""Device profiles and population sampling for the fleet simulator, as
``repro.fleet.profiles``.

A *device class* is a named (compute, link) scaling of the paper's testbed
constants in :mod:`repro_torch.core.comm_model` — the Jetson tiers reuse the
straggler speed groups of ``FedConfig`` (921/640/320 MHz -> 1.0/0.695/0.347),
the phone tiers extend the population beyond the paper's testbed.  A
*device profile* is one concrete simulated device: its class, absolute
GFLOPS / link bandwidth, churn behaviour (exponential online/offline
sessions) and a per-round dropout hazard.

Per-round latency is NOT re-derived here: :func:`make_latency_fn` calls
:func:`repro_torch.core.comm_model.epoch_time` with a per-profile
:class:`~repro_torch.core.comm_model.TimeModel`, so the fleet simulator and the
paper-figure analytics share one cost model.

Churn durations are expressed in *round units* (multiples of the
population-median round latency) so the same :class:`FleetConfig` behaves
identically for a smoke CNN (millisecond rounds) and a 70B LM (minute
rounds); :class:`repro_torch.fleet.scheduler.FleetScheduler` converts to seconds
at init.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import comm_model


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """Named scaling of the testbed constants."""

    name: str
    speed_factor: float        # x comm_model.DEVICE_GFLOPS
    bandwidth_factor: float    # x comm_model.BANDWIDTH_BPS

    @property
    def gflops(self) -> float:
        return comm_model.DEVICE_GFLOPS * self.speed_factor

    @property
    def bandwidth_bps(self) -> float:
        return comm_model.BANDWIDTH_BPS * self.bandwidth_factor


# Jetson tiers mirror FedConfig.straggler_speed_groups; phone tiers extend
# the population with link-bound (3g) and compute-bound (5g) devices.
DEVICE_CLASSES = {
    "jetson-fast": DeviceClass("jetson-fast", 1.0, 1.0),
    "jetson-mid": DeviceClass("jetson-mid", 0.695, 1.0),
    "jetson-slow": DeviceClass("jetson-slow", 0.347, 1.0),
    "phone-5g": DeviceClass("phone-5g", 0.55, 4.0),
    "phone-3g": DeviceClass("phone-3g", 0.30, 0.15),
}


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """One simulated device in the population."""

    device_id: int
    cls: str                     # DEVICE_CLASSES key
    gflops: float
    bandwidth_bps: float
    mean_session_rounds: float   # expected online stretch, in round units
    mean_off_rounds: float       # expected offline stretch, in round units
    dropout_hazard: float        # per-round mid-round failure probability
    p_online0: float             # probability of being online at t=0

    @property
    def speed_factor(self) -> float:
        return self.gflops / comm_model.DEVICE_GFLOPS


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Population + churn + cohort policy for one fleet simulation."""

    n_devices: int = 200
    class_mix: Tuple[Tuple[str, float], ...] = (
        ("jetson-fast", 0.35), ("jetson-mid", 0.25), ("jetson-slow", 0.15),
        ("phone-5g", 0.15), ("phone-3g", 0.10))
    seed: int = 0
    # churn (round units; scheduler multiplies by median round latency)
    mean_session_rounds: float = 20.0
    mean_off_rounds: float = 6.0
    p_online0: float = 0.75
    dropout_hazard: float = 0.02
    latency_jitter: float = 0.05
    heartbeat_interval_rounds: float = 0.5
    heartbeat_timeout_rounds: float = 1.5
    # probability a beat is lost in flight — with interval 0.5 and
    # timeout 1.5 rounds, three consecutive losses make an online device
    # look dead to cohort selection (so the liveness filter has teeth)
    heartbeat_loss_prob: float = 0.1
    # straggler policy: round deadline = factor * median expected latency
    deadline_factor: float = 0.0      # 0 = wait for the slowest
    # elastic cohort: grow/shrink toward target_round_time_factor * median
    min_cohort: int = 4
    max_cohort: int = 32
    init_cohort: int = 16
    target_round_time_factor: float = 0.0   # 0 = elastic sizing off
    # buffered semi-synchronous (FedBuff-style) aggregation: > 0 switches
    # FleetScheduler.simulate to the async mode — device completions no
    # longer close a round; the server aggregates whenever the update
    # buffer reaches async_buffer_size, and each RoundPlan records the
    # per-client staleness (aggregations since the model version the
    # client trained from).  Elastic sizing and straggler deadlines are
    # synchronous-round policies and are ignored in async mode
    # (max_staleness plays the deadline's role).
    async_buffer_size: int = 0        # M; 0 = synchronous rounds
    max_staleness: int = 0            # discard updates staler than this; 0 = unbounded
    max_concurrent: int = 0           # devices training at once; 0 = init_cohort
    # quorum-degraded synchronous rounds: close the round as soon as this
    # fraction of the cohort has completed (remaining stragglers are
    # recorded as dropped) instead of waiting for the slowest survivor.
    # 1.0 = classic full-quorum behavior.
    quorum_frac: float = 1.0
    # shared uplink: devices of one class contend for that class's link,
    # so the comm share of a dispatch is multiplied by the number of
    # same-class devices uploading concurrently.  Requires a latency_fn
    # that exposes ``.parts`` (see make_latency_fn); off by default so
    # committed traces priced with independent links stay byte-identical.
    shared_uplink: bool = False


def sample_population(cfg: FleetConfig,
                      rng: Optional[np.random.Generator] = None
                      ) -> List[DeviceProfile]:
    """Deterministically sample ``cfg.n_devices`` profiles from the mix."""
    rng = rng if rng is not None else np.random.default_rng(cfg.seed)
    names = [n for n, _ in cfg.class_mix]
    probs = np.asarray([p for _, p in cfg.class_mix], np.float64)
    probs = probs / probs.sum()
    draws = rng.choice(len(names), size=cfg.n_devices, p=probs)
    pop = []
    for d, ci in enumerate(draws):
        c = DEVICE_CLASSES[names[int(ci)]]
        # +-20% intra-class spread so no two devices are exactly identical
        su = 1.0 + 0.2 * (rng.random() - 0.5)
        bu = 1.0 + 0.2 * (rng.random() - 0.5)
        pop.append(DeviceProfile(
            device_id=d, cls=c.name, gflops=c.gflops * su,
            bandwidth_bps=c.bandwidth_bps * bu,
            mean_session_rounds=cfg.mean_session_rounds,
            mean_off_rounds=cfg.mean_off_rounds,
            dropout_hazard=cfg.dropout_hazard,
            p_online0=cfg.p_online0))
    return pop


def make_latency_fn(model, run_cfg, *, algo: str = "ampere",
                    seq_len: int = 0,
                    cuts=None) -> Callable[[DeviceProfile], float]:
    """Per-round latency of one device, through the paper's cost model.

    One federated round processes ``local_steps * device_batch_size``
    samples on the device; :func:`comm_model.epoch_time` prices the local
    compute plus the per-round exchange traffic of ``algo`` (model-only for
    Ampere; activations+gradients every iteration for the SFL family).
    ``split_sizes`` is evaluated once per distinct cut and shared across
    all profiles.

    ``cuts`` maps device-class name -> cut layer (a resolved
    :class:`repro_torch.fleet.cuts.CutAssignment`'s ``by_class``); a class
    not in the map prices at ``run_cfg.split.split_point``.  The returned
    callable carries a ``.parts(profile) -> (compute_s, comm_s)``
    attribute (:func:`comm_model.epoch_time_parts`) so the scheduler can
    stretch only the link-bound share under ``FleetConfig.shared_uplink``.
    """
    fed = run_cfg.fed
    n_round_samples = fed.local_steps * fed.device_batch_size
    split_by_class = {name: dataclasses.replace(run_cfg.split,
                                                split_point=int(p))
                      for name, p in dict(cuts or {}).items()}
    sizes_cache = {}

    def price(fn, profile: DeviceProfile):
        split_cfg = split_by_class.get(profile.cls, run_cfg.split)
        p = split_cfg.split_point
        if p not in sizes_cache:
            sizes_cache[p] = comm_model.split_sizes(model, split_cfg,
                                                    seq_len=max(seq_len, 1))
        tm = comm_model.TimeModel(device_gflops=profile.gflops,
                                  bandwidth=profile.bandwidth_bps)
        return fn(algo, model, split_cfg, tm, n_samples=n_round_samples,
                  batch_size=fed.device_batch_size, seq_len=seq_len,
                  sizes=sizes_cache[p])

    def latency(profile: DeviceProfile) -> float:
        return price(comm_model.epoch_time, profile)

    def parts(profile: DeviceProfile):
        return price(comm_model.epoch_time_parts, profile)

    latency.parts = parts
    return latency


def trace_round_times(trace, population: Sequence[DeviceProfile],
                      latency_fn: Callable[[DeviceProfile], float]
                      ) -> List[float]:
    """Re-price a trace's rounds under a different algorithm's latency
    (synchronous round = slowest surviving participant)."""
    by_id = {p.device_id: p for p in population}
    out = []
    for plan in trace.rounds:
        parts = list(plan.clients) or list(plan.dropped)
        out.append(max(latency_fn(by_id[int(d)]) for d in parts))
    return out
