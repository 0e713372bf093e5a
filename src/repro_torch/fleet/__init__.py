"""Event-driven heterogeneous fleet simulation, as ``repro.fleet``.

``profiles``  — device classes and population sampling (latencies priced
                by :mod:`repro_torch.core.comm_model`).
``scheduler`` — deterministic heap-based discrete-event simulator that
                drives ElasticCohort, Heartbeats and RoundJournal; its
                saved traces are the reference's bytes.
``engine``    — the multi-client round over a device-resident sample
                pool.
``cuts``      — per-device-class cut layers: the policy, its cost-model
                resolution and the per-client assignment.
"""

# the engine first: its import of repro_torch.core reaches the spec,
# which imports the cut policy
from repro_torch.fleet.engine import FleetEngine
from repro_torch.fleet.cuts import CutAssignment, CutPolicy, resolve_cuts
from repro_torch.fleet.profiles import (DEVICE_CLASSES, DeviceClass,
                                        DeviceProfile, FleetConfig,
                                        make_latency_fn, sample_population,
                                        trace_round_times)
from repro_torch.fleet.scheduler import FleetScheduler, FleetTrace, RoundPlan

__all__ = [
    "CutAssignment", "CutPolicy", "DEVICE_CLASSES", "DeviceClass",
    "DeviceProfile", "FleetConfig", "FleetEngine", "FleetScheduler",
    "FleetTrace", "RoundPlan", "make_latency_fn", "resolve_cuts",
    "sample_population", "trace_round_times",
]
