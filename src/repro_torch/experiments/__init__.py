"""Unified declarative experiment API, as ``repro.experiments``.

``spec``    — frozen, JSON-serializable :class:`ExperimentSpec`.
``systems`` — :class:`System` protocol + ``@register_system`` registry
              (``ampere``, the synchronous baselines and the buffered
              ones, ``fedbuff`` and ``splitfed_pa``).
``runner``  — shared federated-loop machinery (checkpoint/resume,
              journal, early stop, metrics, comm/sim-time accounting).
``api``     — :func:`run_experiment`, the one entry point.
"""

from repro_torch.experiments.api import (build_transport, resolve_setup,
                                         resolve_trace, run_experiment)
from repro_torch.experiments.runner import Runner, StepOutcome
from repro_torch.experiments.spec import (CutPolicy, DataSpec,
                                          ExperimentSpec, FaultSpec,
                                          FleetConfig, ObservabilitySpec,
                                          StreamingSpec, TransportSpec,
                                          dataclass_from_dict,
                                          dataclass_to_dict)
from repro_torch.experiments.systems import (AmpereSystem, System,
                                             SystemContext, get_system,
                                             list_systems, register_system)

__all__ = [
    "AmpereSystem", "CutPolicy", "DataSpec", "ExperimentSpec", "FaultSpec",
    "FleetConfig", "ObservabilitySpec", "Runner", "StepOutcome",
    "StreamingSpec", "System", "SystemContext", "TransportSpec",
    "build_transport", "dataclass_from_dict", "dataclass_to_dict",
    "get_system", "list_systems", "register_system", "resolve_setup",
    "resolve_trace", "run_experiment",
]
