"""Shared federated-loop machinery, as ``repro.experiments.runner``.

A :class:`Runner` owns the :class:`~repro_torch.runtime.metrics
.MetricsLogger`, :class:`~repro_torch.runtime.checkpoint.Checkpointer`,
:class:`~repro_torch.runtime.fault_tolerance.RoundJournal` and the shared
``history`` dict, and :meth:`Runner.run_phase` drives one phase given a
*body* callback that does only the step math and returns a
:class:`StepOutcome`: the new loop-carried state, the history record
(which must carry the monitored key when early stopping is on), and the
step's accounting.

A checkpoint's metadata holds the phase, the step, the early stopper's
state — as the reference's — and, beyond it, a copy of ``history`` and
the caller's host-side state (``host_state``: the trainer's cohort and
batch generators).  :meth:`Runner.restore` puts both back, so a run
killed mid-phase and resumed gives the same history, bytes and simulated
time as one that was never interrupted.

``obs`` (an :class:`~repro_torch.observability.Observability` bundle) gets
the simulated clock bound, a ``{phase}.{step_name}`` span around each
step and the ``steps`` / ``comm_bytes`` / ``step_wall_s`` /
``step_sim_s`` metrics; ``fault_plan`` (a
:class:`~repro_torch.transport.FaultPlan`) tears checkpoint and journal
writes on purpose for the chaos runs.  Neither changes a history.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Iterable, Optional, Tuple

from repro_torch.observability import NULL_OBS
from repro_torch.runtime.checkpoint import (CheckpointCorruptError,
                                            Checkpointer)
from repro_torch.runtime.fault_tolerance import RoundJournal
from repro_torch.runtime.metrics import MetricsLogger


@dataclasses.dataclass
class StepOutcome:
    """What one loop step hands back to the :class:`Runner`.

    ``record`` is appended verbatim to ``history[history_key]``; ``log``
    holds extra log-only fields that do not enter the history.
    """

    state: Any
    record: dict
    comm_bytes: int = 0
    sim_time: float = 0.0
    log: dict = dataclasses.field(default_factory=dict)


class Runner:
    """Owns the cross-cutting pieces of every federated training loop.

    One Runner is shared by all phases of one run: ``history`` accumulates
    ``comm_bytes`` / ``sim_time`` across phases, and the checkpoints and
    journal are phase-tagged so a restarted run resumes each phase where
    it stopped.  ``device`` is where restored tensors go; ``host_state``
    is an optional ``(get, set)`` pair of callables whose JSON-able state
    rides in every checkpoint's metadata.
    """

    def __init__(self, workdir: Optional[str] = None, *,
                 patience: int = 15, log_echo: bool = False,
                 log_name: str = "metrics.jsonl",
                 history: Optional[dict] = None, device="cpu",
                 host_state: Optional[Tuple[Callable[[], dict],
                                            Callable[[dict], None]]] = None,
                 fault_plan=None, obs=None):
        self.workdir = workdir
        self.patience = patience
        self.device = device
        self.host_state = host_state
        self.obs = obs if obs is not None else NULL_OBS
        self.history = history if history is not None else {}
        self.history.setdefault("comm_bytes", 0)
        self.history.setdefault("sim_time", 0.0)
        # stamped with the simulated clock, so logs of identical runs
        # diff clean; the history dict must exist before the logger reads
        self.log = MetricsLogger(
            os.path.join(workdir, log_name) if workdir else None,
            echo=log_echo, clock=lambda: self.history["sim_time"])
        self.obs.tracer.bind_sim_clock(lambda: self.history["sim_time"])
        self.ckpt = Checkpointer(os.path.join(workdir, "ckpt"),
                                 fault_plan=fault_plan) if workdir else None
        self.journal = RoundJournal(os.path.join(workdir, "journal.jsonl"),
                                    fault_plan=fault_plan) \
            if workdir else None
        # early-stop state restored per phase by restore(), consumed by the
        # next run_phase of that phase
        self._stopper_state: dict = {}

    # ------------------------------------------------------------------
    def close(self):
        """Release the metrics-log handle (idempotent).
        :func:`repro_torch.experiments.run_experiment` calls it in a
        ``finally``, so a mid-round
        :class:`~repro_torch.transport.QuorumError` leaks no handle."""
        self.log.close()

    # ------------------------------------------------------------------
    def restore(self, phase: str, state, *, step_name: str = "round"
                ) -> Tuple[Any, int]:
        """(state, first_step) from the newest valid checkpoint of
        ``phase``; a torn or bit-flipped snapshot is skipped for the next
        older one.  Restores ``history`` and the host state with it."""
        if self.ckpt is None:
            return state, 0
        for step in self.ckpt.steps_matching(
                lambda m: m.get("phase") == phase):
            try:
                tree, meta = self.ckpt.restore(step, device=self.device)
            except CheckpointCorruptError:
                continue
            if meta.get("stopper") is not None:
                self._stopper_state[phase] = meta["stopper"]
            if meta.get("history") is not None:
                self.history.clear()       # in place: trainers alias it
                self.history.update(meta["history"])
            if meta.get("host") is not None and self.host_state is not None:
                self.host_state[1](meta["host"])
            return tree, meta[step_name] + 1
        return state, 0

    def account(self, *, comm_bytes: int = 0, sim_time: float = 0.0,
                phase: Optional[str] = None, direction: str = "up"):
        """Out-of-loop accounting (the one-shot activation upload);
        ``phase`` also attributes the bytes and time to that phase's
        metrics row (the history totals are the same either way)."""
        self.history["comm_bytes"] += comm_bytes
        self.history["sim_time"] += sim_time
        if phase is not None and self.obs.enabled:
            m = self.obs.metrics
            if comm_bytes:
                m.counter("comm_bytes", comm_bytes, phase=phase,
                          direction=direction)
            if sim_time:
                m.observe("step_sim_s", sim_time, phase=phase)

    def exchange_log(self, transport, log: dict, *, phase: str,
                     one_way_bytes: int, excluded) -> dict:
        """One round's model exchange in ``log`` and the metrics: the
        exclusions (under faults) and the transport's statistics since the
        last round go into ``log``; the cohort's analytic bytes each way
        (``one_way_bytes``) and the exclusions into ``phase``'s metrics
        (the step's undirected ``comm_bytes`` is the wire's total)."""
        if transport is not None and transport.faulty:
            log["excluded"] = len(excluded)
        if transport is not None:
            log["wire"] = transport.delta_stats()
        if self.obs.enabled:
            m = self.obs.metrics
            m.counter("comm_bytes", one_way_bytes, phase=phase,
                      direction="down")
            m.counter("comm_bytes", one_way_bytes, phase=phase,
                      direction="up")
            if excluded:
                m.counter("excluded_devices", len(excluded), phase=phase)
        return log

    # ------------------------------------------------------------------
    def run_phase(self, phase: str, state,
                  plans: Iterable[Tuple[int, Any]],
                  body: Callable[[Any, int, Any], StepOutcome], *,
                  history_key: str, monitor: Optional[str] = None,
                  mode: str = "min", checkpoint_every: int = 0,
                  ckpt_offset: int = 0, step_name: str = "round",
                  patience: Optional[int] = None):
        """Drive one phase: ``plans`` yields ``(step_idx, plan)``,
        ``body(state, step_idx, plan)`` does the step math; history,
        accounting, logging, checkpointing (after steps ``every - 1``,
        ``2 every - 1``, ...), journaling and early stopping happen here.

        The body owns the state it is given: the Runner keeps no reference
        to it while the body runs, so a body that rebinds its argument to
        the step's new state frees the old one (its optimizer buffers, as
        the reference's donated epoch does) before it goes on to evaluate.
        ``state`` may come in a one-element list, which is emptied here:
        a caller that hands its state over so keeps no reference either."""
        # imported here: repro_torch.core imports the trainer, which
        # imports this module
        from repro_torch.core.evaluate import EarlyStopper

        slot = state if isinstance(state, list) else [state]
        del state
        self.history.setdefault(history_key, [])
        stopper = EarlyStopper(
            self.patience if patience is None else patience, mode=mode)
        restored = self._stopper_state.pop(phase, None)
        if restored is not None:
            stopper.load_state_dict(restored)
        if monitor is not None and stopper.bad >= stopper.patience:
            # the phase had already stopped before the run died (in a
            # later phase): train nothing the uninterrupted run did not
            return slot.pop()
        tracer, metrics = self.obs.tracer, self.obs.metrics
        for step_idx, plan in plans:
            with tracer.span(f"{phase}.{step_name}", track=phase,
                             **{step_name: step_idx}) as sp:
                out = body(slot.pop(), step_idx, plan)
                slot.append(out.state)
                out.state = None     # the slot holds the only reference
                self.history[history_key].append(out.record)
                self.history["comm_bytes"] += out.comm_bytes
                self.history["sim_time"] += out.sim_time
                sp.set(**{k: v for k, v in out.record.items()
                          if isinstance(v, (int, float, str, bool))})
            if self.obs.enabled:
                metrics.counter("steps", 1, phase=phase)
                if out.comm_bytes:
                    metrics.counter("comm_bytes", out.comm_bytes,
                                    phase=phase)
                metrics.observe("step_wall_s", sp.dur_wall, phase=phase)
                metrics.observe("step_sim_s", out.sim_time, phase=phase)
            self.log.log(phase=phase, **out.record, **out.log)
            # update the stopper before checkpointing so the saved state
            # covers this step (restore resumes at step + 1)
            stop = (monitor is not None
                    and stopper.update(out.record[monitor]))
            if self.ckpt is not None and checkpoint_every and \
                    (step_idx + 1) % checkpoint_every == 0:
                meta = {"phase": phase, step_name: step_idx,
                        "stopper": stopper.state_dict(),
                        "history": copy.deepcopy(self.history)}
                if self.host_state is not None:
                    meta["host"] = self.host_state[0]()
                self.ckpt.save_async(ckpt_offset + step_idx, slot[0], meta)
                self.journal.append({"phase": phase, step_name: step_idx})
            if stop:
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        return slot.pop()
