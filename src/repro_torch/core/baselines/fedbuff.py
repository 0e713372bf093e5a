"""FedBuff-style buffered semi-synchronous aggregation [Nguyen et al.,
AISTATS'22] on the Ampere pipeline, as ``repro.core.baselines.fedbuff``.

The synchronous fleet device phase closes every round on the slowest
surviving participant.  The buffered mode removes that barrier: devices
train continuously (up to ``FleetConfig.max_concurrent`` at once), each
from the global-model version current at its dispatch, and the server
aggregates whenever ``async_buffer_size`` updates have buffered, folding
their staleness-weighted deltas into the global model
(:func:`repro_torch.core.aggregation.fedbuff_stacked`).

:class:`FedBuffTrainer` extends :class:`~repro_torch.core.uit.AmpereTrainer`
with the buffered device phase; the one-shot activation upload and the
server phase are inherited, so ``fedbuff`` compares directly with every
other system of the registry.

Crash-resume: the loop-carried state is a
:class:`~repro_torch.streaming.VersionRing` of recent global versions
(still-in-flight clients reference stale snapshots), pruned to the
trace's maximum staleness; its ``state_dict()`` (``{str(version):
state}``) is what the :class:`~repro_torch.experiments.runner.Runner`
checkpoints, and batch indices are stateless in (seed, round, slot,
client) (:meth:`repro_torch.fleet.FleetEngine.buffered_round_indices`),
so a resumed run replays the same aggregations.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.core import aggregation
from repro_torch.core.uit import AmpereTrainer
from repro_torch.experiments.runner import StepOutcome
from repro_torch.streaming.versions import VersionRing
from repro_torch.transport import cohort_exchange


class FedBuffTrainer(AmpereTrainer):
    """Ampere pipeline whose device phase aggregates buffered,
    staleness-weighted updates instead of closing synchronous rounds."""

    def run_buffered_device_phase(self, dev_state, trace,
                                  max_rounds: Optional[int] = None):
        """Device phase driven by an *async* :class:`~repro_torch.fleet.
        FleetTrace` (every plan carries per-client staleness).

        ``plan.round_idx`` is the aggregation counter; client i of plan r
        trained from global version ``r - plan.staleness[i]``, so the loop
        carries the last ``max staleness + 1`` aggregated states.  Returns
        the newest one."""
        from repro_torch.fleet.engine import FleetEngine

        plans = trace.rounds if max_rounds is None else \
            trace.rounds[:max_rounds]
        if not plans:
            return dev_state
        if not all(p.staleness for p in plans):
            raise ValueError(
                "buffered device phase needs an async trace (plans must "
                "carry per-client staleness); simulate one with "
                "FleetConfig(async_buffer_size > 0)")
        # prune bound from the FULL trace, never the max_rounds-truncated
        # plan list: a run killed early must checkpoint every version a
        # resumed full-length run may still reference
        s_max = max(max(p.staleness) for p in trace.rounds if p.staleness)

        engine = FleetEngine(self.model, self.run, self.clients,
                             device=self.device)
        ring, start_round = self.runner.restore("fedbuff",
                                                {"0": dev_state})
        del dev_state

        def body(ring, rnd, plan):
            kept, wire, extra, excluded = cohort_exchange(
                self.transport, round_key=f"fedbuff/{rnd}",
                clients=plan.clients, one_way_bytes=self._one_way_bytes(),
                quorum_frac=self.quorum_frac, phase="fedbuff")
            clients, weights = aggregation.survivors(
                plan.clients, plan.weights, kept, excluded)
            staleness = [plan.staleness[i] for i in kept]
            vring = VersionRing.from_state_dict(ring, s_max=s_max)
            del ring
            snaps = vring.snapshots(rnd, staleness)
            new, metrics = engine.run_buffered_round(
                vring.get(rnd), snaps, rnd, clients, weights,
                self._sched(rnd))
            del snaps
            vring.append(rnd + 1, new)
            record = {"round": rnd, "loss": float(metrics["loss"]),
                      "t_end": plan.t_end, "buffered": len(clients),
                      "staleness_max": int(max(staleness)),
                      **self._aux_eval(new)}
            log = self._round_log({"dropped": len(plan.dropped),
                                   "sim_t": round(plan.t_end, 6),
                                   "ring_versions": len(vring)},
                                  "fedbuff", plan.clients, excluded)
            if self.obs.enabled:
                for st in staleness:
                    self.obs.metrics.observe("staleness", float(st),
                                             phase="fedbuff")
            return StepOutcome(state=vring.state_dict(), record=record,
                               comm_bytes=wire,
                               sim_time=plan.round_time + extra, log=log)

        held = [ring]   # handed over: the Runner empties it
        del ring
        ring = self.runner.run_phase(
            "fedbuff", held,
            ((p.round_idx, p) for p in plans if p.round_idx >= start_round),
            body, history_key="device", monitor="val_loss",
            checkpoint_every=self.run.checkpoint_every)
        return VersionRing.from_state_dict(ring, s_max=s_max).latest()
