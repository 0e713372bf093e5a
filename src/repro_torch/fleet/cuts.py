"""Per-device-class cut layers (adaptive split points), as
``repro.fleet.cuts``.

The cut layer ``p`` trades on-device compute against upload bytes: a
deeper cut grows the device block and the model exchange but (for CNNs)
shrinks the one-shot activation upload.  A :class:`CutPolicy` on the
experiment spec decides how ``p`` is chosen:

* ``static`` — every device uses ``SplitConfig.split_point``;
* ``per_profile`` — each device class (``fleet.profiles.DEVICE_CLASSES``)
  gets the cut minimising ``device_epochs * epoch_time(p) +
  one_shot_upload(p)`` over the cut frontier
  (:func:`repro_torch.core.comm_model.cut_frontier`) priced with that
  class's compute and link; ``overrides`` then pin classes to explicit
  cuts.  Under the testbed constants the frontier resolves to the
  shallowest cut for every class (both communication terms scale with
  1 / bandwidth), so a heterogeneous fleet is pinned through
  ``overrides``.

:func:`resolve_cuts` turns a policy into a :class:`CutAssignment` that
maps classes and concrete device ids (the deterministic
``sample_population`` draws) to cuts.  A uniform assignment is collapsed
onto the static path by the experiment API, so a uniform ``per_profile``
run is the static run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import comm_model
from repro_torch.fleet import profiles


@dataclasses.dataclass(frozen=True)
class CutPolicy:
    """Frozen spec section: how the cut layer is chosen.  ``max_cut = 0``
    means the deepest legal cut (``num_layers - 1``); ``overrides`` pins
    classes to explicit cuts after the cost model has run —
    ``(("phone-3g", 3), ...)``."""

    mode: str = "static"              # static | per_profile
    objective: str = "epoch_time"     # reserved for future objectives
    min_cut: int = 1
    max_cut: int = 0
    overrides: Tuple[Tuple[str, int], ...] = ()

    def validate(self, num_layers: Optional[int] = None) -> List[str]:
        problems = []
        if self.mode not in ("static", "per_profile"):
            problems.append(f"cut.mode {self.mode!r} not in static|per_profile")
        if self.objective != "epoch_time":
            problems.append(f"cut.objective {self.objective!r} unsupported")
        if self.min_cut < 1:
            problems.append(f"cut.min_cut {self.min_cut} < 1")
        if self.max_cut < 0:
            problems.append(f"cut.max_cut {self.max_cut} < 0")
        if self.max_cut and self.max_cut < self.min_cut:
            problems.append(
                f"cut.max_cut {self.max_cut} < cut.min_cut {self.min_cut}")
        hi = num_layers - 1 if num_layers else None
        if hi is not None:
            if self.min_cut > hi:
                problems.append(
                    f"cut.min_cut {self.min_cut} outside [1, {hi}]")
            if self.max_cut > hi:
                problems.append(
                    f"cut.max_cut {self.max_cut} outside [1, {hi}]")
        for name, p in self.overrides:
            if name not in profiles.DEVICE_CLASSES:
                problems.append(f"cut.overrides: unknown device class {name!r}")
            if p < 1 or (hi is not None and p > hi):
                problems.append(
                    f"cut.overrides[{name!r}] = {p} outside "
                    f"[1, {hi if hi is not None else '?'}]")
        return problems


class CutAssignment:
    """A resolved cut per device class and per concrete device id."""

    def __init__(self, by_class: Dict[str, int], by_client: Dict[int, int]):
        self.by_class = {str(k): int(v) for k, v in by_class.items()}
        self.by_client = {int(k): int(v) for k, v in by_client.items()}
        depths = set(self.by_client.values()) or set(self.by_class.values())
        self.depths: Tuple[int, ...] = tuple(sorted(depths))

    @property
    def uniform(self) -> bool:
        return len(self.depths) <= 1

    def cut_of(self, client_id: int) -> int:
        return self.by_client[int(client_id)]

    def summary(self) -> dict:
        return {
            "by_class": dict(sorted(self.by_class.items())),
            "depths": list(self.depths),
            "uniform": self.uniform,
        }


def class_frontier(model, split_cfg, cls: profiles.DeviceClass, *,
                   policy: CutPolicy, algo: str = "ampere",
                   n_samples: int, batch_size: int, seq_len: int = 0,
                   device_epochs: int = 1,
                   upload_samples: Optional[int] = None,
                   sizes_by_cut: Optional[dict] = None):
    """The cut frontier priced with one device class's compute and link.
    ``sizes_by_cut`` shares the block sizes across classes (they depend
    only on the cut)."""
    num_layers = model.cfg.num_layers
    lo = max(1, policy.min_cut)
    hi = num_layers - 1 if policy.max_cut == 0 else min(policy.max_cut,
                                                        num_layers - 1)
    tm = comm_model.TimeModel(device_gflops=cls.gflops,
                              bandwidth=cls.bandwidth_bps)
    return comm_model.cut_frontier(
        model, split_cfg, cuts=range(lo, hi + 1), algo=algo, tm=tm,
        n_samples=n_samples, batch_size=batch_size, seq_len=seq_len,
        device_epochs=device_epochs, upload_samples=upload_samples,
        sizes_by_cut=sizes_by_cut)


def resolve_cuts(policy: CutPolicy, model, run_cfg, fleet_cfg, *,
                 seq_len: int = 0,
                 upload_samples: Optional[int] = None) -> CutAssignment:
    """A cut per device class, mapped onto the sampled population.
    Deterministic (an analytic frontier, seeded class draws); a tie on the
    objective goes to the shallowest cut."""
    fed = run_cfg.fed
    n_round_samples = fed.local_steps * fed.device_batch_size
    by_class: Dict[str, int] = {}
    if policy.mode == "static" or fleet_cfg is None:
        p = int(run_cfg.split.split_point)
        names = [name for name, _ in fleet_cfg.class_mix] if fleet_cfg else []
        by_class = {name: p for name in names}
    else:
        sizes_by_cut: Dict[int, object] = {}
        for name, frac in fleet_cfg.class_mix:
            if frac <= 0:
                continue
            rows = class_frontier(
                model, run_cfg.split, profiles.DEVICE_CLASSES[name],
                policy=policy, n_samples=n_round_samples,
                batch_size=fed.device_batch_size, seq_len=seq_len,
                device_epochs=max(1, fed.device_epochs),
                upload_samples=upload_samples, sizes_by_cut=sizes_by_cut)
            best = min(rows, key=lambda r: (r["total_s"], r["split_point"]))
            by_class[name] = best["split_point"]
        by_class.update({n: int(p) for n, p in policy.overrides
                         if n in by_class})

    by_client: Dict[int, int] = {}
    if fleet_cfg is not None:
        for prof in profiles.sample_population(fleet_cfg):
            by_client[prof.device_id] = by_class[prof.cls]
    return CutAssignment(by_class, by_client)
