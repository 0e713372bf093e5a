"""Roofline analysis of a traced dry-run step, as ``repro.launch.roofline``.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs              / PEAK_FLOPS
    memory     = bytes_accessed     / HBM_BW
    collective = collective_bytes   / LINK_BW

every count per rank (per device).  The JAX package reads these from XLA's
``cost_analysis()`` and the optimized HLO text; the port counts them at
dispatch while the step runs on shape-only tensors (:class:`CostCounter`):

* FLOPs — ``torch.utils.flop_counter``'s formulas for each aten op the
  rank runs on its local tensors (the same table, and the same
  decomposition of ops it has no formula for, as ``FlopCounterMode``,
  which would see a ``DTensor`` op once, at its global shapes);
* bytes accessed — each aten op's local input and output bytes, views
  free.  This is the eager route's traffic, op by op: XLA's count is of
  its fused graph and is smaller;
* collectives — the ``_c10d_functional`` / c10d ops that ``DTensor``
  issues, with the reference's ring-algorithm cost per op
  (:func:`ring_bytes`) and the group size of the op's process group;
* peak memory — the bytes of the live local storages, inputs included, at
  their highest (weak references to each storage; ``MemTracker`` follows
  modules and optimizers, and the port's steps are functions of trees).

Hardware model: NVIDIA H100 80GB HBM3 (SXM) at 700 W, per GPU, from the
spec sheet, not measured: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, and
50 GB/s a GPU across nodes (one 400 Gb/s InfiniBand NDR port per GPU,
which is what a ring over a 16-rank group spanning two 8-GPU nodes gets).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # dense bf16 per GPU (spec sheet)
HBM_BW = 3.35e12             # bytes/s per GPU (spec sheet)
LINK_BW = 50e9               # bytes/s per GPU across nodes (IB NDR 400)


def ring_bytes(op: str, size: float, s: int) -> float:
    """Per-device link bytes of one collective on a ring of ``s`` ranks,
    ``size`` the bytes of its result (the reference's costs)."""
    s = max(2, s)
    if op == "all-gather":
        return size * (s - 1) / s
    if op == "reduce-scatter":
        return size * (s - 1)
    if op == "all-reduce":
        return 2.0 * size * (s - 1) / s
    if op in ("all-to-all", "ragged-all-to-all"):
        return size * (s - 1) / s
    return float(size)       # collective-permute / broadcast


# the functional (and autograd-functional) collectives DTensor issues, by
# the reference's HLO op name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")


def _collective_name(func) -> Optional[str]:
    if getattr(func, "namespace", "") not in _COLL_NAMESPACES:
        return None
    return _COLLECTIVES.get(func._overloadpacket.__name__)


def _group_size(args) -> int:
    """The size of the group named by the op's last argument."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class CollectiveStats:
    per_device_bytes: float = 0.0
    counts: Optional[Dict[str, int]] = None
    bytes_by_op: Optional[Dict[str, float]] = None

    def __post_init__(self):
        self.counts = self.counts or {}
        self.bytes_by_op = self.bytes_by_op or {}

    def add(self, op: str, size: float, s: int):
        b = ring_bytes(op, size, s)
        self.per_device_bytes += b
        self.counts[op] = self.counts.get(op, 0) + 1
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0.0) + b


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class CollectiveCounter(TorchDispatchMode):
    """Records every collective the ranks' local tensors go through: op,
    result bytes and group size, costed by :func:`ring_bytes` into
    ``self.stats``.  An op on ``DTensor`` operands is handed back
    (``NotImplemented``) so that ``DTensor`` desugars it first and this
    mode sees the local ops and collectives it issues."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> bool:
        op = _collective_name(func)
        if op is None:
            return False
        size = sum(_nbytes(t) for t in _tensors(out))
        self.stats.add(op, size, _group_size(args))
        return True


_FREE_OPS = ("wait_tensor", "_wrap_tensor_autograd", "detach", "alias",
             "lift_fresh", "empty", "empty_strided", "empty_like",
             "_local_scalar_dense")


class CostCounter(CollectiveCounter):
    """:class:`CollectiveCounter` plus the rank's FLOPs, bytes accessed
    and live / peak storage bytes.  ``track(tree)`` registers tensors made
    before the mode (the step's inputs): they count toward the live bytes
    from the start, once a storage."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.device_type = device_type
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()

    def _free(self, n):
        self.live -= n

    def _track_one(self, t):
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = t._local_tensor
        if self.device_type and t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, tree):
        for t in _tensors(tree):
            self._track_one(t)

    def _local(self, tensors):
        if self.device_type is None:
            return tensors
        return [t for t in tensors if t.device.type == self.device_type]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if func is not torch.ops.prim.device.default:
            # as FlopCounterMode: an op with a decomposition is counted as
            # what it decomposes into
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = self._local(_tensors((args, kwargs)))
        outs = self._local(_tensors(out))
        if not ins and not outs:
            return out          # DTensor's own host-side bookkeeping
        if packet in self._flop_registry:
            self.flops += int(self._flop_registry[packet](
                *args, **kwargs, out_val=out))
        if not self._record(func, args, kwargs, out) \
                and not _is_free(func):
            self.bytes_accessed += (sum(_nbytes(t) for t in ins)
                                    + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._track_one(t)
        return out


def _is_free(func) -> bool:
    """Views, aliases and allocations move no bytes."""
    return (func._overloadpacket.__name__ in _FREE_OPS
            or getattr(func, "is_view", False))


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    step: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    peak_memory_per_device: float
    model_flops: float              # 6*N*D(tokens) whole-job
    collective_counts: dict

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_seconds(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / traced FLOPs — remat/masking/redundancy waste."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs utilization at the roofline: what fraction of the
        chips' peak compute the step achieves if it runs exactly at its
        bounding term (MFU-at-roofline)."""
        t = self.roofline_seconds
        if not t:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "step": self.step, "chips": self.chips,
            "hlo_gflops_total": self.flops_per_device * self.chips / 1e9,
            "hbm_gb_total": self.bytes_per_device * self.chips / 1e9,
            "coll_gb_total": self.collective_bytes_per_device * self.chips / 1e9,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "bottleneck": self.bottleneck,
            "model_gflops": self.model_flops / 1e9,
            "useful_flops_frac": self.useful_flops_fraction,
            "roofline_frac": self.roofline_fraction,
            "roofline_seconds": self.roofline_seconds,
            "peak_mem_gb_per_device": self.peak_memory_per_device / 1e9,
            "collectives": self.collective_counts,
        }


def analyse(arch: str, shape: str, mesh_name: str, step: str, chips: int,
            counter: CostCounter, model_flops: float) -> Roofline:
    """The roofline of one traced step from its :class:`CostCounter` (or
    a record of the same ``flops``, ``bytes_accessed``, ``stats`` and
    ``peak``: the dry-run's extrapolated device round)."""
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, step=step, chips=chips,
        flops_per_device=float(counter.flops),
        bytes_per_device=float(counter.bytes_accessed),
        collective_bytes_per_device=counter.stats.per_device_bytes,
        peak_memory_per_device=float(counter.peak), model_flops=model_flops,
        collective_counts=dict(counter.stats.counts))


def model_flops_estimate(cfg, shape_kind: str, seq_len: int,
                         global_batch: int, step: str) -> float:
    """6*N*D (training) / 2*N*D (inference) with N = active params."""
    n_active = cfg.param_count(active_only=True)
    if step in ("server_train_step", "e2e_train_step", "device_round_step"):
        tokens = seq_len * global_batch
        return 6.0 * n_active * tokens
    if step == "prefill_step":
        return 2.0 * n_active * seq_len * global_batch
    # decode: one token per sequence
    return 2.0 * n_active * global_batch
