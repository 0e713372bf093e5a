"""PyTorch/CUDA port of the Ampere split-federated-learning system.

Mirrors the JAX package ``repro`` module for module (``repro_torch.models
.attention`` <-> ``repro.models.attention`` and so on) and imports nothing
of it.  Parameters are nested dicts of tensors laid out exactly like the
JAX pytrees, so :mod:`repro_torch.interop` maps one tree onto the other
through numpy.  The TPU Pallas kernels are hand-written CUDA kernels for
Hopper (``csrc/``); on CPU tensors each kernel wrapper runs its plain
PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
