"""Configuration dataclasses for the repro framework.

Everything in the framework is driven by two frozen dataclasses:

* :class:`LMConfig` — a decoder-LM architecture description covering the ten
  assigned architectures (dense / MoE / SSM / hybrid / VLM-backbone /
  audio-backbone transformers).
* :class:`VisionConfig` — the paper's own CNN / ViT classifier families used
  for the faithful Ampere reproduction on image classification.

Plus the system-level configs:

* :class:`SplitConfig`   — Ampere split-point + auxiliary-network options.
* :class:`FedConfig`     — federated cohort topology (clients, sampling,
  local-SGD period, non-IID degree, straggler groups).
* :class:`OptimConfig`   — optimizer + schedule.
* :class:`RunConfig`     — top-level bundle consumed by the launchers.

Configs are plain data: importing this module never touches jax device state.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence


# ---------------------------------------------------------------------------
# Architecture configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (GShard-style capacity dispatch)."""

    num_experts: int = 0            # routed experts (0 = dense FFN)
    top_k: int = 0
    d_expert: int = 0               # per-expert hidden dim
    num_shared_experts: int = 0     # always-on shared experts (Qwen2-MoE)
    d_shared: int = 0               # hidden dim of the shared expert(s)
    layer_period: int = 1           # layer i is MoE iff i % period == offset
    layer_offset: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01   # load-balancing aux loss coefficient

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0

    def is_moe_layer(self, layer_idx: int) -> bool:
        if not self.enabled:
            return False
        return layer_idx % self.layer_period == self.layer_offset


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-2 (SSD) sub-config."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LMConfig:
    """A decoder-LM architecture.

    ``layer_pattern`` assigns a token-mixer type to every layer:
    ``"attn"`` or ``"mamba"``; it is produced by :meth:`mixer_of`.
    """

    name: str
    family: str                     # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention features ------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0       # 0 = disabled (gemma2: 50.0)
    final_softcap: float = 0.0      # 0 = disabled (gemma2: 30.0)
    sliding_window: int = 0         # 0 = global; used by local layers
    local_global_period: int = 0    # gemma2: 2 -> even layers local
    rope_theta: float = 10000.0
    mrope_sections: tuple = ()      # qwen2-vl: (t, h, w) rotary sections
    mlp_activation: str = "silu"    # silu|gelu|geglu (gemma2 uses gelu GLU)
    post_block_norm: bool = False   # gemma2: extra norms after attn/mlp
    embedding_multiplier: float = 1.0  # gemma2 scales embeds by sqrt(d)
    tie_embeddings: bool = False
    attention_multiplier: float = 0.0  # 0 -> 1/sqrt(head_dim)

    # --- hybrid / ssm ------------------------------------------------------
    attn_layer_period: int = 0      # jamba: 8 -> 1 attention per 8 layers
    attn_layer_offset: int = 0      # jamba: which slot in the period is attn
    mamba: MambaConfig = field(default_factory=MambaConfig)

    # --- moe ---------------------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)

    # --- numerics ----------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # --- derived layer pattern helpers --------------------------------
    def mixer_of(self, layer_idx: int) -> str:
        """Token-mixer type of layer ``layer_idx``: "attn" or "mamba"."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_layer_period > 0:
            in_slot = layer_idx % self.attn_layer_period == self.attn_layer_offset
            return "attn" if in_slot else "mamba"
        return "attn"

    def window_of(self, layer_idx: int) -> int:
        """Sliding-window size for layer ``layer_idx`` (0 = global)."""
        if self.sliding_window and self.local_global_period:
            return self.sliding_window if layer_idx % self.local_global_period == 0 else 0
        return self.sliding_window

    def layer_kind(self, layer_idx: int) -> tuple:
        """Full static description of a layer: (mixer, window, is_moe)."""
        return (
            self.mixer_of(layer_idx),
            self.window_of(layer_idx),
            self.moe.is_moe_layer(layer_idx),
        )

    @property
    def pattern_period(self) -> int:
        """Minimal period P such that layer kinds repeat with period P."""
        kinds = [self.layer_kind(i) for i in range(self.num_layers)]
        for p in range(1, self.num_layers + 1):
            if self.num_layers % p:
                continue
            if all(kinds[i] == kinds[i % p] for i in range(self.num_layers)):
                return p
        return self.num_layers

    @property
    def is_subquadratic(self) -> bool:
        """True when decode state does not grow quadratically-costly with
        context (SSM / hybrid archs) — gates the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    # --- parameter count (for 6ND model-FLOPs accounting) -------------
    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count, embeddings included."""
        D, V = self.d_model, self.vocab_size
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D  # lm head
        n += D  # final norm
        for i in range(self.num_layers):
            mixer, _, is_moe = self.layer_kind(i)
            n += D  # pre-mixer norm
            if mixer == "attn":
                hd = self.head_dim
                n += D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd
                n += self.num_heads * hd * D
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
                if self.qk_norm:
                    n += 2 * hd
            else:
                m = self.mamba
                d_in, nh = m.d_inner(D), m.num_heads(D)
                conv_dim = d_in + 2 * m.d_state
                n += D * (2 * d_in + 2 * m.d_state + nh)  # in_proj
                n += conv_dim * m.conv_width + conv_dim   # conv1d + bias
                n += 2 * nh + d_in                        # A_log, dt_bias, norm
                n += d_in * D                             # out_proj
            n += D  # pre-mlp norm
            if self.post_block_norm:
                n += 2 * D
            if is_moe:
                moe = self.moe
                e = moe.top_k if active_only else moe.num_experts
                n += D * moe.num_experts  # router (always resident)
                n += e * (3 * D * moe.d_expert)
                if moe.num_shared_experts:
                    n += moe.num_shared_experts * 3 * D * moe.d_shared
                    n += D  # shared gate
            else:
                n += 3 * D * self.d_ff
        return n


@dataclass(frozen=True)
class VisionConfig:
    """Paper-faithful CNN / ViT classifier configs (CIFAR-scale)."""

    name: str
    family: str                 # cnn|vgg|vit|swin
    num_classes: int = 10
    img_size: int = 32
    in_channels: int = 3
    # CNN
    stem_channels: int = 16
    stem_stride: int = 2            # MobileNetV3 stem downsamples 2x
    block_channels: tuple = ()      # per-stage channels
    block_strides: tuple = ()
    expand_ratio: int = 4           # inverted residual expansion
    use_se: bool = True
    # ViT / Swin
    patch_size: int = 4
    depth: int = 8
    d_model: int = 384
    num_heads: int = 6
    mlp_ratio: float = 4.0
    window_size: int = 0            # swin: window attention
    norm_eps: float = 1e-6
    dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def num_layers(self) -> int:
        if self.family in ("vit", "swin"):
            return self.depth + 1  # patch embed counts as a splittable layer
        return len(self.block_channels) + 1  # stem + stages


# ---------------------------------------------------------------------------
# System configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SplitConfig:
    """Ampere split + auxiliary-network options (paper §3.2.1–3.2.2)."""

    split_point: int = 1            # p — number of layers on the device
    aux_ratio: float = 0.5          # dimension ratio of the auxiliary layer
    aux_clone_first_server_layer: bool = True  # ablation: False -> FC-only aux
    activation_dtype: str = "bfloat16"   # dtype of the one-shot transfer
    quantize_activations: bool = False   # beyond-paper: int8 activations


@dataclass(frozen=True)
class FedConfig:
    """Federated cohort topology (paper §5.1 testbed semantics)."""

    num_clients: int = 120
    clients_per_round: int = 12
    local_steps: int = 8            # H — local SGD iterations per round
    device_epochs: int = 55         # N^(d)
    server_epochs: int = 32         # N^(s)
    dirichlet_alpha: float = 0.33   # non-IID degree (paper default)
    samples_per_client: int = 10000
    device_batch_size: int = 32     # B^(d)
    server_batch_size: int = 256    # B^(s)
    # straggler model: Jetson groups at 921/640/320 MHz
    straggler_speed_groups: tuple = (1.0, 0.695, 0.347)
    straggler_deadline_factor: float = 0.0   # 0 = wait for all (off)
    drop_prob: float = 0.0          # per-round client failure probability
    seed: int = 0


@dataclass(frozen=True)
class OptimConfig:
    name: str = "sgd"               # sgd|momentum|adam|adamw
    lr: float = 0.05
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: str = "inverse_time"  # constant|inverse_time|cosine|warmup_cosine
    warmup_steps: int = 100
    total_steps: int = 10000
    decay_gamma: float = 1e-3       # inverse-time: lr/(1+gamma*t)
    grad_clip: float = 0.0          # 0 = off
    # beyond-paper distributed-optimization knobs
    topk_compress_ratio: float = 0.0   # 0 = off; else keep-ratio for uploads
    optimizer_state_dtype: str = "float32"  # bf16 to halve optimizer memory
    master_weights: bool = False    # bf16 params + fp32 masters (halves
                                    # FSDP gather / grad-reduce bytes)
    grad_dtype: str = ""            # "bfloat16": cast grads before the
                                    # cross-device reduction (halves grad
                                    # collective bytes; optimizer upcasts)


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh description (the production mesh is built lazily)."""

    multi_pod: bool = False
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self) -> tuple:
        return (self.pods, self.data, self.model) if self.multi_pod else (self.data, self.model)

    @property
    def axes(self) -> tuple:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n

    @property
    def dp_size(self) -> int:
        return self.data * (self.pods if self.multi_pod else 1)


@dataclass(frozen=True)
class ShardingConfig:
    """How params/activations map onto the mesh."""

    strategy: str = "fsdp_tp"       # tp_only | fsdp_tp
    remat: str = "block"            # none | block (remat each layer block)
    sequence_sharding: bool = True  # shard residual-stream seq over "model"
    donate_params: bool = True
    scan_layers: bool = True        # lax.scan over layer repetitions


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle handed to launchers."""

    arch: str = "qwen3-1.7b"
    shape: str = "train_4k"
    algo: str = "ampere"            # ampere|splitfed|splitfedv2|splitgp|scaffold|pipar|fedavg
    split: SplitConfig = field(default_factory=SplitConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    seed: int = 0
    checkpoint_dir: str = ""
    checkpoint_every: int = 0       # rounds; 0 = off
    kernels: str = "auto"           # auto|pallas|xla
    # server phase: keep the consolidated activation pool device-resident
    # (jitted whole-epoch scan) while it fits this budget; larger pools
    # stream batches through the double-buffered DevicePrefetcher instead.
    device_pool_budget_mb: int = 1024


@dataclass(frozen=True)
class InputShape:
    """One of the assigned input-shape cells."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
