"""Model configuration for the PyTorch port.

The frozen dataclasses and registry of the JAX package's
``repro/config.py``, kept as this package's own copy so that the port
imports nothing of ``repro``, and cut to the fields the dense family reads
(the MoE/SSM/enc-dec sub-configs come with their slices), plus the
optimizer and training configs. Every entry point resolves ``--arch <id>``
through :func:`get_config`. The serving engine's settings are
:class:`repro_torch.serve.config.EngineConfig`.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoDConfig:
    """Mixture-of-Depths routing config (the paper's technique)."""

    enabled: bool = False
    # Fraction of the sequence that participates in a routed block
    # (paper-optimal: 0.125).
    capacity_ratio: float = 0.125
    # Apply MoD routing every `every` blocks (paper-optimal: 2).
    every: int = 2
    # Multiply block output by the "raw" router weight (paper Eq. 1) or its
    # "sigmoid" (a bounded variant for tiny-scale runs).
    gate: str = "raw"
    # Causal-sampling scheme that drives decode-time decisions:
    # "aux_loss" (router sigmoid) or "predictor" (small stop-grad MLP).
    sampling: str = "predictor"
    aux_loss_weight: float = 0.01
    predictor_hidden: int = 128
    # Round capacities to a multiple of this.
    round_to: int = 128
    # "learned" | "stochastic" (Gaussian control from the paper's Fig. 3)
    router_type: str = "learned"
    # Dispatch backend of the routed-execution engine: "xla" | "pallas" |
    # "pallas_fused". "xla" and "pallas" run one path, the hand-written
    # gather and gated scatter-add kernels of kernels/routing.py;
    # "pallas_fused" runs the training forward's routed blocks through the
    # fused routed-attention and routed-MLP kernels instead (prefill and
    # decode keep gather/scatter, as in the JAX package).
    backend: str = "xla"

    def capacity(self, seq_len: int) -> int:
        c = int(round(self.capacity_ratio * seq_len))
        if seq_len >= self.round_to:
            c = max(self.round_to, (c // self.round_to) * self.round_to)
        return max(1, min(c, seq_len))


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_emb: str = "rope"  # "rope" | "none"
    causal: bool = True
    window: int = 0  # 0 = full; >0 = sliding window
    softmax_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # the port runs "dense"; the JAX package's other families
    # ("moe" | "ssm" | "hybrid" | "encdec" | "vlm") are later slices
    family: str = "dense"
    n_layers: int = 4
    d_model: int = 256
    d_ff: int = 1024
    vocab: int = 32000
    max_seq_len: int = 4096
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"  # "silu" (SwiGLU), "gelu" (GeGLU / plain)
    glu: bool = True
    attn: AttentionConfig = field(default_factory=AttentionConfig)
    mod: MoDConfig = field(default_factory=MoDConfig)
    dtype: str = "bfloat16"
    remat: str = "none"  # "none" | "full" (torch.utils.checkpoint per layer group)

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim or self.d_model // self.attn.n_heads

    def n_params(self) -> int:
        """Analytic parameter count of a dense decoder (embeddings + blocks)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        nq, nkv = self.attn.n_heads, self.attn.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * nq * hd + 2 * D * nkv * hd + nq * hd * D
        mlp = (3 if self.glu else 2) * D * F
        return emb + L * (attn + mlp + 2 * D) + D


# ---------------------------------------------------------------------------
# Train configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 128
    seq_len: int = 2048
    microbatches: int = 1  # gradient accumulation factor
    optim: OptimConfig = field(default_factory=OptimConfig)
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 200
    # under the temporary directory (TMPDIR), as the JAX package's /tmp default
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_ckpts: int = 3
    async_ckpt: bool = True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    _ensure_configs_imported()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def _ensure_configs_imported() -> None:
    # configs/ modules self-register on import
    import repro_torch.configs  # noqa: F401


def with_mod_backend(cfg: ModelConfig, backend: str) -> ModelConfig:
    """Same model, different routed-dispatch backend
    ("xla" | "pallas" | "pallas_fused")."""
    return dataclasses.replace(cfg, mod=dataclasses.replace(cfg.mod, backend=backend))


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests (the JAX
    package's ``smoke_config``, restricted to the fields the port reads)."""
    replace: Dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        d_ff=256,
        vocab=512,
        max_seq_len=128,
        attn=dataclasses.replace(
            cfg.attn,
            n_heads=4,
            n_kv_heads=max(1, min(4, cfg.attn.n_kv_heads)),
            head_dim=32,
        ),
    )
    if cfg.mod.enabled:
        replace["mod"] = dataclasses.replace(cfg.mod, round_to=8, predictor_hidden=32)
    return dataclasses.replace(cfg, **replace)
