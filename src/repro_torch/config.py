"""Model configuration for the PyTorch port.

The frozen dataclasses and registry of the JAX package's
``repro/config.py``, kept as this package's own copy so that the port
imports nothing of ``repro``, and cut to the fields the ported families
read (dense, MoE, ssm, the Zamba2 hybrid, enc-dec and the VLM backbone),
plus the optimizer, training and mesh configs. Every entry point resolves ``--arch <id>``
through :func:`get_config`. The serving engine's settings are
:class:`repro_torch.serve.config.EngineConfig`.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

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
class MoEConfig:
    """Token-choice MoE (for the MoE archs and for MoDE composition)."""

    enabled: bool = False
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 0  # expert hidden width (0 -> use model d_ff)
    capacity_factor: float = 1.25
    load_balance_weight: float = 0.01
    router_z_weight: float = 1e-3
    # MoDE: "none" | "staged" | "integrated"
    mode_variant: str = "none"
    n_noop_experts: int = 0  # for integrated MoDE
    # dtype of the combine (the cross-expert reduction of a token's top_k
    # expert outputs): "float32" | "bfloat16"
    combine_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""

    enabled: bool = False
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunk length

    def n_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # "rope" | "mrope" (Qwen2-VL 3D multimodal rope) | "none"
    pos_emb: str = "rope"
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    window: int = 0  # 0 = full; >0 = sliding window
    softmax_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # "dense" | "moe" | "ssm" | "hybrid" | "encdec" | "vlm"
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
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2): one shared attention block applied every
    # `hybrid_attn_every` SSM layers
    hybrid_attn_every: int = 6
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    enc_seq_len: int = 1500
    # vlm: the backbone consumes precomputed patch embeddings (frontend stub)
    vision_stub: bool = False
    dtype: str = "bfloat16"
    # "none" | "full" | "selective": torch.utils.checkpoint per layer group
    # (a hybrid segment); selective keeps the outputs of the products with
    # no batch dims (models.transformer.save_dots), as JAX's policy
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        return self.attn.head_dim or self.d_model // self.attn.n_heads

    @property
    def uses_moe(self) -> bool:
        """Whether the blocks' MLP is the token-choice MoE."""
        return self.family == "moe" or self.moe.enabled

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks) of a dense or MoE
        decoder, a Mamba2 LM, the hybrid (its layers plus the one shared
        block) or the enc-dec model (its encoder layers and each decoder
        layer's cross-attention and norm on top). The MoE router counts as
        ``D·E`` (the JAX formula; an integrated-MoDE router has
        ``E + n_noop`` columns)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim
        nq, nkv = self.attn.n_heads, self.attn.n_kv_heads
        emb = V * D * (1 if self.tie_embeddings else 2)
        attn = D * nq * hd + 2 * D * nkv * hd + nq * hd * D
        mlp_mults = 3 if self.glu else 2
        if self.family == "ssm":
            return emb + L * (self._ssm_block_params() + D)
        if self.family == "hybrid":  # the one shared attention + MLP block
            return emb + L * (self._ssm_block_params() + D) + attn + mlp_mults * D * F + 2 * D
        if self.uses_moe:
            fe = self.moe.d_ff_expert or F
            mlp = self.moe.n_experts * mlp_mults * D * fe + D * self.moe.n_experts
        else:
            mlp = mlp_mults * D * F
        total = emb + L * (attn + mlp + 2 * D) + D
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp_mults * D * F + 2 * D)
            total += L * (attn + D)  # cross-attention + its norm
        return total

    def active_params_per_token(self) -> int:
        """Parameters a token passes through: the MoE's ``top_k`` experts
        (no router) in place of all of them; == :meth:`n_params` otherwise."""
        if not self.uses_moe:
            return self.n_params()
        D, L = self.d_model, self.n_layers
        hd, nq, nkv = self.head_dim, self.attn.n_heads, self.attn.n_kv_heads
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        attn = D * nq * hd + 2 * D * nkv * hd + nq * hd * D
        fe = self.moe.d_ff_expert or self.d_ff
        mlp_active = self.moe.top_k * (3 if self.glu else 2) * D * fe
        return emb + L * (attn + mlp_active + 2 * D) + D

    def _ssm_block_params(self) -> int:
        D = self.d_model
        d_inner = self.ssm.expand * D
        nh = self.ssm.n_heads(D)
        # in_proj (z, x, B, C, dt), conv, A, D, norm, out_proj
        in_proj = D * (2 * d_inner + 2 * self.ssm.d_state + nh)
        conv = self.ssm.d_conv * (d_inner + 2 * self.ssm.d_state)
        out = d_inner * D + d_inner
        return in_proj + conv + out + 2 * nh


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
    # gradient compression across the data axis: "none" | "int8" (JAX's
    # field; its train loop never reads it, and the port's step refuses
    # "int8": optim/compression.py holds the compressed all-reduce itself)
    grad_compression: str = "none"


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
# Mesh config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    """A device mesh's axis sizes (JAX's ``MeshConfig``): the batch over
    "data" (and a leading "pod" axis when ``pod > 1``), tensor parallelism
    over "model". ``fsdp`` shards parameters and optimizer moments over
    "data" too (the rule table's "F" slots; ``launch.mesh.mesh_ctx`` reads
    it). ``pp_stages`` maps pipeline stages onto the pod axis (0 = off:
    data parallel over pod); JAX's ``launch/train.py`` never reads it, and the
    port's ``launch.mesh.make_mesh`` refuses a value above 0."""

    pod: int = 1
    data: int = 16
    model: int = 16
    fsdp: bool = False
    pp_stages: int = 0

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.pod > 1 else (self.data, self.model)

    @property
    def n_devices(self) -> int:
        return self.pod * self.data * self.model


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
            mrope_sections=(4, 6, 6),
        ),
    )
    if cfg.mod.enabled:
        replace["mod"] = dataclasses.replace(cfg.mod, round_to=8, predictor_hidden=32)
    if cfg.moe.enabled:
        n_e = min(cfg.moe.n_experts, 4)
        replace["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=n_e,
            top_k=min(cfg.moe.top_k, n_e),
            d_ff_expert=128,
            n_noop_experts=min(cfg.moe.n_noop_experts, 2),
        )
    if cfg.ssm.enabled:
        replace["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32, chunk=16)
    if cfg.family == "encdec":
        replace["n_enc_layers"] = 2
        replace["enc_seq_len"] = 64
    if cfg.family == "hybrid":
        replace["n_layers"] = 4
        replace["hybrid_attn_every"] = 2
    return dataclasses.replace(cfg, **replace)
