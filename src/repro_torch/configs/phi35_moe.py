"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE].

The JAX package's ``configs/phi35_moe.py``, copied: 32L d_model=4096 32H
(GQA kv=8) d_ff=6400/expert vocab=32064, MoE 16e top-2. MoD composes as
*staged MoDE* (paper §4.3) by default; ``phi3.5-moe-imode`` is the
integrated variant (4 no-op experts in the router, no MoD routing).
"""
from repro_torch.config import AttentionConfig, MoDConfig, MoEConfig, ModelConfig, register


def _base(mod: bool, variant: str = "staged") -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b" + ("" if mod else "-dense"),
        family="moe",
        n_layers=32,
        d_model=4096,
        d_ff=6400,
        vocab=32064,
        max_seq_len=32768,
        attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128),
        moe=MoEConfig(
            enabled=True,
            n_experts=16,
            top_k=2,
            d_ff_expert=6400,
            mode_variant=variant if mod else "none",
            n_noop_experts=4 if (mod and variant == "integrated") else 0,
        ),
        mod=MoDConfig(enabled=(mod and variant == "staged"), capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("phi3.5-moe-42b-a6.6b")
def phi35_moe() -> ModelConfig:
    return _base(mod=True, variant="staged")


@register("phi3.5-moe-imode")
def phi35_moe_integrated() -> ModelConfig:
    return _base(mod=True, variant="integrated")


@register("phi3.5-moe-dense")
def phi35_moe_dense() -> ModelConfig:
    return _base(mod=False)
