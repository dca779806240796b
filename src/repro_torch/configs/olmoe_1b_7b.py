"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060].

The JAX package's ``configs/olmoe_1b_7b.py``, copied: 16L d_model=2048 16H
(kv=16) d_ff=1024/expert vocab=50304, MoE 64e top-8. The MoD variant is
*staged MoDE* (paper §4.3): every other block is routed at 12.5% capacity
and its MLP is the MoE; ``-dense`` has no MoD.
"""
from repro_torch.config import AttentionConfig, MoDConfig, MoEConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b" + ("" if mod else "-dense"),
        family="moe",
        n_layers=16,
        d_model=2048,
        d_ff=1024,
        vocab=50304,
        max_seq_len=32768,
        attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),
        moe=MoEConfig(
            enabled=True,
            n_experts=64,
            top_k=8,
            d_ff_expert=1024,
            mode_variant="staged" if mod else "none",
        ),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("olmoe-1b-7b")
def olmoe() -> ModelConfig:
    return _base(mod=True)


@register("olmoe-1b-7b-dense")
def olmoe_dense() -> ModelConfig:
    return _base(mod=False)
