"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention [arXiv:2411.15242].

The JAX package's ``configs/zamba2_2p7b.py``, copied: 54L d_model=2560 32H
(kv=32, head_dim=80) d_ff=10240 vocab=32000 ssm_state=64. One weight-shared
attention+MLP block runs every 6 Mamba2 layers (the JAX package's
simplification of Zamba2's two alternating shared blocks). MoD routes
around every other Mamba2 layer; the shared block stays dense.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, SSMConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b" + ("" if mod else "-dense"),
        family="hybrid",
        n_layers=54,
        d_model=2560,
        d_ff=10240,
        vocab=32000,
        max_seq_len=524288,
        attn=AttentionConfig(n_heads=32, n_kv_heads=32, head_dim=80),
        ssm=SSMConfig(enabled=True, d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
        hybrid_attn_every=6,
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("zamba2-2.7b")
def zamba2_2p7b() -> ModelConfig:
    return _base(mod=True)


@register("zamba2-2.7b-dense")
def zamba2_2p7b_dense() -> ModelConfig:
    return _base(mod=False)
