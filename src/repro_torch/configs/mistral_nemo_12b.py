"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

The JAX package's ``configs/mistral_nemo_12b.py``, copied: 40L d_model=5120
32H (GQA kv=8, head_dim=128, so n_heads·head_dim = 4096 != d_model)
d_ff=14336 vocab=131072, rope θ 1e6, MoD every other block at 12.5%
capacity, and its ``-dense`` twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b" + ("" if mod else "-dense"),
        family="dense",
        n_layers=40,
        d_model=5120,
        d_ff=14336,
        vocab=131072,
        max_seq_len=131072,
        attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1e6),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("mistral-nemo-12b")
def mistral_nemo_12b() -> ModelConfig:
    return _base(mod=True)


@register("mistral-nemo-12b-dense")
def mistral_nemo_12b_dense() -> ModelConfig:
    return _base(mod=False)
