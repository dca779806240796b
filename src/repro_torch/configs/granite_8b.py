"""granite-8b [dense] — llama-arch code model [arXiv:2405.04324; hf].

The JAX package's ``configs/granite_8b.py``, copied: 36L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=49152, MoD every other block at 12.5%
capacity, and its ``-dense`` twin (no MoD).
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="granite-8b" + ("" if mod else "-dense"),
        family="dense",
        n_layers=36,
        d_model=4096,
        d_ff=14336,
        vocab=49152,
        max_seq_len=32768,
        attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=10000.0),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("granite-8b")
def granite_8b() -> ModelConfig:
    return _base(mod=True)


@register("granite-8b-dense")
def granite_8b_dense() -> ModelConfig:
    return _base(mod=False)
