"""granite-20b [dense] — llama-arch code model, MQA (kv=1) [arXiv:2405.04324].

The JAX package's ``configs/granite_20b.py``, copied: 52L d_model=6144 48H
(one kv head) d_ff=24576 vocab=49152, MoD every other block at 12.5%
capacity, and its ``-dense`` twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="granite-20b" + ("" if mod else "-dense"),
        family="dense",
        n_layers=52,
        d_model=6144,
        d_ff=24576,
        vocab=49152,
        max_seq_len=32768,
        attn=AttentionConfig(n_heads=48, n_kv_heads=1, head_dim=128),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("granite-20b")
def granite_20b() -> ModelConfig:
    return _base(mod=True)


@register("granite-20b-dense")
def granite_20b_dense() -> ModelConfig:
    return _base(mod=False)
