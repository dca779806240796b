"""qwen2-7b [dense] — GQA with QKV bias [arXiv:2407.10671].

The JAX package's ``configs/qwen2_7b.py``, copied: 28L d_model=3584 28H
(GQA kv=4, a group of 7) d_ff=18944 vocab=152064, q/k/v biases, rope θ 1e6,
MoD every other block at 12.5% capacity, and its ``-dense`` twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b" + ("" if mod else "-dense"),
        family="dense",
        n_layers=28,
        d_model=3584,
        d_ff=18944,
        vocab=152064,
        max_seq_len=32768,
        attn=AttentionConfig(
            n_heads=28, n_kv_heads=4, head_dim=128, qkv_bias=True, rope_theta=1e6
        ),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("qwen2-7b")
def qwen2_7b() -> ModelConfig:
    return _base(mod=True)


@register("qwen2-7b-dense")
def qwen2_7b_dense() -> ModelConfig:
    return _base(mod=False)
