"""mamba2-1.3b [ssm] — SSD, attention-free [arXiv:2405.21060].

The JAX package's ``configs/mamba2_1p3b.py``, copied: 48L d_model=2048
d_ff=0 vocab=50280 (padded to 50304 = 393*128) ssm_state=128, MoD routing
around every other SSD block at 12.5% capacity, and its ``-dense`` twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, SSMConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b" + ("" if mod else "-dense"),
        family="ssm",
        n_layers=48,
        d_model=2048,
        d_ff=0,
        vocab=50304,  # 50280 padded to /128
        max_seq_len=524288,
        attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128),  # unused (attn-free)
        ssm=SSMConfig(enabled=True, d_state=128, d_conv=4, expand=2, head_dim=64, chunk=128),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("mamba2-1.3b")
def mamba2() -> ModelConfig:
    return _base(mod=True)


@register("mamba2-1.3b-dense")
def mamba2_dense() -> ModelConfig:
    return _base(mod=False)
