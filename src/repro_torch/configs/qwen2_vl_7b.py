"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].

The JAX package's ``configs/qwen2_vl_7b.py``, copied: the qwen2-7b
backbone (28L d_model=3584 28H, GQA kv=4, d_ff 18944, vocab 152064, q/k/v
biases, rope θ 1e6) with M-RoPE sections (16, 24, 24) over the 64 rotary
pairs. The vision tower is a stub: the model takes pre-merged text+patch
embeddings (B, S, D) and 3D position ids (3, B, S). MoD every other block
at 12.5% capacity, and its ``-dense`` twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b" + ("" if mod else "-dense"),
        family="vlm",
        n_layers=28,
        d_model=3584,
        d_ff=18944,
        vocab=152064,
        max_seq_len=32768,
        vision_stub=True,
        attn=AttentionConfig(
            n_heads=28,
            n_kv_heads=4,
            head_dim=128,
            qkv_bias=True,
            rope_theta=1e6,
            pos_emb="mrope",
            mrope_sections=(16, 24, 24),
        ),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("qwen2-vl-7b")
def qwen2_vl() -> ModelConfig:
    return _base(mod=True)


@register("qwen2-vl-7b-dense")
def qwen2_vl_dense() -> ModelConfig:
    return _base(mod=False)
