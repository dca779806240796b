"""whisper-tiny [audio] — enc-dec; the conv frontend is a stub [arXiv:2212.04356].

The JAX package's ``configs/whisper_tiny.py``, copied: 4 decoder and 4
encoder layers, d_model 384, 6 heads (kv 6, head_dim 64), d_ff 1536, vocab
51865 padded to 51968, a plain GELU MLP (no GLU), 1500 encoder frames
(precomputed mel-frame embeddings (B, 1500, 384)), MoD around whole
decoder blocks every other layer at 12.5% capacity, and its ``-dense``
twin.
"""
from repro_torch.config import AttentionConfig, MoDConfig, ModelConfig, register


def _base(mod: bool) -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny" + ("" if mod else "-dense"),
        family="encdec",
        n_layers=4,
        n_enc_layers=4,
        enc_seq_len=1500,
        d_model=384,
        d_ff=1536,
        vocab=51968,  # 51865 padded to /128
        max_seq_len=32768,
        act="gelu",
        glu=False,
        attn=AttentionConfig(n_heads=6, n_kv_heads=6, head_dim=64),
        mod=MoDConfig(enabled=mod, capacity_ratio=0.125, every=2),
        dtype="bfloat16",
        remat="full",
    )


@register("whisper-tiny")
def whisper_tiny() -> ModelConfig:
    return _base(mod=True)


@register("whisper-tiny-dense")
def whisper_tiny_dense() -> ModelConfig:
    return _base(mod=False)
