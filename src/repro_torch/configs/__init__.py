"""Registered architectures of the port (self-register on import)."""
from repro_torch.configs import (  # noqa: F401
    granite_8b,
    granite_20b,
    mamba2_1p3b,
    mistral_nemo_12b,
    mod_paper,
    olmoe_1b_7b,
    phi35_moe,
    qwen2_7b,
    qwen2_vl_7b,
    whisper_tiny,
    zamba2_2p7b,
)
