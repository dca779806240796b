"""Registered architectures of the port (self-register on import)."""
from repro_torch.configs import mamba2_1p3b, mod_paper, olmoe_1b_7b, phi35_moe  # noqa: F401
