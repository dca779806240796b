"""Registered architectures of the port (self-register on import)."""
from repro_torch.configs import mamba2_1p3b, mod_paper  # noqa: F401
