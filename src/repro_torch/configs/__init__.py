"""Registered architectures of the port (self-register on import)."""
from repro_torch.configs import mod_paper  # noqa: F401
