"""PyTorch/CUDA port of the Mixture-of-Depths reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``config``, ``core/routing``, ``models/transformer``,
``serve/engine``, ...) and imports nothing of it. Entry points run on the
GPU unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper uses its kernel's plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
