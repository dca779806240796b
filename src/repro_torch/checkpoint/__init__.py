"""Fault-tolerant checkpointing, in the JAX package's on-disk format."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
