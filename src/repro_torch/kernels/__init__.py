"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``routing``: gather / gated scatter-add; ``flash_attention``),
and the builder that compiles ``csrc/`` at first use (``build``)."""
