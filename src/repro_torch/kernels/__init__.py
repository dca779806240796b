"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``routing``: gather / gated scatter-add; ``flash_attention``;
``swiglu``: the routed MLP; ``paged``: page gather / row scatter of the
paged KV pool; ``ragged``: the mixed step's write-back; ``ssd``: the
Mamba2 SSD intra-chunk quadratic), and the builder
that compiles ``csrc/`` at first use (``build``)."""
