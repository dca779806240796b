"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``routing``: gather / gated scatter-add; ``flash_attention``;
``swiglu``: the SwiGLU MLP and the routed MLP; ``paged``: page gather /
row scatter of the paged KV pool; ``ragged``: the flat stream's MoD
dispatch, the mixed step's write-back and flash attention over the pages;
``ssd``: the Mamba2 SSD intra-chunk quadratic), the JAX-signature op entry
point over all of them (``ops``), and the builder that compiles ``csrc/``
at first use (``build``)."""
