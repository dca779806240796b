"""Model layers, blocks, the dense decoder and the Mamba2 LM of the port."""
