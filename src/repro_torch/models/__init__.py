"""Model layers, blocks and the dense decoder of the port."""
