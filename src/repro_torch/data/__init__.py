"""Synthetic data and document packing (numpy only), and the host loader."""
