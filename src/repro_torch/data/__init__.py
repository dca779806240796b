"""Synthetic data (numpy only)."""
