"""Synthetic data (``repro.data`` in torch)."""
