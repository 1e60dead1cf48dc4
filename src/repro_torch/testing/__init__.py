"""Runnable equivalence harnesses of the mesh path (``repro.testing`` in torch)."""
