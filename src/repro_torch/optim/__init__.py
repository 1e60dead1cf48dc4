"""Optimizers (``repro.optim`` in torch)."""
from repro_torch.optim.optimizers import SGD, AdamW, Optimizer  # noqa: F401
