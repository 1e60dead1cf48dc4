"""PyTorch/CUDA port of FuncPipe (``repro``), checked against the JAX package.

The package mirrors ``repro``'s module paths: ``repro_torch.models.attention``
is the counterpart of ``repro.models.attention``, and so on.  It imports
torch and numpy, never jax and nothing of ``repro``.  Entry points take a
``device`` argument that defaults to ``"cuda"`` and raise when CUDA is absent.
"""
