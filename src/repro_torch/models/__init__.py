"""Model math (``repro.models``): dense decoder serving in PyTorch."""
