"""Train and serve steps of the rank mesh (``repro.train`` in torch)."""
