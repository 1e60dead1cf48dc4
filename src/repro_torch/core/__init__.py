"""Planning tables (``repro.core``): profiles, partitions, cost tables."""
