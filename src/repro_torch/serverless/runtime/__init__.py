"""Object store and stage spans (``repro.serverless.runtime``)."""
