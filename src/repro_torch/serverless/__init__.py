"""Serverless substrate (``repro.serverless``): platforms, cost terms, store."""
