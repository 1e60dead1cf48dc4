"""Deployment plans (``repro.api``): load, save and resolve."""
