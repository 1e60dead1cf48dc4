"""Execution backends (``repro.serverless.backends``): the emulated one."""
