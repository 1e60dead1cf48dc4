"""Launch drivers (``repro.launch`` for the port): the emulation driver."""
