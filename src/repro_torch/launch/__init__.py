"""Launch drivers (``repro.launch`` for the port): the emulation driver, the
rank mesh (``mesh``) and the mesh training driver (``train``)."""
