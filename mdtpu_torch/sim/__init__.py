"""State construction and the simulation driver (counterpart of
``mdtpu.sim``)."""
