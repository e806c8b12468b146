"""Trajectory and snapshot files (counterpart of ``mdtpu.io``)."""
