"""Pair potentials (counterpart of ``mdtpu.potentials``)."""
