"""Core types and periodic-box math (counterpart of ``mdtpu.core``)."""
