"""Integrators, thermostat and temperature ramps (counterpart of
``mdtpu.integrate``)."""
