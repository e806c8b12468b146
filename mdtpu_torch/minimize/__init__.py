"""Energy minimization (FIRE): ``minimize`` and the minimizers of
:mod:`mdtpu_torch.minimize.fire`."""

from __future__ import annotations

import os

from mdtpu_torch.minimize.fire import (fire_minimize, fire_minimize_sharded,
                                      fire_minimize_slots)


def minimize(state, params, pathname, dimension=None, *, engine=None,
             method="FIRE", save_config="minimized.xyz", device=None,
             **kwargs):
    """Minimize with FIRE and write the final configuration to
    ``pathname/save_config``; counterpart of ``mdtpu.minimize.minimize``.
    ``dimension`` is checked against the state's (signature parity).
    ``device``: where it runs, ``"cuda"`` by default. Returns ``(state,
    energy, converged, n_steps)``."""
    from mdtpu_torch.io.xyz import write_xyz
    from mdtpu_torch.ops import select_engine

    if method not in ("FIRE", ":FIRE"):
        raise ValueError(f"unknown minimization method: {method}")
    if dimension is not None and int(dimension) != int(state.dimension):
        raise ValueError(
            f"dimension={dimension} does not match state.dimension="
            f"{int(state.dimension)}")
    if engine is None:
        engine = select_engine(params.potential, state.cutoff, state,
                               workload="minimize")
    state, energy, converged, n_steps = fire_minimize(
        state, params, engine, device=device, **kwargs)
    os.makedirs(pathname, exist_ok=True)
    write_xyz(os.path.join(pathname, save_config), 0, state.unitcell,
              state.positions, state.diameters, mode="w")
    return state, energy, converged, n_steps


__all__ = ["minimize", "fire_minimize", "fire_minimize_sharded",
           "fire_minimize_slots"]
