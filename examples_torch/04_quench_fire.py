"""BASELINE config 5 through the PyTorch/CUDA port: temperature-ramp quench
+ FIRE minimization (MolecularDynamics.jl src/temperature_ramps.jl,
src/minimize.jl). The JAX twin is ``examples/04_quench_fire.py``.

    python examples_torch/04_quench_fire.py             # on the card

``main(device="cpu")`` runs it on the CPU (the kernels' plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mdtpu_torch import (ExponentialRamp, NVT, Parameters, PseudoHS,
                         initial_temperature_for_velocities, initialize_state,
                         initialize_velocities, minimize, run_simulation)


def main(n_particles=512, ramp_steps=20_000, out="./out_quench", device=None):
    params = Parameters(density=0.9, n_particles=n_particles, dt=0.001,
                        potential=PseudoHS())
    ramp = ExponentialRamp(1.5, 0.01, ramp_steps)

    state = initialize_state(params, out, dimension=3, cutoff=1.5, seed=3,
                             device=device)
    t0 = initial_temperature_for_velocities(ramp)
    state = state.replace(velocities=initialize_velocities(
        t0, 4, n_particles, 3, device=device))

    state = run_simulation(state, params, NVT(ramp, 0.1), ramp_steps, 1000,
                           out, device=device)
    state, energy, converged, n_steps = minimize(state, params, out, 3,
                                                 tol=1e-6, device=device)
    print(f"quench done: E/N = {float(energy) / n_particles:.6f}, "
          f"FIRE converged={bool(converged)} in {int(n_steps)} steps")
    return state


if __name__ == "__main__":
    main()
