"""BASELINE config 1 + 2 through the PyTorch/CUDA port: the reference README
workflow (MolecularDynamics.jl README.md:11-66) — N=1024 monodisperse
pseudo-hard-sphere fluid in 3D, NVT equilibration at kT=1.4737 (tau = 100
dt), then NVE production from the equilibrated state. The JAX twin is
``examples/01_pseudohs_nvt_nve.py``.

    python examples_torch/01_pseudohs_nvt_nve.py        # on the card

``main(device="cpu")`` runs it on the CPU (the kernels' plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mdtpu_torch import (NVE, NVT, Parameters, PseudoHS, initialize_state,
                         initialize_velocities, run_simulation)


def main(n_particles=1024, nvt_steps=10_000, nve_steps=10_000, out="./out_phs",
         device=None):
    ktemp = 1.4737
    params = Parameters(density=0.76, n_particles=n_particles, dt=0.001,
                        potential=PseudoHS())

    state = initialize_state(params, out, dimension=3, cutoff=1.5, seed=0,
                             device=device)
    state = state.replace(velocities=initialize_velocities(
        ktemp, 1, n_particles, 3, device=device))

    ensemble = NVT(ktemp, 100 * 0.001)
    state = run_simulation(state, params, ensemble, nvt_steps, 100, out,
                           device=device)
    print(f"NVT done: T = {float(state.temperature):.4f}")

    state = run_simulation(state, params, NVE(), nve_steps, 100,
                           out + "_nve", compress=True, device=device)
    print(f"NVE done: E/N = {float(state.energy) / n_particles:.6f}")
    return state


if __name__ == "__main__":
    main()
