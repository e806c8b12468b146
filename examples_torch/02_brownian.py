"""BASELINE config 3 through the PyTorch/CUDA port: overdamped Brownian
dynamics (MolecularDynamics.jl src/simulation.jl:181-308 intended
behaviour). The JAX twin is ``examples/02_brownian.py``.

    python examples_torch/02_brownian.py                # on the card

``main(device="cpu")`` runs it on the CPU (the kernels' plain versions)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mdtpu_torch import Brownian, Parameters, PseudoHS, initialize_state, run_simulation


def main(n_particles=1024, steps=20_000, out="./out_brownian", device=None):
    # dt: the Euler–Maruyama step is only conditionally stable on the steep
    # pseudo-HS core — stable at dt <= 2e-5 at this state point, divergent
    # at 5e-5+ (run_simulation raises on divergence rather than writing
    # garbage). The reference's own Brownian routine is unrunnable as
    # written (state.boxl), so no reference dt exists.
    params = Parameters(density=0.5, n_particles=n_particles, dt=1e-5,
                        potential=PseudoHS())
    state = initialize_state(params, out, dimension=3, cutoff=1.5, seed=2,
                             device=device)
    state = run_simulation(state, params, Brownian(1.0), steps, 500, out,
                           log_times=True, device=device)
    print(f"Brownian done at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
