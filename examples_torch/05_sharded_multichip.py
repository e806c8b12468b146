"""Multi-GPU (sharded) simulation through the PyTorch/CUDA port's
run_simulation_sharded — the slot-layout halo engine: spatial domain
decomposition over the ranks of a ``torch.distributed`` group with
on-device particle migration (see mdtpu_torch/parallel/halo_slot.py). The
JAX twin is ``examples/05_sharded_multichip.py``, which fakes an 8-device
CPU mesh.

Run P ranks, one per GPU, with torchrun (it sets the group's address, rank
and world size; the script forms an NCCL group from them):

    torchrun --nproc-per-node P examples_torch/05_sharded_multichip.py

Run alone (``python examples_torch/05_sharded_multichip.py``), with no
group initialised, it runs on a ring of one: one rank on the card, which
still takes the sharded engine's slab launch. ``main`` called from a
process that has initialised a group runs over that group (gloo with
``device="cpu"`` for CPU ranks). Every rank packs the same start from the
same seed and gets the final state back; rank 0 writes the files."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from mdtpu_torch import (NVT, Parameters, PseudoHS, initialize_state,
                         initialize_velocities, run_simulation_sharded)
from mdtpu_torch.parallel import ShardRing


def main(n_particles=4096, steps=2_000, out="./out_sharded", device=None):
    ktemp = 1.4737
    ring = ShardRing(device=device)  # the default group, else a ring of one
    params = Parameters(density=0.4, n_particles=n_particles, dt=0.001,
                        potential=PseudoHS())
    state = initialize_state(params, out, dimension=3, cutoff=1.5,
                             dtype=torch.float32, seed=0, device=ring.device)
    state = state.replace(velocities=initialize_velocities(
        ktemp, 1, n_particles, 3, dtype=torch.float32, device=ring.device))

    # Default engine = HaloSlotEngine over every rank; outputs (thermo,
    # trajectory, final.xyz) are identical in format and particle order to
    # the single-device run_simulation's.
    final = run_simulation_sharded(state, params, NVT(ktemp, 100 * params.dt),
                                   total_steps=steps, frequency=500,
                                   pathname=out, device=ring.device)
    if ring.rank == 0:
        print(f"done: {final.n_particles} particles over "
              f"{ring.size} devices, T = {float(final.temperature):.4f}")
    return final


if __name__ == "__main__":
    if "WORLD_SIZE" in os.environ:  # started by torchrun
        import torch.distributed as dist

        dist.init_process_group("nccl")
        try:
            main()
        finally:
            dist.destroy_process_group()
    else:
        main()
