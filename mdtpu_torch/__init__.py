"""mdtpu_torch — the PyTorch/CUDA port of mdtpu for NVIDIA Hopper.

Classical molecular dynamics of soft-sphere fluids in periodic boxes: NVT
(Bussi) and NVE velocity Verlet, pair potentials (pseudo-hard-sphere,
Lennard-Jones, LJ-XPLOR), thermo and LAMMPS trajectory output (zstd
optional), full-state checkpoints and crash resume, overdamped Brownian
dynamics, FIRE minimization and random packing; observables (g(r) through
a CUDA histogram kernel, MSD) in ``mdtpu_torch.observables``. The pair forces of
3D orthorhombic systems come from a cell grid whose sweeps are hand-written
CUDA kernels (``csrc/*.cu``: the full stencil with its hi/lo and lean
variants, and the Newton half stencil behind ``ops.experimental.PlaneEngine``);
on the cell grid, dynamics and FIRE run in the slot layout
(``integrate.slot_step``; its velocity-Verlet chain one kernel,
``integrate.verlet_update``). ``NeighborListEngine`` (``select_engine(...,
prefer="neighbor")``) keeps padded Verlet lists, built and evaluated by
CUDA kernels too. Small and other systems use the O(N^2) engine. Frames
are formatted in host C++ (``io.native_writer``). ``run_simulation_sharded``
and ``minimize.fire_minimize_sharded`` split the cell grid's slots over the
ranks of a ``torch.distributed`` group (``mdtpu_torch.parallel``).

The package imports torch and numpy, never JAX or ``mdtpu``. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from mdtpu_torch.core.types import (
    Brownian,
    ConstantSchedule,
    NVE,
    NVT,
    Parameters,
    SimulationState,
)
from mdtpu_torch.integrate.ramps import (
    ExponentialRamp,
    LinearRamp,
    initial_temperature_for_velocities,
)
from mdtpu_torch.integrate.thermostat import compute_kinetic, compute_temperature
from mdtpu_torch.minimize import fire_minimize, minimize
from mdtpu_torch.ops import (NaivePairEngine, NeighborListEngine,
                             select_engine)
from mdtpu_torch.parallel import run_simulation_sharded
from mdtpu_torch.potentials.base import Potential, energy_lrc, evaluate, pressure_lrc
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.sim.driver import run_simulation
from mdtpu_torch.sim.initialization import initialize_state, initialize_velocities

__version__ = "0.1.0"

__all__ = [
    "Parameters", "SimulationState", "NVT", "NVE", "Brownian",
    "ConstantSchedule",
    "initialize_state", "initialize_velocities", "run_simulation",
    "run_simulation_sharded",
    "minimize", "fire_minimize",
    "PseudoHS", "LennardJones", "LennardJonesXPLOR",
    "LinearRamp", "ExponentialRamp", "initial_temperature_for_velocities",
    "Potential", "evaluate", "energy_lrc", "pressure_lrc",
    "compute_kinetic", "compute_temperature",
    "NaivePairEngine", "NeighborListEngine", "select_engine",
]
