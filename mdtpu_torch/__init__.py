"""mdtpu_torch — the PyTorch/CUDA port of mdtpu for NVIDIA Hopper.

Classical molecular dynamics of soft-sphere fluids in periodic boxes: NVT
(Bussi) and NVE velocity Verlet, pair potentials (pseudo-hard-sphere,
Lennard-Jones, LJ-XPLOR), thermo and LAMMPS trajectory output. The pair
forces of 3D orthorhombic systems come from a cell grid whose sweep is a
hand-written CUDA kernel (``csrc/cell_sweep.cu``); small and other systems
use the O(N^2) engine.

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
from mdtpu_torch.ops import NaivePairEngine, select_engine
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
    "PseudoHS", "LennardJones", "LennardJonesXPLOR",
    "LinearRamp", "ExponentialRamp", "initial_temperature_for_velocities",
    "Potential", "evaluate", "energy_lrc", "pressure_lrc",
    "compute_kinetic", "compute_temperature",
    "NaivePairEngine", "select_engine",
]
