"""The CUDA pair sweep against its plain PyTorch version on the card, at f64
and f32, for the three potentials the kernel knows.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
without one. On a machine with a card (the JAX package need not be
installed there):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from mdtpu_torch.ops import cell_sweep as sweep_mod
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.potentials.lennard_jones import LennardJones
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.potentials.xplor import LennardJonesXPLOR
from mdtpu_torch.sim.initialization import lattice_fluid_state

pytestmark = pytest.mark.gpu

POTENTIALS = {
    "lj": (LennardJones(r_cut=2.5, force_shift=True), 2.5, 0.8),
    "pseudo_hs": (PseudoHS(), 1.5, 0.76),
    "xplor": (LennardJonesXPLOR(r_on=2.0, r_cut=2.5), 2.5, 0.8),
}
# f64: the two sum in different orders; f32 additionally rounds each pair.
TOLERANCES = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 1e-5)}
# Lattice jitter in standard normals of the spacing: small enough that no
# pair comes much closer than 0.9 sigma, so no single r^-50 (pseudo-hard
# sphere) or r^-12 force dwarfs the rest.
JITTER = 0.03


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(POTENTIALS))
def test_kernel_matches_plain(cuda, name, dtype):
    pot, cutoff, rho = POTENTIALS[name]
    n = 20000
    state = lattice_fluid_state(n, rho, 1.0, dtype=dtype, cutoff=cutoff,
                                jitter=JITTER, device=cuda)
    diam = (1.0 + 0.1 * torch.rand(n, generator=torch.Generator().manual_seed(0),
                                   dtype=dtype)).to(cuda)
    eng = CellGridEngine.create(pot, cutoff, 0.3, state.unitcell, n,
                                diameters=diam)
    nb = eng.allocate(state.positions, diam, state.unitcell,
                      state.unitcell_inv)
    assert not bool(nb.overflow)
    inputs = eng.slot_inputs(state.positions, state.unitcell,
                             state.unitcell_inv, nb)
    before = sweep_mod.cell_sweep.launches
    e1, w1, f1 = sweep_mod.cell_sweep(*inputs, eng.grid, eng.cutoff, pot)
    torch.cuda.synchronize()
    assert sweep_mod.cell_sweep.launches == before + 1
    e0, w0, f0 = sweep_mod.cell_sweep_plain(*inputs, eng.grid, eng.cutoff,
                                            pot)
    rtol_ew, tol_f = TOLERANCES[dtype]
    np.testing.assert_allclose(float(e1), float(e0), rtol=rtol_ew)
    np.testing.assert_allclose(float(w1), float(w0), rtol=rtol_ew)
    # Each particle is held to its own force, or to the RMS force where its
    # own is smaller (a nearly balanced particle).
    err = (f1 - f0).norm(dim=0)
    mag = f0.norm(dim=0)
    rms = torch.sqrt((mag * mag).sum() / n)
    assert float((err / mag.clamp(min=rms)).max()) <= tol_f


def test_unknown_potential_raises_on_cuda(cuda):
    class Custom(LennardJones):
        pass

    state = lattice_fluid_state(2000, 0.8, 1.0, cutoff=2.5, device=cuda)
    eng = CellGridEngine.create(Custom(), 2.5, 0.3, state.unitcell, 2000)
    nb = eng.allocate(state.positions, state.diameters, state.unitcell,
                      state.unitcell_inv)
    with pytest.raises(NotImplementedError):
        eng.compute(state.positions, state.diameters, state.unitcell,
                    state.unitcell_inv, nb)
