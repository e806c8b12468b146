"""The particle rows' drift test and Brownian move
(``philox_draws.rebuild_flag_rows``, ``verlet_update.brownian_rows``; the
kernels ``rebuild_rows_kernel`` and ``brownian_rows_kernel``) on the CPU,
where no kernel runs:

  * the box lengths taken as a view of any stride (the cell's diagonal, as
    the neighbour list passes it), equal to the contiguous lengths;
  * the launch options both kernels take (programmatic, or plain stream
    order inside ``plain_launch``) and the census's names for the
    programmatic edges into them;
  * the drift test's argument checks, on tensors of the ``meta`` device,
    which reach the checks and no kernel, and the Brownian move's refusal
    of a host step in place.
The card holds the kernels to their plain versions at the edges of their
grid, on misaligned views too (``tests/test_torch_gpu.py``,
``chip_smoke.py``); ``tests/test_torch_particle_advance.py`` holds the plain
versions to the JAX package."""

import types

import pytest
import torch

from mdtpu_torch.integrate import verlet_update as vu
from mdtpu_torch.ops import philox_draws as draws

DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("name", DTYPES)
def test_lengths_may_be_the_cells_diagonal(name, d):
    dtype = DTYPES[name]
    g = torch.Generator().manual_seed(d)
    cell = torch.eye(d, dtype=torch.float64) * 9.0
    ref = torch.rand((500, d), generator=g, dtype=torch.float64) * 9.0
    pos = ref + (torch.rand((500, d), generator=g, dtype=torch.float64)
                 - 0.5) * 0.15
    pos[17] = ref[17] + 8.95      # across the face: the minimum image
    pos[18] = ref[18] + 0.2       # past skin/2
    diag = torch.diagonal(cell.to(dtype))
    assert diag.stride(0) == d + 1
    for rows, want in ((pos[:18], False), (pos, True)):
        rows, r = rows.to(dtype), ref[:rows.shape[0]].to(dtype)
        out = torch.empty((), dtype=torch.bool)
        got = draws.rebuild_flag_rows(rows, r, 0.3, lengths=diag, out=out)
        assert got is out and bool(got) is want
        assert bool(draws.rebuild_flag_rows(
            rows, r, 0.3, lengths=diag.contiguous())) is want


def test_both_kernels_take_the_launch_options():
    assert draws.launch_options() == 1
    with draws.plain_launch():
        assert draws.launch_options() == 0
        with draws.plain_launch():
            assert draws.launch_options() == 0
        assert draws.launch_options() == 0
    assert draws.launch_options() == 1
    assert draws.CENSUS[-1] == "programmatic_into_rebuild_rows"
    assert "programmatic_into_brownian_rows" in vu.capture_census.__doc__


def _meta_rows(n=1000, d=3, dtype=torch.float32):
    return torch.empty(n, d, dtype=dtype, device="meta")


@pytest.mark.parametrize("wrong", ["none", "ref_dtype", "strided",
                                   "cell_shape", "lengths_shape",
                                   "lengths_dtype", "box_device",
                                   "ref_device"])
def test_rebuild_flag_rows_refuses_what_its_kernel_does_not_take(wrong):
    """Every check of the card's branch before the device's: valid
    arguments get as far as the device (``meta`` is not CUDA)."""
    pos, ref = _meta_rows(), _meta_rows()
    box = {"cell": torch.empty(3, 3, device="meta"),
           "cell_inv": torch.empty(3, 3, device="meta")}
    if wrong == "ref_dtype":
        ref = ref.double()
    elif wrong == "strided":
        pos = torch.empty(3, 1000, device="meta").t()
    elif wrong == "cell_shape":
        box["cell"] = torch.empty(2, 2, device="meta")
    elif wrong == "lengths_shape":
        box = {"lengths": torch.empty(3, 3, device="meta")}
    elif wrong == "lengths_dtype":
        box = {"lengths": torch.empty(3, dtype=torch.float64,
                                      device="meta")}
    elif wrong == "box_device":
        box["cell_inv"] = torch.empty(3, 3)
    elif wrong == "ref_device":
        ref = torch.empty(1000, 3)
    match = "not meta" if wrong == "none" else "contiguous rows"
    with pytest.raises(ValueError, match=match):
        draws.rebuild_flag_rows(pos, ref, 0.3, **box)
    with pytest.raises(ValueError, match=match):
        draws.rebuild_flag_rows(pos, ref, 0.3, **(
            box if "cell" not in box else
            {"lengths": torch.diagonal(box["cell_inv"])}
            if wrong in ("none", "ref_dtype", "strided", "ref_device")
            else box))


def test_rebuild_flag_rows_takes_one_box_and_no_cpu_handle():
    pos = torch.zeros(10, 3)
    cell = torch.eye(3) * 5.0
    with pytest.raises(ValueError):
        draws.rebuild_flag_rows(pos, pos, 0.3, cell=cell, cell_inv=cell,
                                lengths=torch.diagonal(cell))
    with pytest.raises(ValueError):
        draws.rebuild_flag_rows(pos, pos, 0.3)
    with pytest.raises(ValueError):
        draws.rebuild_flag_rows(pos, pos, 0.3, lengths=torch.diagonal(cell),
                                handle=1)
    with pytest.raises(ValueError):
        draws.rebuild_flag_rows(pos[:, :1].contiguous(),
                                pos[:, :1].contiguous(), 0.3,
                                lengths=torch.ones(1))


def test_brownian_rows_in_place_takes_a_device_step():
    x = torch.zeros(10, 3)
    st = types.SimpleNamespace(
        positions=x, pos_comp=x.clone(),
        images=torch.zeros(10, 3, dtype=torch.int64),
        unitcell=torch.eye(3), unitcell_inv=torch.eye(3), seed=3, step=7,
        virial_accum=torch.zeros(()), nprom=torch.zeros((), dtype=torch.int64),
        temperature=torch.zeros(()), dtype=torch.float32, device=x.device)
    with pytest.raises(ValueError, match="device step counter"):
        vu.brownian_rows(x, torch.zeros(()), st, 1e-5, 0.004, 1.0, True,
                         in_place=True)
