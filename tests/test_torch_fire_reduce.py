"""FIRE's two reductions (``fire_reduce``, ``fire_test`` in
``mdtpu_torch/csrc/fire_update.cu``) and its move (``fire_move``) on the
CPU, where no kernel runs:

  * the buffers ``buffers`` makes on the CPU (``work`` one value: the
    plain versions do not read it; the kernels' library sizes it on the
    card);
  * the wrappers' argument checks (dtype, device, contiguity, ``red``'s
    length, the mode; the move's shape, dimension, images and box), on
    tensors of the ``meta`` device, which reach the checks and no
    kernel.
The card holds the kernels themselves to the plain versions at the edges
of their grid, and the grid the library sizes (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import pytest
import torch

from mdtpu_torch.minimize import fire_update as fu

DTYPES = {"f64": torch.float64, "f32": torch.float32}


@pytest.mark.parametrize("name", DTYPES)
def test_cpu_buffers_hold_one_work_value(name):
    dtype = DTYPES[name]
    scal, ints, red, work, flags = fu.buffers(dtype, "cpu", 9999)
    assert work.dtype == dtype and work.numel() == 1 and not work.any()
    assert (scal.numel(), ints.numel(), red.numel(), flags.numel()) == (
        fu.SCAL, fu.INTS, 2 * fu.RED, 2)
    assert (scal.dtype, ints.dtype, red.dtype, flags.dtype) == (
        dtype, torch.int64, dtype, torch.bool)


def _meta_buffers(dtype, n):
    return [t.to("meta") for t in fu.buffers(dtype, "cpu", n)]


def _reduce(v, f, scal, ints, red, work, **kw):
    fu.fire_reduce(v, f, scal, ints, red, work, fu.FireHyper(), **kw)


def _test(f, scal, ints, red, work, flags, **kw):
    fu.fire_test(f, scal, ints, red, work, 1.0, flags, **kw)


@pytest.mark.parametrize("wrong", ["int_forces", "v_dtype", "red_dtype",
                                   "work_dtype", "mode", "strided", "device",
                                   "overflow_dtype"])
def test_fire_reduce_refuses_what_its_kernel_does_not_take(wrong):
    n = 3 * 700
    f = torch.empty(3, 700, device="meta")
    v = torch.empty(3, 700, device="meta")
    scal, ints, red, work, _ = _meta_buffers(torch.float32, n)
    kw = {}
    if wrong == "int_forces":
        f = f.to(torch.int32)
    elif wrong == "v_dtype":
        v = v.double()
    elif wrong == "red_dtype":
        red = red.double()
    elif wrong == "work_dtype":
        work = work.double()
    elif wrong == "mode":
        kw["mode"] = fu.MAXIMA | fu.TAIL
    elif wrong == "strided":
        f, v = f.t(), v.t()
    elif wrong == "device":
        scal = torch.empty(scal.shape, dtype=scal.dtype)
    elif wrong == "overflow_dtype":
        kw["overflow"] = torch.empty((), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        _reduce(v, f, scal, ints, red[:fu.RED], work, **kw)


@pytest.mark.parametrize("wrong", ["flags_dtype", "one_flag", "drift_dtype",
                                   "red_short", "device"])
def test_fire_test_refuses_what_its_kernel_does_not_take(wrong):
    f = torch.empty(5000, 3, dtype=torch.float64, device="meta")
    scal, ints, red, work, flags = _meta_buffers(torch.float64, f.numel())
    kw = {}
    red = red[fu.RED:]
    if wrong == "flags_dtype":
        flags = flags.to(torch.uint8)
    elif wrong == "one_flag":
        flags = flags[:1]
    elif wrong == "drift_dtype":
        kw["drift"] = torch.empty((), dtype=torch.float64, device="meta")
    elif wrong == "red_short":
        red = red[:fu.RED - 1]
    elif wrong == "device":
        ints = torch.empty(ints.shape, dtype=ints.dtype)
    with pytest.raises(ValueError):
        _test(f, scal, ints, red, work, flags, **kw)


def _move(x, v, f, scal, ints, **kw):
    fu.fire_move(x, v, f, scal, ints, 0.1, **kw)


@pytest.mark.parametrize("wrong", ["int_forces", "v_dtype", "x_shape",
                                   "one_dim", "strided", "device",
                                   "overflow_dtype", "scal_short",
                                   "rows_four", "slots_one", "images_slots",
                                   "images_dtype", "images_shape",
                                   "cell_shape", "cell_device"])
def test_fire_move_refuses_what_its_kernel_does_not_take(wrong):
    """The move's wrapper refuses, before any launch, what its kernels do
    not take: float32 or float64 of one dtype, one 2-d shape, contiguous
    on one device, d 2 or 3 (slots (d, S), rows (N, d)), a bool overflow
    flag, and the wrap on rows alone with int64 images of their shape and
    a (d, d) box on their device."""
    rows = not wrong.startswith(("slots", "images_slots"))
    shape = (700, 3) if rows else (3, 700)
    f, v, x = (torch.empty(shape, device="meta") for _ in range(3))
    scal, ints, _, _, _ = _meta_buffers(torch.float32, 2100)
    box = dict(images=torch.empty(shape, dtype=torch.int64, device="meta"),
               cell=torch.empty(3, 3, device="meta"),
               cell_inv=torch.empty(3, 3, device="meta"))
    kw = dict(rows=rows, **(box if rows else {}))
    if wrong == "int_forces":
        f = f.to(torch.int32)
    elif wrong == "v_dtype":
        v = v.double()
    elif wrong == "x_shape":
        x = torch.empty(699, 3, device="meta")
    elif wrong == "one_dim":
        f, v, x = (t.reshape(-1) for t in (f, v, x))
        kw = dict(rows=True)
    elif wrong == "strided":
        f, v, x = (torch.empty(3, 700, device="meta").t() for _ in range(3))
    elif wrong == "device":
        ints = torch.empty(ints.shape, dtype=ints.dtype)
    elif wrong == "overflow_dtype":
        kw["overflow"] = torch.empty((), dtype=torch.int64, device="meta")
    elif wrong == "scal_short":
        scal = scal[:fu.SCAL - 1]
    elif wrong == "rows_four":
        f, v, x = (torch.empty(700, 4, device="meta") for _ in range(3))
        kw = dict(rows=True)
    elif wrong == "slots_one":
        f, v, x = (torch.empty(1, 700, device="meta") for _ in range(3))
    elif wrong == "images_slots":
        kw.update(box)
        kw["images"] = torch.empty(shape, dtype=torch.int64, device="meta")
    elif wrong == "images_dtype":
        kw["images"] = kw["images"].to(torch.int32)
    elif wrong == "images_shape":
        kw["images"] = torch.empty(699, 3, dtype=torch.int64, device="meta")
    elif wrong == "cell_shape":
        kw["cell"] = torch.empty(2, 2, device="meta")
    elif wrong == "cell_device":
        kw["cell_inv"] = torch.empty(3, 3)
    with pytest.raises(ValueError):
        _move(x, v, f, scal, ints, **kw)


@pytest.mark.parametrize("name", DTYPES)
def test_work_of_the_buffers_passes_the_checks(name):
    """The buffers ``buffers`` makes pass the reductions' checks in every
    mode, at counts from one value to many blocks."""
    dtype = DTYPES[name]
    for n in (1, 3, 2047, 2049, 9999, 70001):
        f = torch.empty(n, dtype=dtype, device="meta")
        scal, ints, red, work, flags = _meta_buffers(dtype, n)
        fu._check("fire_reduce", f, scal, ints, (f, red, work))
        fu._check("fire_test", f, scal, ints, (red, work), (flags,))
        for mode in (fu.ONE_PASS, fu.MAXIMA, fu.SUMS, fu.TAIL):
            fu._check_reduction("fire_reduce", red[:fu.RED], mode)
