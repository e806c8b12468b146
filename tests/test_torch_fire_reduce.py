"""FIRE's two reductions (``fire_reduce``, ``fire_test`` in
``mdtpu_torch/csrc/fire_update.cu``) on the CPU, where no kernel runs:

  * the buffers ``buffers`` makes on the CPU (``work`` one value: the
    plain versions do not read it; the kernels' library sizes it on the
    card);
  * the wrappers' argument checks (dtype, device, contiguity, ``red``'s
    length, the mode), on tensors of the ``meta`` device, which reach the
    checks and no kernel.
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
