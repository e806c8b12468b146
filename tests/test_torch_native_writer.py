"""The host C++ frame formatter (``mdtpu_torch.io.native_writer``) against
the plain Python one (``format_lammps_frame``) and the JAX package's native
writer, byte for byte: ``tests/test_io.py``'s adversarial frame (rounding
ties and the band around them, signed zeros, large magnitudes) in a tilted
3D box and in 2D; a snapshot file and a zstd round trip through the writer
thread; and the values whose ``"%.6f"`` overruns the JAX writer's row
(ROADMAP C3: magnitudes from 1e57 up, infinities, NaN), printed as Python
prints them. A formatter that does not build raises with the compiler's
output."""

import numpy as np
import pytest

from mdtpu.io.lammps import format_lammps_frame as j_format_lammps
from mdtpu.io.native_writer import NativeTrajectoryWriter
from mdtpu_torch.io.compress import decompressed_chunks
from mdtpu_torch.io.lammps import format_lammps_frame
from mdtpu_torch.io.native_writer import format_frame
from mdtpu_torch.io.writer import TrajectoryWriter
from mdtpu_torch.ops import _cuda_build

CELL = np.array([[31.7, 1.3, 0.0], [0.0, 29.9, 2.1], [0.0, 0.0, 28.4]])
C3_VALUES = [1e57, -1e57, 1e300, -1e300, 1.7976931348623157e308, np.inf,
             -np.inf, np.nan, -np.nan, 5e-324]


def adversarial_frame(n=4096):
    """``tests/test_io.py::test_native_writer_byte_parity_adversarial``'s
    frame: positions, images, diameters."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(-60.0, 60.0, (n, 3))
    ties = (rng.integers(0, 10_000_000, 256).astype(np.float64) + 0.5) * 1e-6
    edge = ties + rng.choice([-1.2e-3, 1.2e-3], 256) * 1e-6
    special = np.array([0.0, -0.0, 1e-9, -1e-9, 0.9999995, -0.9999995,
                        1.0000005, 2.5e-7, -2.5e-7, 123456.7890005,
                        4.2e6, -4.2e6, 5.0e12, 0.5e-6, -0.5e-6, 1.5e-6])
    adv = np.concatenate([ties, edge, np.tile(special, 33)])[: 3 * (n // 4)]
    pos.reshape(-1)[: adv.size] = adv
    img = rng.integers(-700, 700, (n, 3)).astype(np.int32)
    diam = rng.uniform(0.5, 2.5, n)
    return pos, img, diam


def _jax_native(path, step, cell, pos, img, diam):
    w = NativeTrajectoryWriter(str(path))
    w.write_frame(step, cell, pos, img, diam)
    w.close()
    return path.read_bytes()


@pytest.mark.parametrize("dim", [3, 2])
def test_native_formatter_is_byte_identical(tmp_path, dim):
    pos, img, diam = adversarial_frame()
    if dim == 2:
        pos, img, diam = pos[:512, :2], img[:512, :2], diam[:512]
    cell = CELL[:dim, :dim]
    got = format_frame(12345, cell, pos, img, diam)
    want = format_lammps_frame(12345, cell, pos, img, diam)
    assert got == want.encode()
    assert want == j_format_lammps(12345, cell, pos, img, diam)
    assert got == _jax_native(tmp_path / "jax.lammps", 12345, cell, pos, img,
                              diam)


def test_c3_values_print_as_python():
    pos = np.zeros((len(C3_VALUES), 3))
    pos[:, 0] = C3_VALUES
    pos[:, 2] = -np.asarray(C3_VALUES)
    img = np.zeros(pos.shape, np.int32)
    img[:, 1] = 3
    diam = np.array(C3_VALUES)
    text = format_frame(-4, np.eye(3) * 10.0, pos, img, diam).decode()
    assert text == format_lammps_frame(-4, np.eye(3) * 10.0, pos, img, diam)
    rows = text.splitlines()[9:]
    for row, v in zip(rows, C3_VALUES):
        fields = row.split()
        assert fields[3] == fields[6] == f"{v:.6f}"
        assert fields[5] == fields[8] == f"{-v:.6f}"
        assert fields[2] == f"{v / 2.0:.6f}"
    assert {rows[7].split()[3], rows[8].split()[3]} == {"nan"}
    assert len(rows[4]) > 3 * 309   # three values of 309 integer digits


def test_writer_thread_snapshot_and_zstd(tmp_path):
    pos, img, diam = adversarial_frame(1024)
    want = format_lammps_frame(7, CELL, pos, img, diam)
    snap, traj = tmp_path / "snapshot.7", tmp_path / "trajectory.xyz.zst"
    w = TrajectoryWriter(str(traj), compress=True)
    w.write_snapshot(str(snap), 7, CELL, pos, img, diam)
    w.write_frame(7, CELL, pos, img, diam)
    w.write_frame(8, CELL, pos + 1.0, img, diam)
    w.close()
    assert snap.read_text() == want
    with open(traj, "rb") as f:
        text = b"".join(decompressed_chunks(f)).decode()
    assert text == want + format_lammps_frame(8, CELL, pos + 1.0, img, diam)


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                       monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "lammps_format.cc").write_text("int broken( {\n")
    monkeypatch.setattr(_cuda_build, "CSRC", csrc)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on "
                       "lammps_format.cc") as err:
        _cuda_build.build("lammps_format")
    assert "error: expected" in str(err.value)
    assert list((tmp_path / "_build").iterdir()) == []
