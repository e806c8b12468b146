"""Checkpoints, crash resume, zstd and the perf log of the port's driver,
held to the JAX package on the same numpy-seeded inputs (CPU, f64):

  * checkpoints: a round trip keeps every field bit for bit (dtypes,
    ``seed``); a JAX checkpoint loads into the port and a port checkpoint
    into the JAX package, fields bit for bit, each side keeping its
    template's random state; a 20-step NVE continuation from a JAX-written
    checkpoint through both packages agrees to rel 1e-9;
  * the driver: ``checkpoint_every`` off the output cadence writes the JAX
    package's file names; the checkpoint of label 20 holds step 21 on both
    routes (particle order and the slot route), its fields at rel 1e-9 of
    the JAX package's; a slot-route resume conserves energy to 1e-6;
  * crash resume into the same directory, plain and compressed: the same
    file names as the JAX package's directory after the same calls, the
    same labels, rows at rel 1e-9, and every row and frame of the first run
    kept byte for byte (particle order resumes exactly, so the whole
    directory equals the uninterrupted run's);
  * a ``log_times`` resume does not rewind: the JAX package's snapshots;
  * ``perf.txt``: the JAX package's header and number of rows. The port
    writes one row a segment (an output event or the tail); the JAX
    package one a batch of events, which is one event each when it stacks
    one frame a batch (``MDTPU_FRAME_STACK=0``), as its runs here do;
  * compress: the decompressed trajectory is the port's uncompressed one
    and the JAX package's, byte for byte; without libzstd
    ``compress=True`` raises before any file exists;
  * ``utils.profiling.trace`` writes a Chrome trace of a short run.

The JAX runs are module fixtures."""

import ctypes.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mdtpu_torch
from mdtpu.core.types import NVE as JNVE
from mdtpu.core.types import Parameters as JParameters
from mdtpu.io.checkpoint import load_checkpoint as j_load_checkpoint
from mdtpu.io.checkpoint import save_checkpoint as j_save_checkpoint
from mdtpu.io.compress import decompress_zstd as j_decompress_zstd
from mdtpu.ops.cell_grid import CellGridEngine as JCellGrid
from mdtpu.potentials.pseudo_hs import PseudoHS as JPHS
from mdtpu.sim.driver import run_simulation as j_run_simulation
from mdtpu.sim.initialization import build_state_from_arrays as j_build_state
from mdtpu_torch.io import compress as tcompress
from mdtpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.potentials.pseudo_hs import PseudoHS
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_driver import one_torch_thread  # noqa: F401

N, RHO, DT = 64, 0.5, 0.001
SLOT_N, SLOT_SKIN = 500, 0.3
KEY_SEED = 2
FIELDS = ("positions", "velocities", "forces", "images", "diameters",
          "unitcell", "unitcell_inv", "energy", "virial", "temperature",
          "pos_comp", "vel_comp")


def _arrays(n, seed=1):
    """A jittered cubic lattice at rho 0.5 with centred normal velocities."""
    rng = np.random.default_rng(seed)
    per = int(np.ceil(n ** (1 / 3)))
    L = (n / RHO) ** (1 / 3)
    idx = np.indices((per,) * 3).reshape(3, -1).T[:n]
    pos = (idx + 0.5) / per * L + 0.05 * rng.normal(size=(n, 3))
    vel = rng.normal(size=(n, 3))
    vel -= vel.mean(axis=0)
    return pos % L, vel, np.eye(3) * L


def _states(n=N):
    """The same f64 state in both packages."""
    pos, vel, cell = _arrays(n)
    jstate = j_build_state(pos, np.ones(n), cell,
                           jax.random.PRNGKey(KEY_SEED), velocities=vel,
                           dtype=jnp.float64, cutoff=1.5)
    tstate = build_state_from_arrays(pos, np.ones(n), cell, 9,
                                     velocities=vel, dtype=torch.float64,
                                     cutoff=1.5, device="cpu")
    return jstate, tstate


def _params(n=N):
    return (JParameters(density=RHO, n_particles=n, dt=DT, potential=JPHS()),
            mdtpu_torch.Parameters(RHO, n, DT, PseudoHS()))


def _slot_engines():
    _, _, cell = _arrays(SLOT_N)
    return (JCellGrid.create(JPHS(), 1.5, SLOT_SKIN, cell, SLOT_N),
            CellGridEngine.create(PseudoHS(), 1.5, SLOT_SKIN, cell, SLOT_N))


def _run_port(state, run_dir, steps, freq, **kw):
    _, tparams = _params(state.n_particles)
    return mdtpu_torch.run_simulation(state, tparams, mdtpu_torch.NVE(),
                                      steps, freq, run_dir, device="cpu",
                                      **kw)


def _run_jax(state, run_dir, steps, freq, **kw):
    jparams, _ = _params(state.positions.shape[0])
    return j_run_simulation(state, jparams, JNVE(), steps, freq, run_dir,
                            **kw)


def _crash_and_resume(run, load, template, run_dir, compress):
    """Run 40 steps (thermo and frames every 10, checkpoints every 20,
    perf log), keep the directory as the crash left it, and resume from
    ``checkpoint.20.npz`` into it for the remaining 19 steps. Returns the
    directory's files after the first run (name -> bytes)."""
    run(template, run_dir, 40, 10, checkpoint_every=20, compress=compress,
        perf_log=True)
    first = {f: open(os.path.join(run_dir, f), "rb").read()
             for f in os.listdir(run_dir)}
    mid = load(os.path.join(run_dir, "checkpoint.20.npz"), template)
    run(mid, run_dir, 19, 10, compress=compress, perf_log=True)
    return first


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's runs, each made once and lazily."""
    done = {}

    def run(case):
        if case in done:
            return done[case]
        out = str(tmp_path_factory.mktemp(f"jax_{case}"))
        jstate, _ = _states()
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MDTPU_FRAME_STACK", "0")  # one event a batch
            if case in ("crash", "crash_zst"):
                done[case] = (out, _crash_and_resume(
                    _run_jax, j_load_checkpoint, jstate, out,
                    case == "crash_zst"))
            elif case == "cadence":
                _run_jax(jstate, out, 40, 25, checkpoint_every=15)
                done[case] = out
            elif case == "log_times":
                mid = _run_jax(jstate, os.path.join(out, "a"), 40, 20)
                _run_jax(mid, os.path.join(out, "b"), 40, 20,
                         log_times=True)
                done[case] = out
            elif case == "slot":
                jstate, _ = _states(SLOT_N)
                _run_jax(jstate, out, 40, 20, checkpoint_every=20,
                         engine=_slot_engines()[0])
                done[case] = out
        return done[case]

    return run


def _labels(path):
    with open(path) as f:
        return [int(line.split()[0]) for line in f
                if line.strip() and not line.startswith("#")]


def _traj_labels(text):
    lines = text.splitlines()
    return [int(b) for a, b in zip(lines, lines[1:])
            if a.startswith("ITEM: TIMESTEP")]


def _varied_state(dtype, seed):
    """A port state with every field set to something of its own."""
    rng = np.random.default_rng(seed)
    _, tstate = _states()
    n = tstate.n_particles

    def t(shape=(n, 3)):
        return torch.tensor(rng.normal(size=shape), dtype=dtype)

    return tstate.replace(
        positions=t(), velocities=t(), forces=t(), pos_comp=t() * 1e-17,
        vel_comp=t() * 1e-17, diameters=t((n,)).abs(),
        unitcell=tstate.unitcell.to(dtype),
        unitcell_inv=tstate.unitcell_inv.to(dtype),
        images=torch.tensor(rng.integers(-5, 6, size=(n, 3))),
        energy=t(()), virial=t(()), temperature=t(()),
        virial_accum=t(()), nprom=torch.tensor(7), seed=seed, step=123,
        nf=189.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_round_trip_is_bit_exact(tmp_path, dtype):
    state = _varied_state(dtype, seed=5)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(state, path)
    template = _varied_state(dtype, seed=6)
    got = load_checkpoint(path, template)
    assert (got.seed, got.step, got.nf) == (5, 123, 189.0)
    for name in FIELDS + ("virial_accum", "nprom"):
        a, b = getattr(got, name), getattr(state, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got.nbrs is None and got.ids is None


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    jstate, tstate = _states()
    rng = np.random.default_rng(3)
    jstate = jstate.replace(
        images=jnp.asarray(rng.integers(-4, 5, size=(N, 3)), jnp.int32),
        pos_comp=jnp.asarray(rng.normal(size=(N, 3)) * 1e-17),
        energy=jnp.asarray(-12.5), step=jnp.asarray(37, jnp.int32))
    path = str(tmp_path / "jax.npz")
    j_save_checkpoint(jstate, path)
    got = load_checkpoint(path, tstate)
    assert got.seed == tstate.seed and got.step == 37
    assert got.nf == float(jstate.nf)
    assert got.images.dtype == torch.int64
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
        assert getattr(got, name).dtype == getattr(tstate, name).dtype


def test_port_checkpoint_loads_into_jax(tmp_path):
    jstate, _ = _states()
    state = _varied_state(torch.float64, seed=8)
    path = str(tmp_path / "port.npz")
    save_checkpoint(state, path)
    got = j_load_checkpoint(path, jstate)
    assert int(got.step) == 123 and float(got.nf) == 189.0
    np.testing.assert_array_equal(jax.random.key_data(got.key),
                                  jax.random.key_data(jstate.key))
    assert got.images.dtype == jstate.images.dtype
    for name in FIELDS + ("virial_accum", "nprom"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      getattr(state, name).numpy(),
                                      err_msg=name)


def test_continuation_from_a_jax_checkpoint_matches_jax(jax_runs, tmp_path):
    out, _ = jax_runs("crash")
    ck = os.path.join(out, "checkpoint.20.npz")
    jstate, tstate = _states()
    jend = _run_jax(j_load_checkpoint(ck, jstate), str(tmp_path / "j"), 20, 5)
    tend = _run_port(load_checkpoint(ck, tstate), str(tmp_path / "t"), 20, 5)
    assert tend.step == int(jend.step) == 41
    rows_t = np.loadtxt(tmp_path / "t" / "thermo.txt")
    rows_j = np.loadtxt(tmp_path / "j" / "thermo.txt")
    np.testing.assert_array_equal(rows_t[:, 0], [25, 30, 35, 40])
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tend.positions.numpy(),
                               np.asarray(jend.positions), rtol=1e-9,
                               atol=1e-12)


def test_checkpoint_every_off_the_output_cadence(jax_runs, tmp_path):
    _, tstate = _states()
    _run_port(tstate, str(tmp_path), 40, 25, checkpoint_every=15)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.listdir(jax_runs("cadence")))
    assert {f"checkpoint.{s}.npz" for s in (0, 15, 30)} <= set(names)


@pytest.mark.parametrize("route", ["particle", "slot"])
def test_checkpoint_label_holds_the_next_step(jax_runs, tmp_path, route):
    """The checkpoint of label 20 holds the state after loop iteration 20,
    at step 21, in particle order, on both routes, with the JAX package's
    fields (rel 1e-9)."""
    if route == "slot":
        out = jax_runs("slot")
        _, tstate = _states(SLOT_N)
        _run_port(tstate, str(tmp_path), 40, 20, checkpoint_every=20,
                  engine=_slot_engines()[1])
    else:
        out, _ = jax_runs("crash")
        _, tstate = _states()
        _run_port(tstate, str(tmp_path), 40, 10, checkpoint_every=20)
    got = load_checkpoint(str(tmp_path / "checkpoint.20.npz"), tstate)
    with np.load(os.path.join(out, "checkpoint.20.npz")) as ref:
        assert got.step == int(ref["step"]) == 21
        for name in ("positions", "velocities", "forces"):
            np.testing.assert_allclose(getattr(got, name).numpy(), ref[name],
                                       rtol=1e-9, atol=1e-10, err_msg=name)
        np.testing.assert_array_equal(got.images.numpy(), ref["images"])


def test_slot_route_resume_conserves_energy(tmp_path):
    _, tstate = _states(SLOT_N)
    engine = _slot_engines()[1]
    out = _run_port(tstate, str(tmp_path / "run"), 40, 20,
                    checkpoint_every=20, engine=engine)
    mid = load_checkpoint(str(tmp_path / "run" / "checkpoint.20.npz"),
                          tstate)
    assert mid.step == 21 and mid.positions.shape == (SLOT_N, 3)
    cont = _run_port(mid, str(tmp_path / "cont"), 19, 19, engine=engine)
    assert cont.step == 40

    def total(s):
        return float(s.energy) + 0.5 * float(torch.sum(s.velocities ** 2))

    assert abs(total(cont) - total(out)) / abs(total(out)) < 1e-6


def _read_traj(run_dir, compressed):
    path = os.path.join(run_dir, "trajectory.xyz")
    if not compressed:
        return open(path).read()
    tmp = path + ".copy.zst"
    shutil.copy(path + ".zst", tmp)
    text = open(tcompress.decompress_zstd(tmp, remove_original=True)).read()
    os.remove(tmp[:-len(".zst")])
    return text


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "zst"])
def test_crash_resume_into_the_same_directory(jax_runs, tmp_path, compress):
    jdir, jfirst = jax_runs("crash_zst" if compress else "crash")
    _, tstate = _states()
    tdir = str(tmp_path / "port")
    first = _crash_and_resume(_run_port, load_checkpoint, tstate, tdir,
                              compress)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert sorted(first) == sorted(jfirst)
    thermo_t, thermo_j = (os.path.join(d, "thermo.txt") for d in (tdir, jdir))
    assert _labels(thermo_t) == _labels(thermo_j) == [0, 10, 20, 30]
    np.testing.assert_allclose(np.loadtxt(thermo_t), np.loadtxt(thermo_j),
                               rtol=1e-9, atol=0)
    traj_t, traj_j = _read_traj(tdir, compress), _read_traj(jdir, compress)
    assert _traj_labels(traj_t) == _traj_labels(traj_j) == [0, 10, 20, 30]
    assert traj_t == traj_j
    # The first run's rows and frames, byte for byte: those below the
    # checkpoint's step were kept, the rest written again exactly.
    assert open(thermo_t, "rb").read() == first["thermo.txt"]
    if compress:
        traj_first = os.path.join(str(tmp_path), "first.xyz.zst")
        open(traj_first, "wb").write(first["trajectory.xyz.zst"])
        first_text = open(tcompress.decompress_zstd(traj_first)).read()
        assert traj_t == first_text
        plain_dir = str(tmp_path / "plain")
        _run_port(tstate, plain_dir, 40, 10)
        assert traj_t == open(os.path.join(plain_dir,
                                           "trajectory.xyz")).read()
    else:
        assert traj_t.encode() == first["trajectory.xyz"]
    # perf.txt: the JAX package's header, one row more per segment.
    perf_t = open(os.path.join(tdir, "perf.txt")).read().splitlines()
    perf_j = open(os.path.join(jdir, "perf.txt")).read().splitlines()
    assert perf_t[0] == perf_j[0] == "# Step StepsPerSec"
    assert len(perf_t) == len(perf_j) == 1 + 5 + 2
    assert [r.split()[0] for r in perf_t[1:]] == \
        [r.split()[0] for r in perf_j[1:]]


def test_log_times_resume_does_not_rewind(jax_runs, tmp_path):
    jout = jax_runs("log_times")
    _, tstate = _states()
    mid = _run_port(tstate, str(tmp_path / "a"), 40, 20)
    end = _run_port(mid, str(tmp_path / "b"), 40, 20, log_times=True)
    assert end.step == 80
    assert _labels(str(tmp_path / "b" / "thermo.txt")) == [40, 60]

    def snaps(d):
        return sorted(f for f in os.listdir(d) if f.startswith("snapshot."))

    got = snaps(str(tmp_path / "b"))
    assert got and got == snaps(os.path.join(jout, "b"))
    assert all(40 <= int(f.split(".")[1]) < 80 for f in got)


def test_compressed_jax_trajectory_decompresses_alike(jax_runs, tmp_path):
    """The port's libzstd reads the JAX package's stream (written through
    its own writer, appended on resume) to the same text as the JAX
    package's own decompressor."""
    jdir, _ = jax_runs("crash_zst")
    src = os.path.join(jdir, "trajectory.xyz.zst")
    a, b = str(tmp_path / "a.zst"), str(tmp_path / "b.zst")
    shutil.copy(src, a)
    shutil.copy(src, b)
    assert open(tcompress.decompress_zstd(a)).read() == \
        open(j_decompress_zstd(b)).read()


def test_compress_without_libzstd_raises_before_any_file(tmp_path,
                                                         monkeypatch):
    _, tstate = _states()
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    tcompress._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="libzstd"):
            _run_port(tstate, str(tmp_path / "run"), 10, 5, compress=True)
        assert not (tmp_path / "run").exists()
    finally:
        monkeypatch.undo()
        tcompress._library.cache_clear()
    # With the library back, the same call writes the compressed file only.
    _run_port(tstate, str(tmp_path / "run"), 10, 5, compress=True)
    names = os.listdir(tmp_path / "run")
    assert "trajectory.xyz.zst" in names and "trajectory.xyz" not in names


def test_trace_writes_a_chrome_trace(tmp_path):
    """``utils.profiling.trace`` (the port's ``jax.profiler`` trace) records
    a short run and writes ``trace.json``."""
    import json

    from mdtpu_torch.utils.profiling import trace

    _, tstate = _states()
    with trace(str(tmp_path / "trace")) as prof:
        _run_port(tstate, str(tmp_path / "run"), 2, 1)
    assert prof.key_averages()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
