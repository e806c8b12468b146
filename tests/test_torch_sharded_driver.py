"""The sharded driver and FIRE on the CPU: ``run_simulation_sharded`` and
``fire_minimize_sharded`` on a 2-rank gloo group of spawned processes
against the JAX package's on a 2-device CPU mesh (run with
``MDTPU_FRAME_STACK=0``, its C1 workaround), at f64, with the same explicit
geometry:

  * 40 NVE steps of N = 1,200 Lennard-Jones (rho 0.4, r_c 1.5; one particle
    aimed across the slab boundary) with thermo rows and frames every 10
    steps and a checkpoint every 20: thermo rows to rel 1e-9 and frames (in
    the same ids order) to 1e-9, one flip of the last printed digit
    allowed; final positions to 1e-9; ``checkpoint.20.npz``, and a crash
    resume from it into the same directory, whose files match JAX's
    resumed files as closely; rank 1 writes no file;
  * a migration buffer of one column through the driver: it warns,
    restores, grows and ends with the rows of a run that never overflowed;
  * ``fire_minimize_sharded`` at 12 and 50 iterations on a dense LJ lattice
    (N = 1,200, rho 0.8, r_c 2.5): energy rel 1e-9, the caller's
    velocities returned unchanged;
  * sharded Brownian dynamics of free particles held statistically (MSD
    against 2 d D t, as JAX ``test_sharded_brownian_msd_matches_diffusion``),
    each rank's draws those of the ``brownian_noise`` seam for ``(seed,
    step, rank)``, and the two ranks' draws different;
  * a user potential (``examples/03_polydisperse_2d.py``'s, through the
    pair list's slab launch) on ``tests/test_torch_halo_slot.py``'s 2D
    polydisperse system: 40 NVE steps through ``run_simulation_sharded``
    (rows and frames as above, final positions to 1e-9) and
    ``fire_minimize_sharded`` at 12 iterations (energy rel 1e-9) against
    JAX's, also from a list of one entry (FIRE grows and restarts); a list
    of one entry through the driver: it warns, grows (the list 1.4 times
    plus 1024 a grow) and ends with the rows of a run at the list's own
    size;
  * the ring of one: the driver runs and FIRE in this process, against the
    same JAX runs.

The spawning and the children's bounds are
``tests/test_torch_halo_slot.py``'s; the children import no JAX."""

import os
import re
import warnings

import numpy as np
import pytest
import torch

import mdtpu_torch as mt
from mdtpu_torch.integrate import step as tstep
from mdtpu_torch.io.checkpoint import load_checkpoint
from mdtpu_torch.minimize import fire_minimize_sharded
from mdtpu_torch.parallel import HaloSlotEngine, ShardRing
from mdtpu_torch.parallel.geometry import sharded_geometry
from mdtpu_torch.sim.initialization import build_state_from_arrays
from tests.test_torch_halo_slot import (CUTOFF, DT, KEY_SEED, MIGRATION, N,
                                        RHO, USER_CUTOFF, USER_DT, USER_RHO,
                                        WORLD, fluid_arrays, port_engine,
                                        port_state, spawn_ranks, user_arrays,
                                        user_engine, user_port_state)

STEPS, FREQ, CHECKPOINT = 40, 10, 20
USER_FIRE_ITERS = 12
RESUME_STEPS = 19
FIRE_ITERS = (12, 50)
FIRE_RHO, FIRE_CUTOFF = 0.8, 2.5
BD_N, BD_L, BD_DT, BD_STEPS = 1200, 16.0, 0.02, 40
RECOVER_STEPS = 20
_NUMBER = re.compile(r"^-?\d+(\.\d*)?([eE][-+]?\d+)?$")


# ------------------------------------------------------------- systems


def fire_arrays(seed=5):
    """bench_fire.py's system at N = 1,200: an LJ lattice at rho 0.8,
    jittered by 0.05."""
    rng = np.random.default_rng(seed)
    L = (N / FIRE_RHO) ** (1 / 3)
    per = int(np.ceil(N ** (1 / 3)))
    frac = (np.indices((per,) * 3).reshape(3, -1).T[:N] + 0.5) / per
    pos = frac * L + 0.05 * rng.normal(size=(N, 3))
    vel = rng.normal(size=(N, 3))
    return pos, vel, np.eye(3) * L


def fire_geometry(cell):
    return sharded_geometry(FIRE_CUTOFF, cell, N, WORLD)


def rank_dir(workdir, name, rank):
    """Rank 0 writes into ``name``; the other ranks get a directory of their
    own, which must stay absent (they write nothing)."""
    return os.path.join(workdir, name if rank == 0 else f"{name}_rank{rank}")


# ------------------------------------------- what every rank runs (no JAX)


def driver_case(ring, workdir):
    """40 NVE steps through ``run_simulation_sharded`` with checkpoints,
    then a crash resume from ``checkpoint.20.npz`` into the same
    directory."""
    pos, vel, cell = fluid_arrays()
    eng = port_engine(ring, cell)
    params = mt.Parameters(RHO, N, DT, eng.potential)
    out = rank_dir(workdir, "sh", ring.rank)
    final = mt.run_simulation_sharded(
        port_state(pos, vel, cell), params, mt.NVE(), STEPS, FREQ, out,
        engine=eng, checkpoint_every=CHECKPOINT)
    start = load_checkpoint(
        os.path.join(workdir, "sh", f"checkpoint.{CHECKPOINT}.npz"),
        port_state(pos, vel, cell))
    resumed = mt.run_simulation_sharded(start, params, mt.NVE(),
                                        RESUME_STEPS, FREQ, out, engine=eng)
    return {"positions": final.positions.numpy(), "step": final.step,
            "ids": final.ids, "energy": float(final.energy),
            "resumed_positions": resumed.positions.numpy(),
            "resumed_step": resumed.step}


def recover_case(ring, workdir):
    """The driver with a one-column migration buffer, and without."""
    pos, vel, cell = fluid_arrays()
    params = mt.Parameters(RHO, N, DT, port_engine(ring, cell).potential)
    caught = []
    for name, migration in (("tight", 1), ("roomy", MIGRATION)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mt.run_simulation_sharded(
                port_state(pos, vel, cell), params, mt.NVE(), RECOVER_STEPS,
                FREQ, rank_dir(workdir, name, ring.rank),
                engine=port_engine(ring, cell, migration=migration))
        caught.append([str(x.message) for x in w
                       if "capacity overflow" in str(x.message)])
    return {"warnings": caught}


def fire_case(ring, iterations):
    """``fire_minimize_sharded`` for each count of iterations (tol 0)."""
    pos, vel, cell = fire_arrays()
    grid, cap, skin = fire_geometry(cell)
    pot = mt.LennardJones(r_cut=FIRE_CUTOFF)
    eng = HaloSlotEngine(potential=pot, cutoff=FIRE_CUTOFF, skin=skin,
                         grid=grid, cell_capacity=cap,
                         migration_capacity=MIGRATION, ring=ring)
    st = build_state_from_arrays(pos, np.ones(N), cell, velocities=vel,
                                 dtype=torch.float64, cutoff=FIRE_CUTOFF,
                                 device="cpu")
    params = mt.Parameters(FIRE_RHO, N, DT, pot)
    out = {}
    for its in iterations:
        end, energy, converged, n_steps = fire_minimize_sharded(
            st, params, eng, max_steps=its, tol=0.0)
        out[its] = {"energy": float(energy), "n_steps": n_steps,
                    "converged": converged,
                    "velocities_kept": bool(torch.equal(end.velocities,
                                                        st.velocities)),
                    "positions": end.positions.numpy()}
    return out


def brownian_case(ring, workdir):
    """Free Brownian particles (epsilon 0) through the sharded driver; the
    noise seam's calls recorded."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, BD_L, size=(BD_N, 3))
    cell = np.eye(3) * BD_L
    st = build_state_from_arrays(pos, np.ones(BD_N), cell, seed=4,
                                 dtype=torch.float64, cutoff=CUTOFF,
                                 device="cpu")
    pot = mt.LennardJones(epsilon=0.0, r_cut=CUTOFF)
    params = mt.Parameters(BD_N / BD_L ** 3, BD_N, BD_DT, pot)
    # Free diffusion gives Poisson occupancy (mean 2.3 a cell): room for
    # its spikes.
    eng = HaloSlotEngine.create(pot, CUTOFF, cell, BD_N, ring,
                                cell_capacity=12)
    calls = []
    seam = tstep.brownian_noise

    def recorded(seed, step, shape, dtype, device, *rank):
        xi = seam(seed, step, shape, dtype, device, *rank)
        calls.append((seed, step, tuple(shape), rank, xi if not calls
                      else None))
        return xi

    tstep.brownian_noise = recorded
    try:
        out = mt.run_simulation_sharded(
            st, params, mt.Brownian(1.0), BD_STEPS, BD_STEPS,
            rank_dir(workdir, "bd", ring.rank), engine=eng)
    finally:
        tstep.brownian_noise = seam
    seed, step, shape, rank, first = calls[0]
    return {"positions": out.positions.numpy(), "images": out.images.numpy(),
            "start": pos, "ranks_passed": {c[3] for c in calls},
            "n_calls": len(calls), "first_draws": first.numpy(),
            "seam_again": tstep.brownian_noise(seed, step, shape,
                                               torch.float64, "cpu",
                                               ring.rank).numpy()}


def user_driver_case(ring, workdir):
    """40 NVE steps of the 2D user system through
    ``run_simulation_sharded`` (the pair list's slab launch)."""
    pos, vel, diam, cell = user_arrays()
    eng = user_engine(ring, cell)
    params = mt.Parameters(USER_RHO[2], N, USER_DT, eng.potential)
    final = mt.run_simulation_sharded(
        user_port_state(pos, vel, diam, cell), params, mt.NVE(), STEPS, FREQ,
        rank_dir(workdir, "user", ring.rank), engine=eng)
    return {"positions": final.positions.numpy(),
            "energy": float(final.energy)}


def user_recover_case(ring, workdir):
    """The 2D user system through the driver with a list of one entry, and
    with the list's own size."""
    pos, vel, diam, cell = user_arrays()
    caught = []
    for name, pair_capacity in (("user_tight", 1), ("user_roomy", None)):
        eng = user_engine(ring, cell, pair_capacity=pair_capacity)
        params = mt.Parameters(USER_RHO[2], N, USER_DT, eng.potential)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mt.run_simulation_sharded(
                user_port_state(pos, vel, diam, cell), params, mt.NVE(),
                RECOVER_STEPS, FREQ, rank_dir(workdir, name, ring.rank),
                engine=eng)
        caught.append([str(x.message) for x in w
                       if "capacity overflow" in str(x.message)])
    return {"warnings": caught}


def user_fire_case(ring):
    """``fire_minimize_sharded`` on the 2D user system (tol 0), with the
    list's own size and with a list of one entry (FIRE restarts on a grown
    engine until the list fits)."""
    pos, vel, diam, cell = user_arrays()
    st = user_port_state(pos, vel, diam, cell)
    out = {}
    for name, pair_capacity in (("", None), ("tight_", 1)):
        eng = user_engine(ring, cell, pair_capacity=pair_capacity)
        params = mt.Parameters(USER_RHO[2], N, USER_DT, eng.potential)
        end, energy, converged, n_steps = fire_minimize_sharded(
            st, params, eng, max_steps=USER_FIRE_ITERS, tol=0.0)
        out.update({f"{name}energy": float(energy),
                    f"{name}n_steps": n_steps,
                    f"{name}converged": converged,
                    f"{name}velocities_kept": bool(torch.equal(
                        end.velocities, st.velocities))})
    return out


def run_cases(ring, workdir):
    return {"driver": driver_case(ring, workdir),
            "recover": recover_case(ring, workdir),
            "fire": fire_case(ring, FIRE_ITERS),
            "brownian": brownian_case(ring, workdir),
            "user_driver": user_driver_case(ring, workdir),
            "user_recover": user_recover_case(ring, workdir),
            "user_fire": user_fire_case(ring)}


# ------------------------------------------------------ the parent's side


def jax_runs(workdir):
    """JAX's sharded driver (with its resume) and sharded FIRE on a 2-device
    mesh."""
    import jax
    from mdtpu.core.types import NVE as JNVE
    from mdtpu.core.types import Parameters as JParameters
    from mdtpu.io.checkpoint import load_checkpoint as jload
    from mdtpu.minimize.fire import fire_minimize_sharded as jfire
    from mdtpu.parallel.driver import run_simulation_sharded as jrun
    from mdtpu.parallel.halo_slot import HaloSlotEngine as JHalo
    from mdtpu.parallel.mesh import make_mesh
    from mdtpu.potentials.lennard_jones import LennardJones as JLJ
    from mdtpu.sim.initialization import build_state_from_arrays as jbuild
    from tests.test_torch_halo_slot import jax_engine, jax_state

    mesh = make_mesh(WORLD)
    pos, vel, cell = fluid_arrays()
    eng = jax_engine(cell)
    params = JParameters(density=RHO, n_particles=N, dt=DT,
                         potential=eng.potential)
    out_dir = os.path.join(workdir, "jax")
    final = jrun(jax_state(pos, vel, cell), params, JNVE(), STEPS, FREQ,
                 out_dir, mesh=mesh, engine=eng, checkpoint_every=CHECKPOINT)
    start = jload(os.path.join(out_dir, f"checkpoint.{CHECKPOINT}.npz"),
                  jax_state(pos, vel, cell))
    resumed = jrun(start, params, JNVE(), RESUME_STEPS, FREQ, out_dir,
                   mesh=mesh, engine=eng)
    res = {"dir": out_dir, "positions": np.asarray(final.positions),
           "energy": float(final.energy),
           "resumed_positions": np.asarray(resumed.positions)}

    fpos, fvel, fcell = fire_arrays()
    grid, cap, skin = fire_geometry(fcell)
    feng = JHalo(potential=JLJ(r_cut=FIRE_CUTOFF), cutoff=FIRE_CUTOFF,
                 skin=skin, grid=grid, cell_capacity=cap, n_shards=WORLD,
                 migration_capacity=MIGRATION)
    fst = jbuild(fpos, np.ones(N), fcell, jax.random.PRNGKey(KEY_SEED),
                 velocities=fvel, dtype=jax.numpy.float64, cutoff=FIRE_CUTOFF)
    fparams = JParameters(density=FIRE_RHO, n_particles=N, dt=DT,
                          potential=feng.potential)
    res["fire"] = {}
    for its in FIRE_ITERS:
        end, energy, _, n_steps = jfire(fst, fparams, feng, mesh,
                                        max_steps=its, tol=0.0)
        res["fire"][its] = {"energy": float(energy), "n_steps": n_steps}

    # The user potential: the driver and FIRE.
    from tests.test_torch_halo_slot import jax_user_engine
    upos, uvel, udiam, ucell = user_arrays()
    ueng = jax_user_engine(ucell)
    uparams = JParameters(density=USER_RHO[2], n_particles=N, dt=USER_DT,
                          potential=ueng.potential)
    ustate = jax_state(upos, uvel, ucell, diam=udiam, cutoff=USER_CUTOFF[2])
    user_dir = os.path.join(workdir, "jax_user")
    ufinal = jrun(ustate, uparams, JNVE(), STEPS, FREQ, user_dir, mesh=mesh,
                  engine=ueng)
    _, uenergy, _, un = jfire(ustate, uparams, ueng, mesh,
                              max_steps=USER_FIRE_ITERS, tol=0.0)
    res["user"] = {"dir": user_dir, "positions": np.asarray(ufinal.positions),
                   "energy": float(ufinal.energy),
                   "fire_energy": float(uenergy), "fire_steps": un}
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("sharded"))
    wait = spawn_ranks(os.path.join(workdir, "ranks"),
                       ("tests.test_torch_sharded_driver", "run_cases"),
                       (os.path.join(workdir, "out"),))
    torch.set_num_threads(1)
    try:
        mp = pytest.MonkeyPatch()
        mp.setenv("MDTPU_FRAME_STACK", "0")
        try:
            jax_out = jax_runs(workdir)
        finally:
            mp.undo()
        one_dir = os.path.join(workdir, "one")
        ring = ShardRing(device="cpu")
        one = {"driver": driver_case(ring, one_dir),
               "fire": fire_case(ring, FIRE_ITERS[:1]),
               "user_driver": user_driver_case(ring, one_dir),
               "user_fire": user_fire_case(ring)}
    finally:
        ranks = wait()
    return {"ranks": ranks, "one": one, "jax": jax_out,
            "dirs": {"two_ranks": os.path.join(workdir, "out"),
                     "one_rank": one_dir}}


def _tokens(path):
    with open(path) as f:
        return [line.split() for line in f]


def _close_printed(a, b):
    """Numbers printed to 6 decimals: within rel 1e-9, or one flip of the
    last printed digit."""
    return abs(a - b) <= max(1e-9 * abs(b), 1.000001e-6)


def _assert_same_files(path_a, path_b):
    a, b = _tokens(path_a), _tokens(path_b)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for ta, tb in zip(ra, rb):
            if _NUMBER.match(ta) and _NUMBER.match(tb):
                assert _close_printed(float(ta), float(tb)), (ta, tb)
            else:
                assert ta == tb


RINGS = ("two_ranks", "one_rank")


def _ring_out(runs, ring):
    return runs["ranks"][0] if ring == "two_ranks" else runs["one"]


@pytest.mark.parametrize("ring", RINGS)
def test_run_simulation_sharded_matches_jax(runs, ring):
    got = _ring_out(runs, ring)["driver"]
    jax_out = runs["jax"]
    assert got["step"] == STEPS and got["ids"] is None
    np.testing.assert_allclose(got["positions"], jax_out["positions"],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got["energy"], jax_out["energy"], rtol=1e-10)
    assert got["resumed_step"] == STEPS
    np.testing.assert_allclose(got["resumed_positions"],
                               jax_out["resumed_positions"], rtol=0,
                               atol=1e-9)
    out = os.path.join(runs["dirs"][ring], "sh")
    # The files after the crash resume (rows and frames below step 21 kept,
    # the rest rewritten), against JAX's after its own resume.
    for name in ("thermo.txt", "trajectory.xyz", "final.xyz"):
        _assert_same_files(os.path.join(out, name),
                           os.path.join(jax_out["dir"], name))
    rows = np.loadtxt(os.path.join(out, "thermo.txt"))
    assert rows[:, 0].tolist() == list(range(0, STEPS, FREQ))
    assert os.path.isfile(os.path.join(out, f"checkpoint.{CHECKPOINT}.npz"))


def test_every_rank_returns_the_state_and_only_rank_0_writes(runs):
    a, b = (r["driver"] for r in runs["ranks"])
    np.testing.assert_array_equal(a["positions"], b["positions"])
    np.testing.assert_array_equal(a["resumed_positions"],
                                  b["resumed_positions"])
    out = runs["dirs"]["two_ranks"]
    for name in ("sh", "tight", "roomy", "bd"):
        assert os.path.isdir(os.path.join(out, name))
        assert not os.path.exists(os.path.join(out, f"{name}_rank1"))


def test_migration_overflow_recovers_in_the_driver(runs):
    for rank in runs["ranks"]:
        tight, roomy = rank["recover"]["warnings"]
        assert tight and not roomy
    out = runs["dirs"]["two_ranks"]
    for name in ("thermo.txt", "trajectory.xyz", "final.xyz"):
        _assert_same_files(os.path.join(out, "tight", name),
                           os.path.join(out, "roomy", name))


@pytest.mark.parametrize("ring", RINGS)
def test_fire_minimize_sharded_matches_jax(runs, ring):
    got = _ring_out(runs, ring)["fire"]
    for its, rec in got.items():
        ref = runs["jax"]["fire"][its]
        assert rec["n_steps"] == ref["n_steps"] == its
        np.testing.assert_allclose(rec["energy"], ref["energy"], rtol=1e-9)
        assert rec["velocities_kept"] and not rec["converged"]


def test_sharded_brownian_diffuses_with_per_rank_draws(runs):
    a, b = (r["brownian"] for r in runs["ranks"])
    np.testing.assert_array_equal(a["positions"], b["positions"])
    end = a["positions"] + a["images"] * BD_L
    msd = np.mean(np.sum((end - a["start"]) ** 2, axis=1))
    expected = 2 * 3 * BD_DT * BD_STEPS
    assert abs(msd - expected) / expected < 0.07
    # Walkers cross between the two slabs.
    slab0 = (a["start"][:, 0] >= BD_L / 2)
    slab1 = (a["positions"][:, 0] >= BD_L / 2)
    assert int((slab0 != slab1).sum()) > BD_N // 20
    for rank, rec in enumerate((a, b)):
        assert rec["ranks_passed"] == {(rank,)}
        assert rec["n_calls"] == BD_STEPS
        np.testing.assert_array_equal(rec["first_draws"], rec["seam_again"])
    assert not np.array_equal(a["first_draws"], b["first_draws"])


@pytest.mark.parametrize("ring", RINGS)
def test_user_run_simulation_sharded_matches_jax(runs, ring):
    got = _ring_out(runs, ring)["user_driver"]
    ref = runs["jax"]["user"]
    np.testing.assert_allclose(got["positions"], ref["positions"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["energy"], ref["energy"], rtol=1e-10)
    out = os.path.join(runs["dirs"][ring], "user")
    for name in ("thermo.txt", "trajectory.xyz", "final.xyz"):
        _assert_same_files(os.path.join(out, name),
                           os.path.join(ref["dir"], name))
    rows = np.loadtxt(os.path.join(out, "thermo.txt"))
    assert rows[:, 0].tolist() == list(range(0, STEPS, FREQ))


@pytest.mark.parametrize("ring", RINGS)
def test_user_fire_minimize_sharded_matches_jax(runs, ring):
    got = _ring_out(runs, ring)["user_fire"]
    ref = runs["jax"]["user"]
    # A list of one entry: FIRE grows the engine and restarts, and ends
    # where the run at the list's own size ends.
    for name in ("", "tight_"):
        assert got[f"{name}n_steps"] == ref["fire_steps"] == USER_FIRE_ITERS
        np.testing.assert_allclose(got[f"{name}energy"], ref["fire_energy"],
                                   rtol=1e-9)
        assert got[f"{name}velocities_kept"]
        assert not got[f"{name}converged"]


def test_pair_list_overflow_recovers_in_the_driver(runs):
    for rank in runs["ranks"]:
        tight, roomy = rank["user_recover"]["warnings"]
        assert tight and not roomy
    out = runs["dirs"]["two_ranks"]
    for name in ("thermo.txt", "trajectory.xyz", "final.xyz"):
        _assert_same_files(os.path.join(out, "user_tight", name),
                           os.path.join(out, "user_roomy", name))
