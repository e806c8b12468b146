"""The port stands alone: importing it loads neither JAX nor any module of
the JAX package, no source file of it imports them, and its entry points
run on the card by default and raise without one."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mdtpu_torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "mdtpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mdtpu")


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


def test_import_loads_no_jax_or_mdtpu():
    code = ("import sys, mdtpu_torch, mdtpu_torch.interop, "
            "mdtpu_torch.ops.cell_grid, mdtpu_torch.ops.cell_pairs, "
            "mdtpu_torch.ops.neighbor_list, mdtpu_torch.io.native_writer, "
            "mdtpu_torch.ops.plane_sweep, mdtpu_torch.ops.rdf, "
            "mdtpu_torch.observables, mdtpu_torch.io.checkpoint, "
            "mdtpu_torch.io.compress, mdtpu_torch.utils.profiling, "
            "mdtpu_torch.ops.experimental, "
            "mdtpu_torch.ops.experimental.probe, mdtpu_torch.parallel, "
            "mdtpu_torch.parallel.halo_slot, mdtpu_torch.parallel.mesh, "
            "mdtpu_torch.parallel.driver, mdtpu_torch.parallel.geometry\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "mdtpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


def test_no_source_file_imports_jax_or_mdtpu():
    files = sorted(PKG.rglob("*.py")) + [
        REPO / name for name in ("chip_smoke.py", "compare_torch_host.py",
                                 "compare_torch_sweep.py",
                                 "profile_torch_step.py",
                                 "validate_torch.py",
                                 "tests/torch_examples.py")] + sorted(
        (REPO / "examples_torch").glob("*.py"))
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_examples_and_spawned_ranks_load_no_jax_or_mdtpu():
    """Loading each of ``examples_torch/`` and importing what a spawned
    rank of the CPU tests imports (``tests.test_torch_halo_slot`` and the
    examples' rank target) loads neither JAX nor the JAX package."""
    code = ("import sys, tests.test_torch_halo_slot\n"
            "from tests.torch_examples import EXAMPLES, load_example\n"
            "import os\n"
            "names = sorted(f[:-3] for f in os.listdir(EXAMPLES)"
            " if f.endswith('.py'))\n"
            "assert len(names) == 5, names\n"
            "[load_example(n) for n in names]\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "examples_torch_03_polydisperse_2d" in out
    assert [m for m in out if _forbidden(m)] == []


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = mdtpu_torch.sim.initialization.lattice_fluid_state(
        64, 0.5, 1.0, dtype=torch.float64, device="cpu")
    params = mdtpu_torch.Parameters(0.5, 64, 0.001, mdtpu_torch.PseudoHS())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                   str(tmp_path))
    assert not (tmp_path / "thermo.txt").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdtpu_torch.initialize_velocities(1.0, 0, 8, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdtpu_torch.initialize_state(params, str(tmp_path),
                                     positions=np.zeros((4, 3)))
    # device="cpu" runs (Brownian too, and compress), options that cannot
    # run raise before any file is written, and prefer="neighbor" gives the
    # neighbour-list engine where the box fits its grid.
    out = mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                     str(tmp_path / "cpu"), device="cpu")
    assert out.step == 2 and out.positions.device.type == "cpu"
    out = mdtpu_torch.run_simulation(state, params, mdtpu_torch.Brownian(1.0),
                                     2, 1, str(tmp_path / "bd"), device="cpu")
    assert out.step == 2 and float(out.temperature) == 1.0
    with pytest.raises(ValueError, match="f32x2"):
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                   str(tmp_path / "x"), precision="f32x2",
                                   device="cpu")
    assert not (tmp_path / "x").exists()
    engine = mdtpu_torch.select_engine(params.potential, 1.5,
                                       unitcell=np.eye(3) * 8.0,
                                       n_particles=256, prefer="neighbor")
    assert isinstance(engine, mdtpu_torch.NeighborListEngine)
    assert engine.grid == (4, 4, 4)
    mdtpu_torch.run_simulation(state, params, mdtpu_torch.Brownian(1.0), 2, 1,
                               str(tmp_path / "zst"), compress=True,
                               device="cpu")
    assert (tmp_path / "zst" / "trajectory.xyz.zst").is_file()
    assert not (tmp_path / "zst" / "trajectory.xyz").exists()
    # Packing (initialize_state without positions) and the minimizers run
    # on the card by default too.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdtpu_torch.initialize_state(params, str(tmp_path / "pack"))
    assert not (tmp_path / "pack").exists()
    for fn in (mdtpu_torch.fire_minimize, mdtpu_torch.minimize):
        args = (state, params, str(tmp_path / "min")) \
            if fn is mdtpu_torch.minimize else (state, params, None)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)


def test_exports_are_a_subset_of_mdtpu():
    import mdtpu

    assert set(mdtpu_torch.__all__) <= set(mdtpu.__all__)
    for name in mdtpu_torch.__all__:
        assert hasattr(mdtpu_torch, name)


def test_sharded_entry_points_default_to_cuda_and_raise_without_it(
        tmp_path, monkeypatch):
    """``run_simulation_sharded`` and ``fire_minimize_sharded`` (and the
    ring they build) take the card by default and raise without one, before
    any file is written; the sharded surface is the JAX package's."""
    import importlib

    import mdtpu
    import mdtpu.parallel
    from mdtpu_torch.minimize import fire_minimize_sharded
    from mdtpu_torch.parallel import HaloSlotEngine, ShardRing

    assert "run_simulation_sharded" in mdtpu.__all__
    assert "run_simulation_sharded" in mdtpu_torch.__all__
    assert {"run_simulation_sharded", "HaloSlotEngine"} <= (
        set(mdtpu_torch.parallel.__all__) & set(mdtpu.parallel.__all__))
    # (mdtpu.minimize is also the name of a function of the package.)
    for pkg in ("mdtpu.minimize", "mdtpu_torch.minimize"):
        assert hasattr(importlib.import_module(pkg), "fire_minimize_sharded")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = mdtpu_torch.sim.initialization.lattice_fluid_state(
        1200, 0.4, 1.0, dtype=torch.float64, cutoff=1.5, device="cpu")
    params = mdtpu_torch.Parameters(0.4, 1200, 0.002,
                                    mdtpu_torch.LennardJones(r_cut=1.5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdtpu_torch.run_simulation_sharded(state, params, mdtpu_torch.NVE(),
                                           2, 1, str(tmp_path / "sh"))
    assert not (tmp_path / "sh").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fire_minimize_sharded(state, params, max_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardRing()
    out = mdtpu_torch.run_simulation_sharded(
        state, params, mdtpu_torch.NVE(), 2, 1, str(tmp_path / "cpu"),
        device="cpu")
    assert out.step == 2 and out.positions.device.type == "cpu"
    with pytest.raises(TypeError, match="HaloSlotEngine"):
        mdtpu_torch.run_simulation_sharded(
            state, params, mdtpu_torch.NVE(), 2, 1, str(tmp_path / "x"),
            engine=mdtpu_torch.select_engine(params.potential, 1.5, state),
            device="cpu")
    assert isinstance(HaloSlotEngine.create(
        params.potential, 1.5, state.unitcell, 1200,
        ShardRing(device="cpu")), HaloSlotEngine)
