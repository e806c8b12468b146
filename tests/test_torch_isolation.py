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
            "mdtpu_torch.ops.cell_grid\n"
            "print('\\n'.join(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert "mdtpu_torch" in out
    assert [m for m in out if _forbidden(m)] == []


def test_no_source_file_imports_jax_or_mdtpu():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
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
    # device="cpu" runs, and the not-yet-ported options raise by name.
    out = mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                     str(tmp_path / "cpu"), device="cpu")
    assert out.step == 2 and out.positions.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="A7"):
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.NVE(), 2, 1,
                                   str(tmp_path / "x"), precision="f32x2",
                                   device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        mdtpu_torch.run_simulation(state, params, mdtpu_torch.Brownian(1.0),
                                   2, 1, str(tmp_path / "x"), device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        mdtpu_torch.initialize_state(params, str(tmp_path), device="cpu")


def test_exports_are_a_subset_of_mdtpu():
    import mdtpu

    assert set(mdtpu_torch.__all__) <= set(mdtpu.__all__)
    for name in mdtpu_torch.__all__:
        assert hasattr(mdtpu_torch, name)
