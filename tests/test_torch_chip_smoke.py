"""``chip_smoke.py`` refuses to run where it cannot check the port: without
a card (exit 2) and, copied alone into a directory without the package
beside it, with a card reported (exit 1, the reason on stderr). Neither
prints a result line. The script runs in a subprocess from a directory
that holds only a copy of it (the card is faked by patching
``torch.cuda.is_available`` in that process)."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_alone(tmp_path, card):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    code = ("import runpy, sys, torch\n"
            f"torch.cuda.is_available = lambda: {card}\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("card", [False, True], ids=["no_card", "card"])
def test_chip_smoke_alone_refuses_without_printing_a_result(tmp_path, card):
    proc = run_alone(tmp_path, card)
    assert proc.returncode == (1 if card else 2), proc.stderr
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    if card:
        assert "mdtpu_torch is not beside this script" in proc.stderr
    else:
        assert "no CUDA device" in proc.stderr
