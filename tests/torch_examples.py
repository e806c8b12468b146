"""The port's examples (``examples_torch/``) loaded by path, for the tests
(example 03's user potential is the one definition the port's tests use),
and the rank side of ``tests/test_torch_examples.py``'s sharded example:
each spawned rank of a gloo group runs example 05's ``main`` on the CPU.
Imports no JAX (the spawned ranks import this module)."""

import importlib.util
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples_torch")


def load_example(name):
    """``examples_torch/{name}.py`` as a module (registered in
    ``sys.modules`` under ``examples_torch_{name}``)."""
    key = f"examples_torch_{name}"
    spec = importlib.util.spec_from_file_location(
        key, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def sharded_example(ring, out, n_particles, steps):
    """Example 05's ``main`` over the spawned group (``ring`` is the
    group's ring, which ``main`` forms again from the default group)."""
    final = load_example("05_sharded_multichip").main(
        n_particles=n_particles, steps=steps, out=out, device="cpu")
    return {"world": ring.size, "step": final.step,
            "temperature": float(final.temperature),
            "positions": final.positions.numpy()}
