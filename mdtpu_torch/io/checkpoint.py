"""Full-state checkpoints: positions, velocities, images, forces, the step
counter, the random seed, the compensation buffers and the Brownian
accumulators, so a run continues exactly where it stopped.

Counterpart of ``mdtpu/io/checkpoint.py``. The npz keeps the JAX package's
field names, except that the JAX package's PRNG ``key`` is this package's
integer ``seed`` (:class:`mdtpu_torch.core.types.SimulationState`). Each
package reads only the names it knows, so a checkpoint crosses either way:
a JAX checkpoint loads here with the template's ``seed``, and one written
here loads into ``mdtpu.io.checkpoint.load_checkpoint`` with the
template's key. A checkpoint holds a particle-order state.
"""

from __future__ import annotations

import numpy as np
import torch

_ARRAY_FIELDS = [
    "positions", "velocities", "forces", "images", "diameters",
    "unitcell", "unitcell_inv", "seed", "step", "nf",
    "energy", "virial", "temperature", "pos_comp", "vel_comp",
    "virial_accum", "nprom",
]
_SCALARS = {"seed": int, "step": int, "nf": float}


def save_checkpoint(state, filepath):
    """Write the particle-order ``state`` to ``filepath`` (an npz)."""
    if state.ids is not None:
        raise ValueError("checkpoint a particle-order state: "
                         "slot_step.unslotify_state first")
    data = {}
    for name in _ARRAY_FIELDS:
        val = getattr(state, name)
        if isinstance(val, torch.Tensor):
            data[name] = val.detach().cpu().numpy()
        else:
            data[name] = np.asarray(val)
    np.savez(filepath, **data)


def load_checkpoint(filepath, template_state):
    """The checkpoint at ``filepath`` in the form of ``template_state``:
    each field cast to the template's dtype and device, the fields the file
    lacks (a JAX checkpoint's ``seed``) taken from the template, and no
    engine state (``run_simulation`` rebuilds it)."""
    device = template_state.device
    updates = {}
    with np.load(filepath) as data:
        for name in _ARRAY_FIELDS:
            if name not in data:
                continue
            val = data[name]
            if name in _SCALARS:
                updates[name] = _SCALARS[name](val.item())
            else:
                tmpl = getattr(template_state, name)
                updates[name] = torch.as_tensor(
                    np.array(val), dtype=tmpl.dtype, device=device)
    return template_state.replace(nbrs=None, ids=None, **updates)
