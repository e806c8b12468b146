"""Spatial domain decomposition over the ranks of a ``torch.distributed``
group: the counterpart of ``mdtpu/parallel``.

``run_simulation_sharded`` is ``run_simulation`` over a shard ring (the same
outputs), driving :class:`HaloSlotEngine`: the state sharded in cell-sorted
slot order over x-slabs, two ghost planes exchanged a step, B1 launched over
each slab's interior cells, and rows migrating between ranks on the device
at every rebuild. ``ShardRing`` is the ring over a group (NCCL on
GPUs, gloo on CPU ranks), or a ring of one without one.
``mdtpu_torch.minimize.fire_minimize_sharded`` is FIRE on the same engine.
"""

from mdtpu_torch.parallel.driver import run_simulation_sharded
from mdtpu_torch.parallel.halo_slot import HaloSlotEngine
from mdtpu_torch.parallel.mesh import ShardRing

__all__ = [
    "run_simulation_sharded",
    "HaloSlotEngine",
    "ShardRing",
]
