"""The shard ring: ranks of a ``torch.distributed`` group in a periodic line.

Counterpart of ``mdtpu/parallel/mesh.py`` (``make_mesh``) and of the
collectives the JAX package calls inside ``shard_map``: ``psum``, ``pmax``
and ``ppermute`` to the two neighbours of a one-axis mesh. Rank ``p`` owns
x-slab ``p`` of the cell grid; its left neighbour is ``p - 1`` and its right
``p + 1``, modulo the ring's size.

The caller builds the group (``torch.distributed.init_process_group`` with
its backend, ``init_method``, ``world_size`` and ``rank``): NCCL for CUDA
tensors, gloo for CPU tensors. Without a group and without an initialised
default group the ring has one rank, on ``device``: the JAX package's
one-device mesh. A ring of one exchanges by a local copy (a send to one's
own rank is refused), which is what ``ppermute`` does on one device; its
reductions and gathers go through the group's backend where it has one.
"""

from __future__ import annotations

from typing import Sequence

import torch

from mdtpu_torch.utils.device import resolve_device

# Tags of the two directions of an exchange, per tensor (gloo matches
# messages by tag; at two ranks the left and the right neighbour are the same
# peer).
_RIGHTWARD, _LEFTWARD = 0, 1


def _dist():
    import torch.distributed as dist
    return dist


class ShardRing:
    """Ranks of a process group in a ring (see the module docstring); the
    counterpart of ``make_mesh``. ``ShardRing(group, device)`` is the ring
    over ``group``: the default group where one is initialised, else a
    ring of one on ``device``.

    ``rank`` and ``size`` are the rank's place and the ring's length,
    ``device`` the device of its tensors. Every collective is called by
    every rank in the same order."""

    def __init__(self, group=None, device=None):
        dist = _dist()
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
            self.device = resolve_device(device)
            return
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        backend = str(dist.get_backend(group)).lower()
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass device='cpu' (with a "
                    "gloo group) to run the ranks on the CPU")
            device = f"cuda:{self.rank % torch.cuda.device_count()}"
        self.device = resolve_device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group moves CUDA tensors; got device "
                             f"{self.device} (use gloo for CPU ranks)")
        if backend == "gloo" and self.device.type != "cpu":
            raise ValueError(f"this ring moves CPU tensors over gloo; got "
                             f"device {self.device} (use NCCL for CUDA "
                             f"ranks)")
        if self.device.type == "cuda":
            # NCCL binds a rank to the current device at its first
            # collective.
            torch.cuda.set_device(self.device)

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.size

    def _all_reduce(self, t, op):
        # A group of one still reduces through its backend (NCCL on one
        # card is the path measured there); only the ring without a group
        # has nothing to do.
        if self.group is None:
            return t
        out = t.clone()
        _dist().all_reduce(out, op=op, group=self.group)
        return out

    def sum(self, t):
        """The sum of ``t`` over the ranks (``psum``)."""
        return self._all_reduce(t, _dist().ReduceOp.SUM)

    def max(self, t):
        """The largest ``t`` over the ranks (``pmax``)."""
        return self._all_reduce(t, _dist().ReduceOp.MAX)

    def any(self, flag):
        """True (a 0-d bool tensor) where any rank's ``flag`` is true."""
        return self.max(flag.to(torch.int32)) > 0

    def exchange(self, to_left: Sequence[torch.Tensor],
                 to_right: Sequence[torch.Tensor]):
        """Send ``to_left`` to the left neighbour and ``to_right`` to the
        right one; returns ``(from_left, from_right)``, lists of tensors of
        the shapes and dtypes sent (every rank sends the same shapes). The
        ``ppermute`` pair of the JAX package's halo and migration, in one
        ``batch_isend_irecv``."""
        if self.size == 1:
            # The ring's only rank is its own neighbour on both sides.
            def copy(t):
                return t.clone(memory_format=torch.contiguous_format)
            return [copy(t) for t in to_right], [copy(t) for t in to_left]
        to_left = [t.contiguous() for t in to_left]
        to_right = [t.contiguous() for t in to_right]
        dist = _dist()
        from_left = [torch.empty_like(t) for t in to_right]
        from_right = [torch.empty_like(t) for t in to_left]
        # One fixed order on every rank: send right, send left, receive from
        # the left, receive from the right. At two ranks both neighbours are
        # one peer, which then pairs the messages in this order (NCCL) or by
        # their direction's tag (gloo).
        def tag(direction, i):
            return 2 * i + direction

        ops = ([dist.P2POp(dist.isend, t, self.right, self.group,
                           tag(_RIGHTWARD, i)) for i, t in enumerate(to_right)]
               + [dist.P2POp(dist.isend, t, self.left, self.group,
                             tag(_LEFTWARD, i)) for i, t in enumerate(to_left)]
               + [dist.P2POp(dist.irecv, t, self.left, self.group,
                             tag(_RIGHTWARD, i))
                  for i, t in enumerate(from_left)]
               + [dist.P2POp(dist.irecv, t, self.right, self.group,
                             tag(_LEFTWARD, i))
                  for i, t in enumerate(from_right)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_left, from_right

    def gather_blocks(self, t):
        """The ranks' equal-size blocks of ``t`` put end to end along its
        last axis, in rank order (an ``all_gather``): the slot blocks of the
        slabs give the global slot layout."""
        if self.group is None:
            return t
        is_bool = t.dtype == torch.bool
        src = (t.to(torch.uint8) if is_bool else t).contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        _dist().all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim=-1)
        return out.bool() if is_bool else out
