"""What surrounds the full-stencil sweep's CUDA kernel, held on the CPU:

(a) the staging plan (``stage_plan``, ``stage_cells``) for every capacity
    the wrapper takes: shared memory within a block's limit, a legal block,
    a stage that holds a typical neighbourhood at once and any single cell
    always;
(b) the hi/lo filter: every pair whose hi/lo r^2 is inside the cutoff has its
    plain hi-word r^2 inside ``hilo_filter_cutoff2``, on boxes up to L = 200
    with particles on the box faces, lo words up to the contract's bound and
    pairs within a few ulp of the cutoff;
(c) the kernel's schedule (stages, sub-lists, chunks, per-thread queues, any
    lane short of room -> the warp drains), emulated thread by thread in
    Python: it visits exactly the pairs of ``cell_sweep_plain``, each
    sub-list in list order, never overfills a queue, and its sums agree.

No card needed; one torch thread.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from mdtpu_torch.ops.cell_grid import CellGridEngine
from mdtpu_torch.ops.cell_sweep import (FILTER_UNROLL, HILO_LO_BOUND,
                                        MAX_CAPACITY, MAX_SHARED_BYTES,
                                        QUEUE_DEPTH, PairTiles,
                                        cell_sweep_plain, hilo_filter_cutoff2,
                                        stage_cells, stage_plan)
from mdtpu_torch.potentials.lennard_jones import LennardJones

KINDS = {"f32": (torch.float32, False), "f64": (torch.float64, False),
         "hilo": (torch.float32, True)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ (a) plan

def _kernel_shared_bytes(list_len, threads, esize, hilo):
    """The kernel's own count (``shared_bytes`` in csrc/cell_sweep.cu): the
    list and its 16 pad candidates, 5 sums a thread, 3 x 32 shifts, 2 x 32
    ints of cell records, the queues."""
    return (((8 if hilo else 4) * (list_len + 16) + 5 * threads + 96) * esize
            + 64 * 4 + QUEUE_DEPTH * threads * 2)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("first", range(1, MAX_CAPACITY + 1, 64))
def test_stage_plan_every_capacity(first, kind):
    dtype, hilo = KINDS[kind]
    esize = torch.finfo(dtype).bits // 8
    for cap in range(first, min(first + 64, MAX_CAPACITY + 1)):
        list_len, smem, threads = stage_plan(cap, dtype, hilo)
        assert smem <= MAX_SHARED_BYTES
        assert smem == _kernel_shared_bytes(list_len, threads, esize, hilo)
        assert cap <= threads <= 1024 and threads % 32 == 0
        assert threads & (threads - 1) == 0      # the block's tree reduction
        assert cap <= list_len <= 27 * cap       # one full cell always fits
        assert QUEUE_DEPTH >= FILTER_UNROLL
        # Every neighbourhood goes through in stages of 27, 9, 3 or 1 cells.
        assert stage_cells([cap] * 27, list_len) in (27, 9, 3, 1)
        assert stage_cells([cap] + [0] * 26, list_len) == 27


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_stage_plan_bench_shape_stages_27_cells_at_once(kind):
    """N = 65,536 in 15^3 cells of capacity 37: a neighbourhood holds 524
    particles on average and fits in one stage with room for 5 sigma of a
    Poisson count; two threads per slot."""
    dtype, hilo = KINDS[kind]
    list_len, _, threads = stage_plan(37, dtype, hilo)
    mean = 27 * 65536 / 15 ** 3
    assert list_len >= mean + 5 * math.sqrt(mean)
    assert threads == 128
    rng = np.random.default_rng(0)
    for _ in range(100):
        counts = np.minimum(rng.poisson(65536 / 15 ** 3, 27), 37)
        assert stage_cells(list(counts), list_len) == 27


@pytest.mark.parametrize("counts,list_len,want", [
    ([10] * 27, 270, 27), ([10] * 27, 269, 9), ([10] * 27, 90, 9),
    ([10] * 27, 89, 3), ([10] * 27, 30, 3), ([10] * 27, 29, 1),
    ([10] * 27, 10, 1), ([0] * 27, 1, 27),
    ([30] * 9 + [0] * 18, 100, 3), ([0] * 13 + [40] + [0] * 13, 40, 27),
], ids=lambda v: str(v) if isinstance(v, int) else None)
def test_stage_cells(counts, list_len, want):
    assert stage_cells(counts, list_len) == want


def test_stage_cells_refuses_a_cell_longer_than_the_list():
    with pytest.raises(ValueError):
        stage_cells([11] + [0] * 26, 10)
    with pytest.raises(ValueError):
        stage_plan(MAX_CAPACITY + 1, torch.float32)


# ----------------------------------------------------------- (b) hi/lo filter

def _near_cutoff_state(box_len, cutoff, n_pairs, seed):
    """Pairs at r_c (1 + k eps), k in -6 .. 6, placed anywhere in the box
    and on its faces; hi words rounded off the true positions by up to 3 eps
    L, so the lo words are large. Returns f32 ``(hi, lo)``, (2 n_pairs, 3)."""
    rng = np.random.default_rng(seed)
    eps = float(torch.finfo(torch.float32).eps)
    first = rng.random((n_pairs, 3)) * box_len
    on_face = rng.random((n_pairs, 3)) < 0.3
    first = np.where(on_face, np.where(rng.random((n_pairs, 3)) < 0.5, 0.0,
                                       box_len * (1 - 2.0 ** -25)), first)
    direction = rng.standard_normal((n_pairs, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    k = rng.integers(-6, 7, n_pairs)[:, None]
    second = np.mod(first + cutoff * (1 + k * eps) * direction, box_len)
    true = np.concatenate([first, second])
    noise = (rng.random(true.shape) * 2 - 1) * 3 * eps * box_len
    hi = np.clip((true + noise).astype(np.float32), np.float32(0),
                 np.nextafter(np.float32(box_len), np.float32(0)))
    lo = (true - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi), torch.from_numpy(lo)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("box_len,cutoff", [(10.0, 2.8), (43.7, 2.8),
                                            (200.0, 2.8), (200.0, 1.8)])
def test_hilo_filter_admits_every_pair_inside_the_cutoff(box_len, cutoff,
                                                         seed):
    dtype = torch.float32
    eps = float(torch.finfo(dtype).eps)
    hi, lo = _near_cutoff_state(box_len, cutoff, 300, seed)
    n = hi.shape[0]
    cell = torch.eye(3, dtype=dtype) * box_len
    cinv = torch.eye(3, dtype=dtype) / box_len
    pot = LennardJones(r_cut=cutoff)
    eng = CellGridEngine(potential=pot, cutoff=cutoff, skin=0.0,
                         grid=(3, 3, 3), cell_capacity=64)
    nbrs = eng.allocate(hi, torch.ones(n, dtype=dtype), cell, cinv)
    assert not bool(nbrs.overflow)
    slot_hi, slot_lo, diam, counts, box = eng.slot_inputs_hilo(
        hi, lo, cell, cinv, nbrs)
    # The contract the margin is derived from.
    assert float(slot_lo.abs().max()) <= HILO_LO_BOUND * eps * box_len
    assert float(slot_lo.abs().max()) > 2 * eps * box_len
    assert float(slot_hi.abs().max()) <= 2 * box_len

    filter2 = hilo_filter_cutoff2(cutoff, box, dtype)
    assert filter2.dtype == dtype
    exact = PairTiles(slot_hi, diam, counts, box, eng.grid, cutoff, pot,
                      slot_lo=slot_lo)
    plain = PairTiles(slot_hi, diam, counts, box, eng.grid, cutoff, pot)
    cutoff2 = exact.cutoff2
    assert float(filter2) > float(cutoff2)
    assert float(filter2) / float(cutoff2) - 1 < 1e-3    # it still rejects
    inside = on_the_edge = rescued = 0
    for off in itertools.product((-1, 0, 1), repeat=3):
        nb, _, _, _, d = exact.tile(off)
        _, _, _, _, p = plain.tile(off)
        r2_exact = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        r2_plain = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
        pair = exact.occ[:, :, None] & exact.occ[nb][:, None, :]
        hit = pair & (r2_exact < cutoff2)
        assert bool((r2_plain[hit] < filter2).all())
        inside += int(hit.sum())
        on_the_edge += int((pair & ((r2_exact / cutoff2 - 1).abs()
                                    < 16 * eps)).sum())
        rescued += int((hit & ~(r2_plain < cutoff2)).sum())
    assert inside > 100 and on_the_edge > 300
    if box_len >= 43.7:
        # Without the widening the filter would have lost pairs.
        assert rescued > 0


# ------------------------------------------------------- (c) the schedule

def _lj(r2, rc2):
    """Unshifted LJ at sigma = eps = 1: (u, f / r), zero outside r_c."""
    if not r2 < rc2:
        return 0.0, 0.0
    inv_r2 = 1.0 / r2
    sr6 = inv_r2 * inv_r2 * inv_r2
    sr12 = sr6 * sr6
    return 4.0 * (sr12 - sr6), 24.0 * (2.0 * sr12 - sr6) * inv_r2


def emulate_sweep(slot_pos, counts, box, grid, cutoff, *, list_len, threads,
                  depth, unroll):
    """The kernel's schedule on the CPU, one block per cell and one Python
    object per thread. Returns ``(energy, virial, force (3, n_slots),
    visits, drains, longest_queue)`` with ``visits[(cell, slot)]`` one list
    per sub-list of ``(stencil cell, neighbour cell, j)`` in the order the
    thread evaluated them."""
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    cap = slot_pos.shape[1] // n_cells
    pos = slot_pos.reshape(3, n_cells, cap).numpy()
    counts = np.minimum(counts.numpy(), cap)
    box = box.numpy()
    rc2 = cutoff * cutoff
    force = np.zeros((3, n_cells, cap))
    energy = virial = 0.0
    visits, drains, longest = {}, 0, 0
    for cell in range(n_cells):
        home = (cell // (ny * nz), (cell // nz) % ny, cell % nz)
        stencil = []
        for off in itertools.product((-1, 0, 1), repeat=3):
            j = [h + o for h, o in zip(home, off)]
            shift = [((a >= n) - (a < 0)) * length
                     for a, n, length in zip(j, grid, box)]
            j = [a % n for a, n in zip(j, grid)]
            stencil.append(((j[0] * ny + j[1]) * nz + j[2], shift))
        n_own = int(counts[cell])
        if n_own == 0:
            continue
        n_nb = [int(counts[nb]) for nb, _ in stencil]
        cells_per_stage = stage_cells(n_nb, list_len)
        n_sub = threads // n_own
        active = [t for t in range(threads) if t // n_own < n_sub]
        acc = {t: np.zeros(5) for t in active}
        seen = {t: [] for t in active}
        for c0 in range(0, 27, cells_per_stage):
            staged = [(c, stencil[c][0], j, pos[:, stencil[c][0], j]
                       + np.array(stencil[c][1]))
                      for c in range(c0, c0 + cells_per_stage)
                      for j in range(n_nb[c])]
            assert len(staged) <= list_len
            n_chunks = -(-len(staged) // unroll)
            per = -(-n_chunks // n_sub)
            for warp in range(0, threads, 32):
                lanes = [t for t in range(warp, warp + 32) if t in acc]
                if not lanes:
                    continue
                queue = {t: [] for t in lanes}

                def drain():
                    for t in lanes:
                        own = pos[:, cell, t % n_own]
                        for k in queue[t]:
                            c, nb, j, where = staged[k]
                            if nb == cell and c == 13 and j == t % n_own:
                                continue
                            d = own - where
                            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                            assert r2 < rc2
                            u, f = _lj(r2, rc2)
                            acc[t] += (f * d[0], f * d[1], f * d[2],
                                       0.5 * u, 0.5 * (f * r2))
                            seen[t].append((c, nb, j))
                        queue[t] = []

                for it in range(per + 1):
                    done = it >= per
                    if done or any(len(queue[t]) > depth - unroll
                                   for t in lanes):
                        drains += 1
                        drain()
                        if done:
                            break
                    for t in lanes:
                        chunk = it * n_sub + t // n_own
                        own = pos[:, cell, t % n_own]
                        for k in range(chunk * unroll,
                                       min((chunk + 1) * unroll, len(staged))):
                            d = own - staged[k][3]
                            if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < rc2:
                                queue[t].append(k)
                        longest = max(longest, len(queue[t]))
        for slot in range(n_own):
            total = np.zeros(5)
            for sub in range(n_sub):
                total += acc[sub * n_own + slot]
            force[:, cell, slot] = total[:3]
            energy += total[3]
            virial += total[4]
            visits[(cell, slot)] = [seen[sub * n_own + slot]
                                    for sub in range(n_sub)]
    return energy, virial, force.reshape(3, -1), visits, drains, longest


def _plain_pairs(slot_pos, slot_diam, counts, box, grid, cutoff):
    """``{(cell, slot): [(stencil cell, neighbour cell, j), ...]}`` in the
    plain sweep's order: stencil offsets in (ox, oy, oz) order, then j."""
    pot = LennardJones(r_cut=cutoff)
    tiles = PairTiles(slot_pos, slot_diam, counts, box, grid, cutoff, pot)
    pairs = {}
    for c, off in enumerate(itertools.product((-1, 0, 1), repeat=3)):
        nb, _, _, _, d = tiles.tile(off)
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        mask = (tiles.occ[:, :, None] & tiles.occ[nb][:, None, :]
                & (r2 < tiles.cutoff2))
        if off == (0, 0, 0):
            mask = mask & tiles.not_self
        for cell, i, j in mask.nonzero().tolist():
            pairs.setdefault((cell, i), []).append((c, int(nb[cell]), j))
    return pairs


def _random_slots(grid, cap, edge, mean, seed):
    rng = np.random.default_rng(seed)
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    counts = np.minimum(rng.poisson(mean, n_cells), cap)
    counts[0], counts[1] = 0, cap
    idx = np.arange(n_cells)
    corner = np.stack([idx // (ny * nz), (idx // nz) % ny, idx % nz]) * edge
    m = math.ceil(cap ** (1 / 3) - 1e-9)
    pos = np.full((3, n_cells, cap), 555.0)    # vacant slots: never read
    for c in range(n_cells):
        sites = rng.permutation(m ** 3)[:counts[c]]
        ijk = np.stack([sites // (m * m), (sites // m) % m, sites % m])
        pos[:, c, :counts[c]] = corner[:, c, None] + (
            ijk + 0.5 + 0.05 * rng.standard_normal(ijk.shape)) * (edge / m)
    return (torch.from_numpy(pos.reshape(3, -1)),
            torch.ones(n_cells * cap, dtype=torch.float64),
            torch.from_numpy(counts),
            torch.tensor([g * edge for g in grid], dtype=torch.float64))


def _cluster_slots():
    """64 particles within one cutoff of each other around the corner that
    8 cells of a 3 x 3 x 3 grid share, 8 in each; the other cells empty."""
    edge, cap, spacing = 5.0, 8, 0.85
    ijk = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij")
                   ).reshape(3, -1)
    points = 2 * edge + (ijk - 1.5) * spacing
    cid = np.floor(points / edge).astype(int)
    cid = (cid[0] * 3 + cid[1]) * 3 + cid[2]
    pos = np.full((3, 27, cap), 555.0)
    counts = np.zeros(27, dtype=np.int64)
    for p, c in zip(points.T, cid):
        pos[:, c, counts[c]] = p
        counts[c] += 1
    return (torch.from_numpy(pos.reshape(3, -1)),
            torch.ones(27 * cap, dtype=torch.float64),
            torch.from_numpy(counts),
            torch.full((3,), 3 * edge, dtype=torch.float64))


SCHEDULES = {
    # grid, capacity, plan (list_len, threads, depth, unroll)
    "one_stage": ((3, 3, 3), 8, dict(list_len=216, threads=32, depth=32,
                                     unroll=8)),
    "the_module_plan": ((3, 4, 3), 8, None),
    "two_warps_small_queue": ((3, 3, 4), 8, dict(list_len=144, threads=64,
                                                 depth=8, unroll=8)),
    "stages_of_9": ((3, 3, 3), 8, dict(list_len=60, threads=32, depth=16,
                                       unroll=8)),
    "stages_of_3_and_1": ((3, 3, 3), 8, dict(list_len=12, threads=32,
                                             depth=16, unroll=4)),
    "queue_depth_1": ((3, 3, 3), 8, dict(list_len=216, threads=32, depth=1,
                                         unroll=1)),
}


def _check_schedule(slots, grid, cutoff, plan):
    slot_pos, slot_diam, counts, box = slots
    energy, virial, force, visits, drains, longest = emulate_sweep(
        slot_pos, counts, box, grid, cutoff, **plan)
    assert longest <= plan["depth"]
    want = _plain_pairs(slot_pos, slot_diam, counts, box, grid, cutoff)
    assert set(k for k, v in visits.items() if any(v)) == set(want)
    for key, pairs in want.items():
        subs = visits[key]
        # Each sub-list in list order; together exactly the plain pairs.
        assert all(s == sorted(s) for s in subs)
        assert sorted(p for s in subs for p in s) == pairs
    e0, w0, f0 = cell_sweep_plain(slot_pos, slot_diam, counts, box, grid,
                                  cutoff, LennardJones(r_cut=cutoff))
    np.testing.assert_allclose(energy, float(e0), rtol=1e-12)
    np.testing.assert_allclose(virial, float(w0), rtol=1e-12)
    np.testing.assert_allclose(force, f0.numpy(), rtol=1e-10,
                               atol=1e-12 * float(f0.abs().max()))
    return visits, drains


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_visits_the_plain_pairs_in_order(name):
    grid, cap, plan = SCHEDULES[name]
    cutoff = 2.5
    if plan is None:
        list_len, _, threads = stage_plan(cap, torch.float64)
        plan = dict(list_len=list_len, threads=threads, depth=QUEUE_DEPTH,
                    unroll=FILTER_UNROLL)
    slots = _random_slots(grid, cap, 2.6, 4.0, seed=len(name))
    visits, drains = _check_schedule(slots, grid, cutoff, plan)
    n_blocks = int((slots[2] > 0).sum())
    if name == "queue_depth_1":
        # A drain after every hit: far more drains than blocks.
        assert drains > 10 * n_blocks
    if name.startswith("stages_of"):
        assert drains >= 3 * n_blocks


@pytest.mark.parametrize("depth,unroll,threads", [(8, 8, 32), (16, 8, 64),
                                                  (1, 1, 32)])
def test_schedule_when_every_candidate_is_a_hit(depth, unroll, threads):
    slots = _cluster_slots()
    plan = dict(list_len=216, threads=threads, depth=depth, unroll=unroll)
    visits, drains = _check_schedule(slots, (3, 3, 3), 4.5, plan)
    # 63 hits per own slot: every queue fills and drains several times.
    assert all(sum(len(s) for s in subs) == 63 for subs in visits.values())
    assert drains > 8
