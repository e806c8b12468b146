"""What surrounds the half-stencil sweep's and the probe's CUDA kernels, held
on the CPU:

(a) the staging plan (``plane_stage_plan``, ``plane_stage_cells``) for every
    capacity: the layout's bytes equal a mirror of the kernel's formula, a
    legal block, a stage that holds any single cell always, and a plan
    beyond a block's shared memory where nothing fits (the kernel refuses
    it);
(b) the kernel's schedule, emulated thread by thread in Python: stages,
    several threads per own slot, filter -> per-thread queues -> drain (any
    lane short of room -> the warp drains), hit masks set by OR, one thread
    per Newton candidate adding the reactions in own-slot order, partials
    for occupied slots only in a buffer that starts as NaN, the fold-back in
    k order. Its sums agree with ``plane_sweep_plain`` and do not depend on
    the order in which the emulated blocks, warps and lanes run;
(c) the probe's split over offsets (one warp per offset, columns in groups
    of four with a padded group, the offsets' sums added in order): the same
    bits as one thread walking offsets and columns in order, and
    ``probe_sweep_plain`` to 1e-5 of the largest value.

No card needed; one torch thread.
"""

import math

import numpy as np
import pytest
import torch

from mdtpu_torch.ops.cell_sweep import (FILTER_UNROLL, MAX_CAPACITY,
                                        MAX_SHARED_BYTES, QUEUE_DEPTH)
from mdtpu_torch.ops.experimental import probe
from mdtpu_torch.ops.plane_sweep import (LIST_CELLS, NEWTON_CELLS,
                                         SELF_COLUMN, plane_stage_cells,
                                         plane_stage_plan, plane_sweep_plain)
from mdtpu_torch.potentials.lennard_jones import LennardJones

DTYPES = {"f32": torch.float32, "f64": torch.float64}
# The capacities the first design's (3, C, C) tile took.
TILE_LIMIT = {"f32": 137, "f64": 97}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ (a) plan

def _kernel_shared_bytes(cap, list_len, mask_words, threads, esize):
    """The kernel's own count (``shared_bytes`` in csrc/plane_sweep.cu): the
    list and its 16 pad candidates, the own cell's slots, 5 sums a thread,
    3 x 16 shifts, 2 x 16 ints of cell records, the masks, the queues."""
    return ((4 * (list_len + 16) + 4 * cap + 5 * threads + 48) * esize
            + 32 * 4 + list_len * mask_words * 4 + QUEUE_DEPTH * threads * 2)


def _check_plan(cap, dtype):
    list_len, mask_words, smem, threads = plane_stage_plan(cap, dtype)
    esize = torch.finfo(dtype).bits // 8
    assert smem == _kernel_shared_bytes(cap, list_len, mask_words, threads,
                                        esize)
    assert cap <= threads <= 1024 and threads >= 32
    assert threads & (threads - 1) == 0      # the block's tree reduction
    assert mask_words == -(-cap // 32)       # a bit per own slot
    assert cap <= list_len <= 15 * cap       # one full cell always fits
    assert QUEUE_DEPTH >= FILTER_UNROLL
    return list_len, smem


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("first", range(1, 138, 8))
def test_plane_stage_plan_every_capacity_of_the_tile(first, kind):
    """Every capacity 1..137: the plan fits wherever the first design's tile
    did (and beyond), and any neighbourhood goes through in stages of 15, 3
    or 1 cells."""
    dtype = DTYPES[kind]
    for cap in range(first, min(first + 8, 138)):
        list_len, smem = _check_plan(cap, dtype)
        assert smem <= MAX_SHARED_BYTES
        assert plane_stage_cells([cap] * 15, list_len) in (15, 3, 1)
        assert plane_stage_cells([cap] + [0] * 14, list_len) == 15
        # A typical neighbourhood (cells half full) is one stage.
        assert plane_stage_cells([cap // 2] * 15, list_len) == 15


@pytest.mark.parametrize("kind", sorted(DTYPES))
@pytest.mark.parametrize("first", range(138, MAX_CAPACITY + 1, 128))
def test_plane_stage_plan_large_capacities_fit_or_are_refused(first, kind):
    """Beyond the tile's limit: the layout still matches; a plan either fits
    or is one cell long and beyond a block's shared memory, which the kernel
    refuses. Once a capacity does not fit, no larger one does."""
    dtype = DTYPES[kind]
    refused = False
    for cap in range(first, min(first + 128, MAX_CAPACITY + 1)):
        list_len, smem = _check_plan(cap, dtype)
        if smem > MAX_SHARED_BYTES:
            assert list_len == cap
            refused = True
        else:
            assert not refused
            assert plane_stage_cells([cap] * 15, list_len) in (15, 3, 1)


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_plane_stage_plan_limits(kind):
    dtype = DTYPES[kind]
    fits = [plane_stage_plan(c, dtype)[2] <= MAX_SHARED_BYTES
            for c in range(1, MAX_CAPACITY + 1)]
    limit = fits.index(False)          # capacities 1..limit fit
    assert limit >= 4 * TILE_LIMIT[kind]
    assert not any(fits[limit:])
    with pytest.raises(ValueError):
        plane_stage_plan(0, dtype)
    with pytest.raises(ValueError):
        plane_stage_plan(MAX_CAPACITY + 1, dtype)


@pytest.mark.parametrize("kind", sorted(DTYPES))
def test_plane_stage_plan_bench_shape_is_one_stage(kind):
    """N = 65,536 in 15^3 cells of capacity 37: the 15 cells hold 291
    particles on average and fit in one stage with room for 4 sigma of a
    Poisson count; one thread per slot, masks of two words."""
    list_len, mask_words, _, threads = plane_stage_plan(37, DTYPES[kind])
    mean = 15 * 65536 / 15 ** 3
    assert list_len >= mean + 4 * math.sqrt(mean)
    assert (threads, mask_words) == (64, 2)
    rng = np.random.default_rng(0)
    for _ in range(100):
        counts = np.minimum(rng.poisson(65536 / 15 ** 3, 15), 37)
        assert plane_stage_cells(list(counts), list_len) == 15


@pytest.mark.parametrize("counts,list_len,want", [
    ([10] * 15, 150, 15), ([10] * 15, 149, 3), ([10] * 15, 30, 3),
    ([10] * 15, 29, 1), ([10] * 15, 10, 1), ([0] * 15, 1, 15),
    ([30] * 3 + [0] * 12, 89, 1), ([30] * 3 + [0] * 12, 90, 15),
    ([0] * 3 + [20, 0, 0] * 4, 79, 3), ([0, 40, 0] + [0] * 12, 40, 15),
], ids=lambda v: str(v) if isinstance(v, int) else None)
def test_plane_stage_cells(counts, list_len, want):
    assert plane_stage_cells(counts, list_len) == want


def test_plane_stage_cells_refuses_a_cell_longer_than_the_list():
    with pytest.raises(ValueError):
        plane_stage_cells([11] + [0] * 14, 10)


def test_list_cells_are_the_half_stencil():
    """The self column, then the Newton cells; with their mirror images the
    27 offsets, each once."""
    assert LIST_CELLS == SELF_COLUMN + NEWTON_CELLS and len(LIST_CELLS) == 15
    mirrored = set(NEWTON_CELLS) | {tuple(-o for o in off)
                                    for off in NEWTON_CELLS}
    assert len(mirrored) == 24 and not mirrored & set(SELF_COLUMN)
    assert len(mirrored | set(SELF_COLUMN)) == 27


# ------------------------------------------------------- (b) the schedule

def _lj(r2, rc2, sigma):
    """Unshifted LJ at eps = 1: (u, f / r), zero outside r_c."""
    if not r2 < rc2:
        return 0.0, 0.0
    inv_r2 = 1.0 / r2
    sr2 = (sigma * sigma) * inv_r2
    sr6 = sr2 * sr2 * sr2
    sr12 = sr6 * sr6
    return 4.0 * (sr12 - sr6), 24.0 * (2.0 * sr12 - sr6) * inv_r2


def emulate_plane_sweep(slot_pos, slot_diam, counts, box, grid, cutoff, r_cut,
                        *, list_len, threads, depth, unroll, order_seed):
    """The kernel's schedule on the CPU, one block per cell and one Python
    object per thread; blocks, warps and the lanes of a warp run in an order
    shuffled by ``order_seed``. Returns ``(energy, virial, force (3,
    n_slots), stats)``."""
    order = np.random.default_rng(order_seed)
    nx, ny, nz = grid
    n_cells = nx * ny * nz
    cap = slot_pos.shape[1] // n_cells
    pos = slot_pos.reshape(3, n_cells, cap).numpy()
    diam = slot_diam.reshape(n_cells, cap).numpy()
    counts = np.minimum(counts.numpy(), cap)
    box = box.numpy()
    rc2_engine, rc2 = cutoff * cutoff, r_cut * r_cut
    own_force = np.zeros((3, n_cells, cap))
    react = np.full((12, 3, n_cells, cap), np.nan)   # torch.empty
    e_part, w_part = np.zeros(n_cells), np.zeros(n_cells)
    stats = {"drains": 0, "longest_queue": 0, "bits": 0, "newton_pairs": 0,
             "stages": 0, "zero_force_hits": 0}

    for cell in map(int, order.permutation(n_cells)):
        home = (cell // (ny * nz), (cell // nz) % ny, cell % nz)
        cells = []
        for off in LIST_CELLS:
            j = [h + o for h, o in zip(home, off)]
            shift = [(int(a >= n) - int(a < 0)) * length
                     for a, n, length in zip(j, grid, box)]
            j = [a % n for a, n in zip(j, grid)]
            cells.append(((j[0] * ny + j[1]) * nz + j[2], np.array(shift)))
        n_own = int(counts[cell])
        n_nb = [int(counts[nb]) for nb, _ in cells]
        per_stage = plane_stage_cells(n_nb, list_len)
        n_sub = threads // n_own if n_own else 0
        active = [t for t in range(threads) if n_own and t // n_own < n_sub]
        acc = {t: np.zeros(5) for t in active}
        for c0 in range(0, 15, per_stage):
            staged = [(c, cells[c][0], j,
                       pos[:, cells[c][0], j] + cells[c][1],
                       diam[cells[c][0], j])
                      for c in range(c0, c0 + per_stage)
                      for j in range(n_nb[c])]
            if not staged:
                continue
            assert len(staged) <= list_len
            stats["stages"] += 1
            newton_k = next((k for k, s in enumerate(staged) if s[0] >= 3),
                            len(staged))
            mask = [0] * len(staged)
            n_chunks = -(-len(staged) // unroll)
            per = -(-n_chunks // n_sub) if n_sub else 0
            for warp in map(int, order.permutation(range(0, threads, 32))):
                lanes = [t for t in range(warp, warp + 32) if t in acc]
                if not lanes:
                    continue
                queue = {t: [] for t in lanes}

                def drain():
                    for t in map(int, order.permutation(lanes)):
                        i = t % n_own
                        own, d_i = pos[:, cell, i], diam[cell, i]
                        for k in queue[t]:
                            c, nb, j, where, d_j = staged[k]
                            if c == 1 and j == i:
                                continue        # the self pair
                            d = own - where
                            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                            if not r2 < rc2_engine:
                                continue
                            u, f = _lj(r2, rc2, 0.5 * (d_i + d_j))
                            scale = 1.0 if k >= newton_k else 0.5
                            acc[t] += (f * d[0], f * d[1], f * d[2],
                                       scale * u, scale * (f * r2))
                            if k >= newton_k:
                                stats["newton_pairs"] += 1
                                if f != 0.0:
                                    mask[k] |= 1 << i
                                else:
                                    stats["zero_force_hits"] += 1
                        queue[t] = []

                for it in range(per + 1):
                    done = it >= per
                    if done or any(len(queue[t]) > depth - unroll
                                   for t in lanes):
                        stats["drains"] += 1
                        drain()
                        if done:
                            break
                    for t in map(int, order.permutation(lanes)):
                        chunk = it * n_sub + t // n_own
                        own = pos[:, cell, t % n_own]
                        for k in range(chunk * unroll,
                                       min((chunk + 1) * unroll, len(staged))):
                            d = own - staged[k][3]
                            if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] \
                                    < rc2_engine:
                                queue[t].append(k)
                        stats["longest_queue"] = max(stats["longest_queue"],
                                                     len(queue[t]))
            # One thread per Newton candidate, its hits in own-slot order.
            for k in map(int, order.permutation(range(newton_k, len(staged)))):
                c, nb, j, where, d_k = staged[k]
                total = np.zeros(3)
                for i in range(n_own):
                    if not mask[k] >> i & 1:
                        continue
                    stats["bits"] += 1
                    d = where - pos[:, cell, i]
                    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                    _, f = _lj(r2, rc2, 0.5 * (d_k + diam[cell, i]))
                    total += (f * d[0], f * d[1], f * d[2])
                assert np.isnan(react[c - 3, :, nb, j]).all()   # written once
                react[c - 3, :, nb, j] = total
        # Each own slot adds its sub-lists' sums in order; a fixed tree for
        # the block's energy and virial.
        e_thread, w_thread = np.zeros(threads), np.zeros(threads)
        for slot in range(n_own):
            total = np.zeros(5)
            for sub in range(n_sub):
                total += acc[sub * n_own + slot]
            own_force[:, cell, slot] = total[:3]
            e_thread[slot], w_thread[slot] = total[3], total[4]
        stride = threads // 2
        while stride:
            e_thread[:stride] += e_thread[stride:2 * stride]
            w_thread[:stride] += w_thread[stride:2 * stride]
            stride //= 2
        e_part[cell], w_part[cell] = e_thread[0], w_thread[0]

    # The fold-back: occupied slots only, k in order.
    force = own_force.copy()
    for cell in map(int, order.permutation(n_cells)):
        for j in range(int(counts[cell])):
            for k in range(12):
                force[:, cell, j] += react[k, :, cell, j]
    energy = virial = 0.0
    for cell in range(n_cells):
        energy += e_part[cell]
        virial += w_part[cell]
    return energy, virial, force.reshape(3, -1), stats


def _random_slots(grid, cap, edge, mean, seed, diam_spread):
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
    diam = 1.0 + diam_spread * rng.random(n_cells * cap)
    return (torch.from_numpy(pos.reshape(3, -1)), torch.from_numpy(diam),
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


def _check_schedule(slots, grid, cutoff, r_cut, plan):
    slot_pos, slot_diam, counts, box = slots
    runs = [emulate_plane_sweep(slot_pos, slot_diam, counts, box, grid,
                                cutoff, r_cut, order_seed=seed, **plan)
            for seed in (1, 2)]
    (energy, virial, force, stats), (e2, w2, f2, _) = runs
    # The order in which blocks, warps and lanes run changes no bit.
    assert energy == e2 and virial == w2 and np.array_equal(force, f2)
    assert stats["longest_queue"] <= plan["depth"]
    assert np.isfinite(force).all()     # no partial read that was not written
    e0, w0, f0 = plane_sweep_plain(slot_pos, slot_diam, counts, box, grid,
                                   cutoff, LennardJones(r_cut=r_cut))
    np.testing.assert_allclose(energy, float(e0), rtol=1e-12)
    np.testing.assert_allclose(virial, float(w0), rtol=1e-12)
    np.testing.assert_allclose(force, f0.numpy(), rtol=1e-10,
                               atol=1e-12 * float(f0.abs().max()))
    # A bit for every Newton pair with a force, walked once.
    assert stats["bits"] == stats["newton_pairs"] - stats["zero_force_hits"]
    return stats


SCHEDULES = {
    # grid, capacity, plan (list_len, threads, depth, unroll); None: the
    # module's plan
    "the_module_plan": ((3, 4, 5), 8, None),
    "one_stage": ((3, 4, 5), 8, dict(list_len=120, threads=32, depth=32,
                                     unroll=8)),
    "two_warps_small_queue": ((3, 4, 5), 8, dict(list_len=120, threads=64,
                                                 depth=8, unroll=8)),
    "stages_of_3": ((3, 4, 5), 8, dict(list_len=24, threads=32, depth=16,
                                       unroll=8)),
    "stages_of_1": ((3, 4, 5), 8, dict(list_len=8, threads=32, depth=16,
                                       unroll=4)),
    "queue_depth_1": ((3, 3, 3), 8, dict(list_len=120, threads=32, depth=1,
                                         unroll=1)),
    "three_cells_an_axis": ((3, 3, 3), 8, dict(list_len=40, threads=32,
                                               depth=16, unroll=8)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_agrees_with_plain_in_any_thread_order(name):
    """Mixed diameters, an empty and a full cell, the potential's cutoff
    inside the engine's (hits with no force set no bit)."""
    grid, cap, plan = SCHEDULES[name]
    cutoff, r_cut = 2.5, 2.2
    if plan is None:
        list_len, _, _, threads = plane_stage_plan(cap, torch.float64)
        plan = dict(list_len=list_len, threads=threads, depth=QUEUE_DEPTH,
                    unroll=FILTER_UNROLL)
    slots = _random_slots(grid, cap, 2.6, 4.0, seed=len(name),
                          diam_spread=0.2)
    stats = _check_schedule(slots, grid, cutoff, r_cut, plan)
    n_blocks = grid[0] * grid[1] * grid[2]
    assert stats["newton_pairs"] > 100 and stats["zero_force_hits"] > 0
    if name == "stages_of_3":
        assert 2 * n_blocks < stats["stages"] <= 5 * n_blocks
    if name == "stages_of_1":
        assert stats["stages"] > 5 * n_blocks
    if name == "one_stage":
        assert stats["stages"] <= n_blocks
    if name == "the_module_plan":
        # Two thirds of the 15 cells' slots: most blocks need one stage.
        assert stats["stages"] < 2 * n_blocks
    if name == "queue_depth_1":
        # A drain after every hit: far more drains than blocks.
        assert stats["drains"] > 5 * n_blocks


@pytest.mark.parametrize("depth,unroll,threads,list_len", [
    (8, 8, 32, 120), (16, 8, 64, 120), (1, 1, 32, 120), (8, 8, 32, 24)])
def test_schedule_when_every_candidate_is_a_hit(depth, unroll, threads,
                                                list_len):
    slots = _cluster_slots()
    plan = dict(list_len=list_len, threads=threads, depth=depth,
                unroll=unroll)
    stats = _check_schedule(slots, (3, 3, 3), 4.5, 4.5, plan)
    # 64 particles, all within the cutoff: the 8 x 7 / 2 pairs inside each
    # of the 8 cells and the 8 x 8 between two cells that differ in z only
    # go through the self column, the rest are Newton pairs, every one with
    # a bit.
    assert stats["newton_pairs"] == 64 * 63 // 2 - 8 * 28 - 4 * 64
    assert stats["bits"] == stats["newton_pairs"]
    assert stats["drains"] > 8


# ------------------------------------------------------------- (c) the probe

def _probe_pair(variant, dx, dy, dz):
    r2 = dx * dx + dy * dy + dz * dz
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if variant == "nodiv":
            u, f = r2 * np.float32(0.5), r2 + dx
        else:
            inv_r2 = np.float32(1.0) / r2
            sr6 = inv_r2 * inv_r2 * inv_r2
            sr12 = sr6 * sr6
            u = np.float32(4.0) * (sr12 - sr6)
            f = (np.float32(24.0) * (np.float32(2.0) * sr12 - sr6)) * inv_r2
    inside = r2 < np.float32(probe.CUTOFF2)
    zero = np.float32(0.0)
    return np.where(inside, u, zero), np.where(inside, f, zero)


def _probe_offset_sums(w, variant, s, columns):
    """One warp's work for offset ``s``, every (plane, row, lane) at once:
    ``(ax + ay) + az`` with each sum over the window columns in order,
    evaluated ``columns`` at a time (the last group padded with zeros that
    add nothing). float32 throughout."""
    cap, c3 = probe.CAP, probe.C3
    own = [w[k, :, :, cap:2 * cap] for k in range(3)]
    win = [np.roll(w[k], s * probe.NZ, axis=1) for k in range(3)]
    pad = -c3 % columns
    win = [np.concatenate([a, np.zeros(a.shape[:2] + (pad,), np.float32)],
                          axis=2) for a in win]
    ax, ay, az = (np.zeros(own[0].shape, np.float32) for _ in range(3))
    with np.errstate(invalid="ignore", over="ignore"):
        for c0 in range(0, c3 + pad, columns):
            group = []
            for c in range(c0, c0 + columns):
                d = [own[k] - win[k][:, :, c, None] for k in range(3)]
                group.append((d, _probe_pair(variant, *d)))
            for c, (d, (_, f)) in zip(range(c0, c0 + columns), group):
                if c < c3:
                    ax, ay, az = ax + f * d[0], ay + f * d[1], az + f * d[2]
        return (ax + ay) + az


def _probe_fx_split(w, variant, chunk):
    """The kernel's fx: per offset a sum, the five added in order."""
    sums = [_probe_offset_sums(w, variant, s, 4) for s in range(probe.N_OFF)]
    acc = np.zeros_like(sums[0])
    with np.errstate(invalid="ignore"):
        for t in sums:
            acc = acc + t
    acc[:, probe.ROWS // chunk * chunk:] = 0.0   # rows that are not swept
    return acc


def _probe_fx_one_thread(w, variant, chunk):
    """One thread per own slot walking offsets, then columns, in order (the
    first design's loop)."""
    cap, c3 = probe.CAP, probe.C3
    own = [w[k, :, :, cap:2 * cap] for k in range(3)]
    acc = np.zeros(own[0].shape, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for s in range(probe.N_OFF):
            win = [np.roll(w[k], s * probe.NZ, axis=1) for k in range(3)]
            ax, ay, az = (np.zeros(acc.shape, np.float32) for _ in range(3))
            for c in range(c3):
                d = [own[k] - win[k][:, :, c, None] for k in range(3)]
                _, f = _probe_pair(variant, *d)
                ax, ay, az = ax + f * d[0], ay + f * d[1], az + f * d[2]
            acc = acc + ((ax + ay) + az)
    acc[:, probe.ROWS // chunk * chunk:] = 0.0
    return acc


@pytest.mark.parametrize("spec", ["full:45", "full:40", "nodiv:5",
                                  "nodiv:40"])
@pytest.mark.parametrize("scale", [40.0, 5.0])
def test_probe_offset_split_keeps_the_bits(spec, scale):
    variant, chunk = probe.parse_variant(spec)
    w = (probe.random_input(3, device="cpu") * (scale / 40.0)).numpy()
    split = _probe_fx_split(w, variant, chunk)
    walked = _probe_fx_one_thread(w, variant, chunk)
    assert split.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(split), np.isnan(walked))
    np.testing.assert_array_equal(np.nan_to_num(split),
                                  np.nan_to_num(walked))
    # The plain version sums a row's columns in torch's order: equal NaN
    # positions, finite values to 1e-5 of the largest.
    want = probe.probe_sweep_plain(torch.from_numpy(w), variant,
                                   chunk)[0].numpy()
    np.testing.assert_array_equal(np.isnan(split), np.isnan(want))
    fin = ~np.isnan(want)
    if variant == "full":
        assert not fin[:, :probe.ROWS // chunk * chunk].any()   # self pairs
    else:
        assert fin.all()
        floor = 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(split, want, rtol=1e-5, atol=floor)
        assert np.abs(split).max() > 0
    assert not split[:, probe.ROWS // chunk * chunk:].any()
