"""The fused ABFT kernel's launch geometry and index maps, on the CPU.

A numpy copy of ``csrc/abft_fft.cu``'s maps: the XOR swizzle of the tile
(``fft_tile.cuh``), the tiles each CTA of a group's cluster takes step by
step, the N / C columns each CTA owns and the loop its threads run over
them, the per-signal dot products' lanes, the SEU's slot and the output
stores. The kernel needs:

* a launch geometry (``launch_geometry``) that fits the H100 for every
  power-of-two N <= 8192, both dtypes, any bs and T: at most 227 KB of
  shared memory a CTA, two CTAs an SM at complex64;
* every column of a group summed by exactly one owner thread;
* every signal of a group in exactly one (CTA, step), weighted by its
  1-based global id, so the owners' sums are the plain version's;
* the SEU at the slot that the output stores read as y[row, col];
* every shared-memory read of the owners and of the dot products at most
  2-way bank conflicted (complex64: 16 banks of 8 bytes a half-warp,
  complex128: 8 banks of 16 bytes a quarter-warp).

Tolerance of the sums against the plain version: the suite's
``ATOL[dtype] * max|row|`` per checksum row (another summation order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.fft import make_plan
from repro_torch.kernels.stockham_abft import (MAX_CLUSTER, SMEM_PER_CTA,
                                               abft_fft_plain,
                                               launch_geometry)

DTYPES = {"complex64": torch.complex64, "complex128": torch.complex128}
ATOL = {"complex64": 4e-5, "complex128": 1e-11}
# kOwnCols: columns an owner thread sums at once
OWN_COLS = {"complex64": 4, "complex128": 2}
SIZES = [1 << k for k in range(3, 14)]
BS = (1, 2, 4, 8)
TRANSACTIONS = (1, 2, 3, 4, 5, 8, 16)


def _slot(e, c128):
    """Traits<V>::swz: the tile slot of point index e."""
    if c128:
        return e ^ (((e >> 3) ^ (e >> 6) ^ (e >> 9)) & 7)
    return e ^ (((e >> 4) ^ (e >> 8)) & 15)


def _geo(n, dtype, bs, t):
    return launch_geometry(make_plan(n).stages[0], DTYPES[dtype], bs, t)


def _tile_sigs(geo, k):
    """tile_sigs(): signals in tile k of a group."""
    return int(np.clip(geo.rows - k * geo.sigs, 0, geo.sigs))


def _worst_degree(e, c128):
    """Largest number of distinct words one bank serves in one access
    group of an instruction; e: (instructions, 32) slots, -1 idle."""
    group, banks = (8, 8) if c128 else (16, 16)
    worst = 1
    for row in e.reshape(-1, group):
        live = np.unique(row[row >= 0])
        if live.size:
            worst = max(worst, int(np.bincount(live % banks).max()))
    return worst


def _dot_lanes(geo):
    """signal_dots(): P = max(1, N / 16) lanes a signal; each thread's
    signal within a pass, its first point and the signals a pass."""
    tid = np.arange(geo.threads)
    log_p = max(geo.n.bit_length() - 1 - 4, 0)
    p = 1 << log_p
    lane = tid & 31
    if p < 32:                      # 32 / P signals a warp, side by side
        low = 32 >> log_p
        q = (tid >> 5) * low + (lane & (low - 1))
        j = lane // low
    else:
        q, j = tid >> log_p, tid & (p - 1)
    return q, j, p, geo.threads >> log_p


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_geometry_fits_every_group_shape(n, dtype):
    c128 = dtype == "complex128"
    for bs in BS:
        for t in TRANSACTIONS:
            geo = _geo(n, dtype, bs, t)
            rows = bs * t
            what = (n, dtype, bs, t, geo)
            assert geo.rows == rows and geo.fast, what
            assert geo.sigs & (geo.sigs - 1) == 0, what
            assert geo.sigs * n <= 8192 and geo.sigs <= max(rows, 1) * 2, what
            assert geo.tiles == -(-rows // geo.sigs), what
            assert geo.cluster in (1, 2, 4, 8) and geo.cluster <= n, what
            assert geo.cluster <= MAX_CLUSTER, what
            # every signal has a step, and no step is empty
            assert geo.steps * geo.cluster >= geo.tiles, what
            assert (geo.steps - 1) * geo.cluster < geo.tiles, what
            assert geo.threads == max(32, geo.sigs * n // 16) <= 512, what
            assert geo.accumulators == ("registers" if geo.steps == 1
                                        else "shared"), what
            sums = 4 * n // geo.cluster if geo.steps > 1 else 0
            points = (geo.sigs * n + 2 * geo.sigs + geo.threads // 32
                      + sums)
            assert geo.smem == points * (16 if c128 else 8), what
            assert geo.smem <= SMEM_PER_CTA, what
            assert geo.ctas_per_sm >= (1 if c128 else 2), what
    # the timed shape: one signal a CTA, a cluster of four, no running sums
    if n == 8192:
        geo = _geo(n, dtype, 1, 4)
        assert (geo.sigs, geo.cluster, geo.steps) == (1, 4, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_every_column_has_exactly_one_owner_thread(n, dtype):
    own = OWN_COLS[dtype]
    for bs in BS:
        for t in TRANSACTIONS:
            geo = _geo(n, dtype, bs, t)
            cols = n // geo.cluster
            seen = np.zeros(n, int)
            tid = np.arange(geo.threads)
            for rank in range(geo.cluster):
                for c0 in range(0, cols, own * geo.threads):
                    for i in range(own):
                        c = c0 + tid + i * geo.threads
                        np.add.at(seen, rank * cols + c[c < cols], 1)
            assert (seen == 1).all(), (n, bs, t, geo)


def _kernel_sums(z, geo, c128):
    """The owners' sums [z.e2, z.e3] of every group, through the CTAs' tiles
    step by step as the kernel takes them; and how often each signal was
    taken."""
    b, n = z.shape
    groups = b // geo.rows
    cols = n // geo.cluster
    out = np.zeros((2, groups, n), z.dtype)
    taken = np.zeros(b, int)
    for g in range(groups):
        for step in range(geo.steps):
            tiles = []
            for r in range(geo.cluster):
                k = step * geo.cluster + r
                nsig = _tile_sigs(geo, k)
                sig0 = g * geo.rows + k * geo.sigs
                s = np.full(geo.sigs * n, np.nan, z.dtype)    # the tile
                e = np.arange(nsig)[:, None] * n + np.arange(n)[None, :]
                s[_slot(e, c128)] = z[sig0:sig0 + nsig]
                taken[sig0:sig0 + nsig] += 1
                tiles.append((s, nsig, sig0))
            for rank in range(geo.cluster):
                c = rank * cols + np.arange(cols)
                for s, nsig, sig0 in tiles:                  # rank order
                    for q in range(nsig):
                        v = s[_slot(q * n + c, c128)]
                        out[0, g, c] += v
                        out[1, g, c] += (sig0 + q + 1) * v
    return out, taken


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,bs,t", [
    (8192, 1, 4),      # the timed shape: C = 4, one signal a CTA
    (8192, 1, 3),      # C = 4 over 3 tiles: one CTA idle
    (8192, 4, 4),      # 16 tiles, C = 8, two steps: running sums
    (8192, 2, 5),      # 10 tiles, C = 8: the second step has two
    (2048, 4, 8),      # 4 signals a tile
    (512, 4, 5),       # 16 signals a tile, C = 2, the last tile partial
    (64, 8, 16),       # one tile a group, C = 1
    (8, 2, 3),         # tiny: 6 signals in one tile
])
def test_owner_sums_take_every_signal_once_with_its_global_id(n, bs, t,
                                                             dtype, rng):
    c128 = dtype == "complex128"
    geo = _geo(n, dtype, bs, t)
    groups = 2
    b = groups * bs * t
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(dtype)
    stages = make_plan(n).stages[0]
    y, _, cs = abft_fft_plain(torch.from_numpy(x), stages, bs=bs,
                              transactions=t, per_signal=False)
    for side, z in ((0, x), (1, y.numpy())):
        got, taken = _kernel_sums(z, geo, c128)
        assert (taken == 1).all(), (side, taken)
        for j in range(2):
            want = cs[2 * side + j].numpy()
            err = np.abs(got[j] - want).max(-1)
            tol = ATOL[dtype] * np.abs(want).max(-1)
            assert (err <= tol).all(), (side, j, err / tol)


def _store_slots(n, sigs, vec):
    """{(signal, column): slot} that store_tile reads for y, rows layout:
    pairs of points of a row with 16-byte stores, else single points."""
    per = 2 if vec else 1
    q = np.arange(sigs * n // per)
    e = per * q
    j, p = e >> (n.bit_length() - 1), e & (n - 1)
    slots = {}
    for half in range(per):
        for jj, pp in zip(j, p + half):
            slots[(int(jj), int(pp))] = (jj * n + pp)
    return slots


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", SIZES)
def test_seu_lands_on_the_natural_row_and_column_of_y(n, dtype):
    c128 = dtype == "complex128"
    bs, t = 2, 4
    geo = _geo(n, dtype, bs, t)
    stores = _store_slots(n, geo.sigs, vec=not c128)
    for tile, row, col in ((0, 0, 0), (t - 1, bs - 1, n - 1),
                           (1, 1, n // 3)):
        sig = tile * bs + row                     # inside group 0
        hits = []
        for step in range(geo.steps):
            for rank in range(geo.cluster):
                k = step * geo.cluster + rank
                nsig = _tile_sigs(geo, k)
                sig0 = k * geo.sigs
                if sig0 <= sig < sig0 + nsig:
                    hits.append(_slot(((sig - sig0) * n) + col, c128))
                    local = sig - sig0
        assert len(hits) == 1
        assert hits[0] == _slot(stores[(local, col)], c128)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_owner_and_dot_reads_are_at_most_two_way_conflicted(dtype):
    c128 = dtype == "complex128"
    worst = {}
    for n in SIZES:
        log_n = n.bit_length() - 1
        for bs in BS:
            for t in TRANSACTIONS:
                geo = _geo(n, dtype, bs, t)
                cols = n // geo.cluster
                tid = np.arange(geo.threads)
                # owners: one instruction per (rank, c0, i, q); lanes on
                # consecutive columns
                own = OWN_COLS[dtype]
                for rank in range(geo.cluster):
                    for c0 in range(0, cols, own * geo.threads):
                        for i in range(own):
                            c = c0 + tid + i * geo.threads
                            for q in range(min(geo.sigs, 2)):
                                e = np.where(c < cols,
                                             _slot(q * n + rank * cols + c,
                                                   c128), -1)
                                key = (n, bs, t, "owner")
                                worst[key] = max(worst.get(key, 1),
                                                 _worst_degree(
                                                     e.reshape(-1, 32),
                                                     c128))
                # dot products: P lanes a signal, lane j at points j + P i
                qw, j, p, per_pass = _dot_lanes(geo)
                for q0 in range(0, geo.sigs, per_pass):
                    q = q0 + qw
                    for k0 in range(0, n, p):
                        k = j + k0
                        live = (q < geo.sigs) & (k < n)
                        e = np.where(live, _slot((q << log_n) + k, c128), -1)
                        key = (n, bs, t, "dot")
                        worst[key] = max(worst.get(key, 1),
                                         _worst_degree(e.reshape(-1, 32),
                                                       c128))
    bad = {k: v for k, v in worst.items() if v > 2}
    assert not bad, bad


@pytest.mark.parametrize("n", SIZES)
def test_dot_lanes_take_every_point_of_every_signal_once(n):
    log_n = n.bit_length() - 1
    for bs in BS:
        for t in TRANSACTIONS:
            geo = _geo(n, "complex64", bs, t)
            qw, j, p, per_pass = _dot_lanes(geo)
            seen = np.zeros(geo.sigs * n, int)
            for q0 in range(0, geo.sigs, per_pass):
                q = q0 + qw
                for k0 in range(0, n, p):
                    k = j + k0
                    live = (q < geo.sigs) & (k < n)
                    np.add.at(seen, ((q << log_n) + k)[live], 1)
            assert (seen == 1).all(), (n, bs, t, geo)
