"""Shared-memory bank conflicts of the block-FFT kernel's tile layout.

A copy of ``csrc/block_fft.cu``'s index maps in numpy: the XOR swizzle of
the tile's point index and, for every plan N <= 8192 and every pass layout
(rows, or the strided columns of a multi-pass), the tile positions each
warp instruction touches: the staging copies, every stage's in-place reads
and writes, and the last stage's natural-order stores. The kernel needs
each instruction to be at most 2-way bank conflicted: complex64 words are
8 bytes (16 banks of 8 bytes per half-warp), complex128 words 16 bytes
(8 banks of 16 bytes per quarter-warp). The unswizzled layout is checked
to be worse, so the test would see a swizzle that stopped working.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core.fft import make_plan

TILE = 8192          # points per CTA tile (kTile)
PTS = 16             # points per thread (kPts)


def _swizzle(e, c128):
    if c128:
        return e ^ (((e >> 3) ^ (e >> 6) ^ (e >> 9)) & 7)
    return e ^ (((e >> 4) ^ (e >> 8)) & 15)


def _natural_index(pos, log_rs):
    """natural_index(): the output point of in-place position ``pos``."""
    k = np.zeros_like(pos)
    wbits = sum(log_rs)
    for lr in reversed(log_rs):
        wbits -= lr
        k |= (pos & ((1 << lr) - 1)) << wbits
        pos = pos >> lr
    return k


def _patterns(n, rows, c128):
    """(name, (instructions, 32) array of tile positions, -1 where a lane
    is idle) for one CTA of a full tile of n-point signals."""
    sigs = TILE // n
    threads = max(32, TILE // PTS)
    log_n = n.bit_length() - 1
    t = np.arange(threads)
    out = []
    # staging copies: complex64 moves pairs (two 8-byte accesses each)
    per = 1 if c128 else 2
    items = TILE // per
    q = t[None, :] + threads * np.arange(-(-items // threads))[:, None]
    for half in range(per):
        if rows:
            e = per * q + half
        else:
            ls = sigs.bit_length() - 1 - (per - 1)
            j = ((q & ((1 << ls) - 1)) << (per - 1)) + half
            e = j * n + (q >> ls)
        out.append((f"staging{half}", np.where(q < items, e, -1)))
    log_rs = [st.radix.bit_length() - 1 for st in make_plan(n).stages[0]]
    log_ns = log_n
    for s, lr in enumerate(log_rs):
        log_m = log_ns - lr
        nbf = TILE >> lr
        i = t[None, :] + threads * np.arange(PTS >> lr)[:, None]
        base = ((i >> log_m) << log_ns) + (i & ((1 << log_m) - 1))
        live = i < nbf
        for j in range(1 << lr):
            e = np.where(live, base + (j << log_m), -1)
            out.append((f"stage{s}.{j}", e))
            if s == len(log_rs) - 1:
                lp = log_n - lr
                k = _natural_index(i & ((1 << lp) - 1), log_rs[:-1])
                nat = ((i >> lp) << log_n) | k | (j << lp)
                out.append((f"natural.{j}", np.where(live, nat, -1)))
        log_ns = log_m
    return [(name, e.reshape(-1, 32)) for name, e in out]


def _worst_degree(e, c128, swizzle=True):
    group, banks = (8, 8) if c128 else (16, 16)
    w = _swizzle(e, c128) if swizzle else e
    slots = np.where(e >= 0, w % banks, -1).reshape(-1, group)
    counts = (slots[..., None] == np.arange(banks)).sum(axis=1)
    return int(counts.max())


@pytest.mark.parametrize("c128", [False, True], ids=["complex64",
                                                      "complex128"])
def test_swizzle_keeps_every_access_at_most_two_way(c128):
    cases = [(1 << k, True) for k in range(1, 14)]
    # the strided (column) passes of 2- and 3-pass plans
    cases += [(f, False) for f in (128, 256, 512, 1024, 2048)]
    worst, plain = {}, 0
    for n, rows in cases:
        for name, e in _patterns(n, rows, c128):
            worst[(n, rows, name)] = _worst_degree(e, c128)
            plain = max(plain, _worst_degree(e, c128, swizzle=False))
    bad = {k: v for k, v in worst.items() if v > 2}
    assert not bad, bad
    assert plain >= 8          # the layout the swizzle replaces
