"""Index maps of the checked-GEMM kernel (``csrc/ft_matmul.cu``) on the CPU.

A copy of the kernel's maps in numpy: thread -> (rows, columns) of the
accumulator, the shared-memory ring (transposed X slice with padded rows, W
slice, xsum/xloc, then the strip reduction), and the 16-byte global loads
and ``cp.async`` copies of one K stage. For every CTA tile (128/64 x
128/64) and operand type it checks that each output element has exactly one
owner, that each stage is copied exactly once, that every 16-byte access is
aligned, that the shared-memory accesses are at most 2-way bank-conflicted
(the unpadded A layout is checked to be worse for float32 X), and that the
ring fits the dynamic shared memory the wrapper asks for. Also the
input-checksum pass's column map, the wrapper's CTA-tile choice and
``chip_smoke.py``'s reading of the ``-Xptxas -v`` build log.

Bank model: 32 banks of 4 bytes; an instruction of w-byte accesses runs in
phases of 128 / w lanes, and a phase takes as many wavefronts as the most
distinct 4-byte words any one bank holds among its addresses.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import ft_matmul as ftk

THREADS, GROUPS = 256, 16
TILES = [(128, 128), (128, 64), (64, 128), (64, 64)]
ITEMSIZE = {"float32": 4, "bfloat16": 2}
TYPES = [(x, w) for x in ITEMSIZE for w in ITEMSIZE]


def _lanes():
    """(rg, cg) of every thread: 4 x 2 warps, each 4 row groups x 8 column
    groups of lanes."""
    tid = np.arange(THREADS)
    lane, warp = tid & 31, tid >> 5
    return (warp >> 1) * 4 + (lane >> 3), (warp & 1) * 8 + (lane & 7)


def _offsets(t):
    """Offsets of a thread's T accumulator rows (or columns) from 4 rg."""
    i = np.arange(t)
    return 64 * (i // 4) + i % 4


class Layout:
    """Tile<BM, BN>: float offsets of one CTA's dynamic shared memory."""

    def __init__(self, bm, bn, pad=ftk.A_PAD):
        self.bm, self.bn = bm, bn
        self.a_stride = bm + pad
        self.a = ftk.STAGE * self.a_stride
        self.b = ftk.STAGE * bn
        self.stage = self.a + self.b + 2 * ftk.STAGE
        self.halves = bm // ftk.STRIP_ROWS
        self.red = 2 * self.halves * GROUPS * bn
        self.floats = max(ftk.STAGES * self.stage, self.red)


def _chunks(rows, row_elems, itemsize):
    """Stager: chunk idx -> (row, first element) for 16-byte chunks of a
    (rows, row_elems) slice, and the thread that copies each chunk."""
    per = 16 // itemsize
    per_row = row_elems // per
    idx = np.arange(rows * per_row)
    return idx // per_row, idx % per_row * per, idx % THREADS, idx // THREADS


def _degree(words, width):
    """Wavefronts per phase of one warp instruction: ``words`` is (32,) of
    4-byte word offsets (the first word of each access, -1 for an idle
    lane), each access ``width`` bytes."""
    per_phase = 128 // width
    worst = 0
    for ph in words.reshape(-1, per_phase):
        live = ph[ph >= 0]
        if live.size == 0:
            continue
        cover = np.unique((live[:, None] + np.arange(width // 4)).ravel())
        worst = max(worst, int(np.bincount(cover % 32).max()))
    return worst


def _warps(addr_by_tid):
    """(instructions, 32) from a (..., THREADS) array of addresses."""
    a = np.asarray(addr_by_tid).reshape(-1, THREADS)
    return a.reshape(-1, THREADS // 32, 32).reshape(-1, 32)


def _fragment_reads(lay):
    """Word offsets of every float4 fragment read of one stage: A at
    as[kk][4 rg + 64 h], B at bs[kk][4 cg + 64 h]."""
    rg, cg = _lanes()
    reads = []
    for kk in range(ftk.STAGE):
        for h in range(lay.bm // 64):
            reads.append(kk * lay.a_stride + 4 * rg + 64 * h)
        for h in range(lay.bn // 64):
            reads.append(lay.a + kk * lay.bn + 4 * cg + 64 * h)
    return np.array(reads)


def _x_stores(lay, xtype):
    """Word offsets of the transposed X stores (one instruction per stager
    iteration and element j): as[kk + j][r]; -1 for an idle thread."""
    r, kk, thread, it = _chunks(lay.bm, ftk.STAGE, ITEMSIZE[xtype])
    per = 16 // ITEMSIZE[xtype]
    out = np.full((it.max() + 1, per, THREADS), -1)
    for j in range(per):
        out[it, j, thread] = (kk + j) * lay.a_stride + r
    return out.reshape(-1, THREADS)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_every_output_element_has_one_owner(tile):
    bm, bn = tile
    rg, cg = _lanes()
    rows = 4 * rg[:, None] + _offsets(bm // GROUPS)[None, :]
    cols = 4 * cg[:, None] + _offsets(bn // GROUPS)[None, :]
    owners = np.zeros((bm, bn), int)
    for t in range(THREADS):
        np.add.at(owners, np.ix_(rows[t], cols[t]), 1)
    assert (owners == 1).all()
    # each thread's rows split into whole 4-row runs of single 64-row groups,
    # so a strip partial of 64 rows is 16 row groups x 4 rows
    group = rows // ftk.STRIP_ROWS
    assert (group.reshape(THREADS, -1, 4) ==
            group.reshape(THREADS, -1, 4)[..., :1]).all()


@pytest.mark.parametrize("xtype,wtype", TYPES)
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_stage_copies_cover_once_and_are_aligned(tile, xtype, wtype):
    bm, bn = tile
    lay = Layout(bm, bn)
    k, n = 3 * ftk.STAGE, 3 * bn          # smallest strides the kernel takes
    m0, n0, k0 = bm, bn, ftk.STAGE
    # X: (bm, 16) slice, 16 bytes a chunk, row stride K
    r, kk, thread, it = _chunks(bm, ftk.STAGE, ITEMSIZE[xtype])
    assert thread.size <= THREADS * (it.max() + 1)
    seen = np.zeros((bm, ftk.STAGE), int)
    per = 16 // ITEMSIZE[xtype]
    for j in range(per):
        np.add.at(seen, (r, kk + j), 1)
    assert (seen == 1).all()
    assert ((((m0 + r) * k + k0 + kk) * ITEMSIZE[xtype]) % 16 == 0).all()
    # W: (16, bn) slice, row stride N; cp.async into bs when float32, a
    # register copy and two float4 stores when bfloat16
    kw, j0, _, _ = _chunks(ftk.STAGE, bn, ITEMSIZE[wtype])
    seen = np.zeros((ftk.STAGE, bn), int)
    for j in range(16 // ITEMSIZE[wtype]):
        np.add.at(seen, (kw, j0 + j), 1)
    assert (seen == 1).all()
    assert ((((k0 + kw) * n + n0 + j0) * ITEMSIZE[wtype]) % 16 == 0).all()
    for s in range(ftk.STAGES):
        base = s * lay.stage
        dst = base + lay.a + kw * bn + j0
        assert (dst % 4 == 0).all()                     # 16-byte aligned
        # xsum, xloc: 8 chunks of 4 floats
        xs = base + lay.a + lay.b + 4 * np.arange(8)
        assert (xs % 4 == 0).all() and base % 4 == 0


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_fragment_reads_aligned_and_at_most_two_way(tile):
    lay = Layout(*tile)
    reads = _fragment_reads(lay)
    assert (reads % 4 == 0).all()
    worst = max(_degree(w, 16) for w in _warps(reads))
    assert worst <= 2, worst
    # a k step: (bm + bn) / 64 float4 reads for (bm / 16) x (bn / 16) FMAs
    assert len(reads) == ftk.STAGE * (tile[0] + tile[1]) // 64


@pytest.mark.parametrize("xtype", list(ITEMSIZE))
@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_transposed_x_stores_at_most_two_way(tile, xtype):
    worst = max(_degree(w, 4)
                for w in _warps(_x_stores(Layout(*tile), xtype)))
    assert worst <= 2, worst
    plain = max(_degree(w, 4)
                for w in _warps(_x_stores(Layout(*tile, pad=0), xtype)))
    # float32 rows of 4 chunks: unpadded, 4 lanes share a bank; bfloat16
    # rows of 2 chunks are 2-way either way
    assert plain == (4 if xtype == "float32" else 2)


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_other_shared_accesses_at_most_two_way(tile):
    bm, bn = tile
    lay = Layout(bm, bn)
    rg, cg = _lanes()
    tid = np.arange(THREADS)
    # bf16 W: two float4 stores per 8-element chunk
    kw, j0, thread, it = _chunks(ftk.STAGE, bn, 2)
    for half in (0, 4):
        words = np.full((it.max() + 1, THREADS), -1)
        words[it, thread] = lay.a + kw * bn + j0 + half
        assert max(_degree(w, 16) for w in _warps(words)) <= 2
    # pred2/pred3: xs[kk] (broadcast) and bs[kk][pcol], threads < 2 bn
    pcol = np.where(tid < bn, tid, tid - bn)
    live = tid < 2 * bn
    for kk in range(ftk.STAGE):
        words = np.where(live, lay.a + kk * bn + pcol, -1)
        assert max(_degree(w, 4) for w in _warps(words)) <= 2
    # strip reduction: float4 stores red[strip][half][rg][4 cg + 64 h], then
    # scalar reads of the 16 row groups of one column
    for strip in range(2):
        for hm in range(lay.halves):
            for h in range(bn // 64):
                words = (((strip * lay.halves + hm) * GROUPS + rg) * bn
                         + 4 * cg + 64 * h)
                assert (words % 4 == 0).all()
                assert max(_degree(w, 16) for w in _warps(words)) <= 1
    for start in range(0, 2 * lay.halves * bn, THREADS):
        idx = start + tid
        col, sh = idx % bn, idx // bn
        for g in range(GROUPS):
            words = np.where(idx < 2 * lay.halves * bn,
                             (sh * GROUPS + g) * bn + col, -1)
            assert max(_degree(w, 4) for w in _warps(words)) <= 1


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_ring_fits_the_requested_shared_memory(tile):
    bm, bn = tile
    lay = Layout(bm, bn)
    assert ftk.smem_bytes(bm, bn) == 4 * lay.floats
    last = []
    for s in range(ftk.STAGES):
        base = s * lay.stage
        last += [base + _x_stores(lay, x).max() + 1 for x in ITEMSIZE]
        last.append(base + _fragment_reads(lay).max() + 4)
        last.append(base + lay.a + lay.b + 2 * ftk.STAGE)   # xsum, xloc
    last.append(lay.red)
    assert max(last) <= lay.floats
    # the stage's parts do not overlap: A rows end before B, B before xs
    assert _x_stores(lay, "float32").max() < lay.a
    assert (_fragment_reads(lay)[_fragment_reads(lay) < lay.a] + 4
            <= lay.a).all()
    # two CTAs (and the 1 KB each reserves) fit the SM's 228 KB
    assert 2 * (ftk.smem_bytes(bm, bn) + 1024) <= 228 * 1024


@pytest.mark.parametrize("xtype", list(ITEMSIZE))
@pytest.mark.parametrize("k", [16, 48, 3072, 8192])
def test_input_checksum_pass_covers_x_once_aligned(k, xtype):
    """x_checksums: CTA (bx, g), thread t reads 4 columns 4 (256 bx + t)
    of the 64 rows of group g, as one 16-byte (float32) or 8-byte
    (bfloat16) load a row."""
    blocks = -(-(k // 4) // THREADS)
    col = 4 * (np.arange(blocks)[:, None] * THREADS + np.arange(THREADS))
    col = col[col < k]
    seen = np.zeros(k, int)
    for j in range(4):
        np.add.at(seen, col + j, 1)
    assert (seen == 1).all()
    width = 4 * ITEMSIZE[xtype]
    rows = np.arange(3 * ftk.STRIP_ROWS)[:, None]
    assert (((rows * k + col) * ITEMSIZE[xtype]) % width == 0).all()


def test_cta_tile_fills_the_last_wave():
    slots = lambda tm, tn: 132 * 2            # noqa: E731 - 2 CTAs a SM
    # gate/up (2048 x 8192): 1024 CTAs of 128 x 128 are 3.9 waves: kept
    assert ftk.cta_tile(2048, 8192, 128, 128, slots) == (128, 128)
    # down (2048 x 3072): 384 are 1.45 waves; 768 of 128 x 64 are 2.9
    assert ftk.cta_tile(2048, 3072, 128, 128, slots) == (128, 64)
    # only tiles that divide the dims; bm = 64 allows 128 when M does
    assert ftk.cta_tile(192, 8192, 64, 128, slots)[0] == 64
    assert ftk.cta_tile(4096, 8192, 64, 64, slots) == (128, 128)
    with pytest.raises(ValueError, match="not aligned"):
        ftk.cta_tile(100, 128, 64, 64, slots)


@pytest.mark.parametrize("small_blocks", [3, 4])
def test_cta_tile_weighs_small_tiles_by_their_loads(small_blocks):
    # 64 x 64 at 3 (or 4) CTAs a SM against 2 for the others: by waves x
    # slots x area alone it ties 128 x 64 at the down projection (4 x 396 x
    # 4096 = 3 x 264 x 8192), though it runs about 25% slower per output
    def slots(tm, tn):
        return 132 * (small_blocks if tm == tn == 64 else 2)
    assert ftk.cta_tile(2048, 8192, 128, 128, slots) == (128, 128)
    assert ftk.cta_tile(2048, 3072, 128, 128, slots) == (128, 64)
    # the gate/up projection at twice the tokens: 4096 x 8192 is 7.8 waves
    # of 128 x 128 and, at 3 a SM, 5.2 of 64 x 64, which area alone takes
    assert ftk.cta_tile(4096, 8192, 128, 128, slots) == (128, 128)
    # where 64 x 64 is the only tile that divides, it runs
    assert ftk.cta_tile(192, 192, 64, 64, slots) == (64, 64)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4ftmm12strip_reduceEPKfS1_iiPfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN4ftmm12strip_reduceEPKfS1_iiPfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 16 registers, used 0 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4ftmm14ft_matmul_tileI13__nv_bfloat16fLi128ELi64EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN4ftmm14ft_matmul_tileI13__nv_bfloat16fLi128ELi64EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4ftmm14ft_matmul_tileIffLi64ELi64EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN4ftmm14ft_matmul_tileIffLi64ELi64EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4ftmm14ft_matmul_tileI13__nv_bfloat16S1_Li64ELi128EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN4ftmm14ft_matmul_tileI13__nv_bfloat16S1_Li64ELi128EEEvPKT_PKT0_PKfS8_S8_iPS2_PfSA_SA_SA_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 100 registers, used 1 barriers, 400 bytes cmem[0]
"""


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_report_reads_each_instance():
    rows = _chip_smoke().ft_matmul_ptxas(PTXAS_LOG)
    assert rows == [
        {"x": "bfloat16", "w": "bfloat16", "tile": [64, 128], "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 100},
        {"x": "bfloat16", "w": "float32", "tile": [128, 64], "stack": 8,
         "spill_stores": 4, "spill_loads": 4, "registers": 128},
        {"x": "float32", "w": "float32", "tile": [64, 64], "stack": 0,
         "spill_stores": 0, "spill_loads": 0, "registers": 72}]
