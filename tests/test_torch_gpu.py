"""Card-only tests of the port's CUDA kernels against their plain versions.

Marked ``gpu``; a fixture skips them where no CUDA device is present. They
import neither JAX nor ``repro``, and they take their data from their own
seeded helpers, so on a machine without JAX they run without the suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11
complex128); the kernel and its plain version sum in different orders. The
fused kernel's checksums are held row by row (each part, each group), and
its per-signal divergence elementwise (see ``_check_abft``); two calls
are bitwise equal, and its fast build instances have no spills. The GEMM
kernel ``ft_matmul``: bitwise on integer-valued operands (every sum exact);
on random ones each float32 part to 1e-4 * its max (float32 sums of up to
K = 8192 terms in another order than cuBLAS's: sqrt(K) * 2^-24 is about
5e-6), a bfloat16 ``c`` to one bf16 step, 2^-7 * max|c| — the tolerances
of ``chip_smoke.py``. Its outputs are bitwise the same whichever CTA tile
runs, and its build has no spills and two CTAs a SM at float32 128 x 128.
"""
import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import gemm
from repro_torch.core.fft import FFTSpec, FTConfig, make_plan, plan
from repro_torch.core.fft.plan import pass_layouts, plan_from_reference
from repro_torch.kernels import ops
from repro_torch.kernels import ft_matmul as ftk
from repro_torch.kernels.ft_matmul import ft_matmul, ft_matmul_plain
from repro_torch.kernels.stockham import (block_fft, block_fft_plain,
                                          pass_twiddle_table, stage_tables)
from repro_torch.kernels.stockham_abft import abft_fft, abft_fft_plain
from repro_torch.kernels.trace_age import PRIMER, prime

pytestmark = pytest.mark.gpu

_REPO = Path(__file__).resolve().parents[1]

ATOL = {torch.complex64: 4e-5, torch.complex128: 1e-11,
        torch.float32: 4e-5, torch.float64: 1e-11}
DTYPES = [torch.complex64, torch.complex128]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(b, n, dtype, seed=0):
    rng = np.random.default_rng(seed + 7 * b + n)
    x = rng.standard_normal((b, n)) + 1j * rng.standard_normal((b, n))
    return torch.from_numpy(x).to(dtype)


def _close(got, want, factor=1.0):
    got, want = got.cpu(), want.cpu()
    tol = factor * ATOL[want.dtype] * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 16, 128, 1024, 8192])
def test_block_fft_kernel_matches_plain(cuda, n, inverse, dtype):
    b = 37                                # ragged against any CTA tile
    x = _rand(b, n, dtype).to(cuda)
    stages = make_plan(n).stages[0]
    scale = 1.0 / n if inverse else 1.0
    before = block_fft.launches
    got = block_fft(x, stages, inverse=inverse, scale=scale)
    assert block_fft.launches == before + 1
    _close(got, block_fft_plain(x, stages, inverse=inverse, scale=scale))


@pytest.mark.parametrize("radices,n", [((128, 8), 1024), ((128, 64), 8192),
                                       ((2,) * 7, 128)])
def test_block_fft_kernel_on_reference_stages(cuda, radices, n):
    """The kernel runs the reference plan's own stages (radix 128 included)."""
    p = plan_from_reference(n, (n,), (radices,), 8)
    x = _rand(16, n, torch.complex64).to(cuda)
    _close(block_fft(x, p.stages[0]), torch.fft.fft(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1 << 14, 1 << 17, 1 << 23])
def test_plan_multipass_matches_torch_fft(cuda, n, dtype):
    x = _rand(2, n, dtype).to(cuda)
    p = plan(FFTSpec(shape=(2, n), dtype=str(dtype).split(".")[1]))
    assert all(t.is_cuda and t.dtype == dtype
               for tabs in p.tables.values() for t in tabs)
    _close(p.fft(x), torch.fft.fft(x))
    _close(p.ifft(x), torch.fft.ifft(x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << 14, 1 << 17, 1 << 20, 1 << 23])
def test_block_fft_kernel_matches_plain_in_every_pass_layout(cuda, n, inverse,
                                                             dtype):
    """Each pass's launch in its real layout, with its pass twiddle (all but
    the last pass), against the plain version on the same input; the middle
    pass of three also in place, as the transform runs it."""
    b = 2
    p = make_plan(n)
    facs = p.kernel_factors
    x = _rand(b, n, dtype).to(cuda)
    for i, layout in enumerate(pass_layouts(b, facs)):
        last = i == len(facs) - 1
        tw = None if last else pass_twiddle_table(
            math.prod(facs[i:]), dtype, inverse=inverse, device=cuda)
        kw = dict(inverse=inverse, scale=0.5 if i == 0 else 1.0,
                  layout=layout, twiddle=tw)
        want = block_fft_plain(x, p.stages[i], out=torch.zeros_like(x), **kw)
        got = block_fft(x, p.stages[i], out=torch.zeros_like(x), **kw)
        _close(got, want)
        if 0 < i < len(facs) - 1:
            inplace = x.clone()
            block_fft(inplace, p.stages[i], out=inplace, **kw)
            _close(inplace, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("mid_step", [0, 1024])
def test_block_fft_global_column_twiddle_matches_plain(cuda, inverse, dtype,
                                                       mid_step):
    """One launch with the pass twiddle of a shard's global columns, as
    the sharded transform's pass 1 takes it (M the whole N = 2^20, the
    index offset of shard 3 of 4; with ``mid_step``, the step of the
    TRANSPOSED_IN inverse's first pass), against the plain version on the
    same card tensors. Both read strided columns and write the
    all-to-all's (D, N1/D, rows, N2/D) order."""
    from repro_torch.core.fft.plan import PassLayout

    n, n1, shards, rows = 1 << 20, 1024, 4, 4
    n2l = n // n1 // shards
    x = _rand(rows, n, dtype).to(cuda)
    layout = PassLayout(((rows, n, n2l), (n2l, 1, 1)), n // n1, rows * n2l)
    tw = pass_twiddle_table(n, dtype, inverse=inverse, device=cuda)
    kw = dict(inverse=inverse, layout=layout, twiddle=tw, m=n,
              offset=3 * n2l, mid_step=mid_step,
              scale=1.0 / n if inverse else 1.0)
    stages = make_plan(n1).stages[0]
    src = x.view(-1)[3 * n2l:]
    want = block_fft_plain(src, stages,
                           out=torch.zeros(n1 * rows * n2l, dtype=dtype,
                                           device=cuda), **kw)
    got = block_fft(src, stages,
                    out=torch.zeros(n1 * rows * n2l, dtype=dtype,
                                    device=cuda), **kw)
    _close(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln,batch", [(20, 8), (23, 2)])
def test_fft_on_shards_on_card_matches_torch_fft(cuda, ln, batch, dtype):
    """The mesh pipelines of 4 shards in one process (threads, the
    exchange a tensor permute; ``torch_shards``): natural and transposed
    forward, the TRANSPOSED_IN inverse (N = 2^23: a two-pass tail) and
    ``chunks=2`` bitwise, against torch.fft."""
    from repro_torch.core.fft.distributed import make_dist_plan
    from torch_shards import fft_on_shards

    n = 1 << ln
    x = _rand(batch, n, dtype).to(cuda)
    ref = torch.fft.fft(x)
    _close(fft_on_shards(x, 4), ref)
    p = make_dist_plan(n, 4)
    yt = fft_on_shards(x, 4, natural_order=False)
    _close(yt.view(batch, p.n1, p.n2).transpose(1, 2).reshape(batch, n), ref)
    back = fft_on_shards(yt, 4, inverse=True, natural_order=False)
    _close(back, x)
    assert torch.equal(fft_on_shards(yt, 4, inverse=True,
                                     natural_order=False, chunks=2), back)


@pytest.mark.parametrize("dtype,ln,batch", [(torch.complex64, 25, 8),
                                            (torch.complex128, 20, 16)])
def test_pencil_launches_match_plain(cuda, dtype, ln, batch):
    """Every launch of shard 3 of 4 at the sharded path's shapes, the
    kernel against its plain version on the same card tensors: pass 1 in
    each direction (the twiddle of the shard's global columns), pass A of
    the TRANSPOSED_IN inverse (at 2^25, N2 = 65536: two launches, the
    first with the middle-axis step, the second reading the first's
    output) and pass B."""
    from repro_torch.core.fft import distributed as sd
    from repro_torch.kernels.stockham import device_key

    n, shards, d = 1 << ln, 4, 3
    p = sd.Pencil(n, shards, dtype, device_key(cuda))
    gen = torch.Generator(device=cuda).manual_seed(ln)
    x = torch.randn((batch, n), dtype=dtype, device=cuda, generator=gen)

    def both(launch, src, shape):
        got = launch(src, torch.zeros(shape, dtype=dtype, device=cuda))
        want = launch(src, torch.zeros(shape, dtype=dtype, device=cuda),
                      plain=True)
        _close(got, want)
        return got

    src = sd.Source(x.view(-1), d * p.n2l, n, p.n2)
    for inverse in (False, True):
        both(p.pass1_launch(src, batch, d, inverse=inverse),
             src.flat[src.base:], (shards, p.n1l, batch, p.n2l))
    # pass A reads this shard's k1 block of each transposed-order row
    row_len, w = p.n1l * p.n2, batch // shards
    y = x.view(batch, shards, row_len)[:, d].contiguous().view(-1)
    launches = p.pass_a_launches(shards, w * row_len, w, row_len, d)
    assert len(launches) == p.ax2.plan.num_passes == (2 if ln == 25 else 1)
    for launch in launches:
        y = both(launch, y, (shards, w, p.n1l, p.n2))
    both(p.pass_b_launch(w), x[:w].contiguous().view(w, p.n1, p.n2),
         (w, p.n1, p.n2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_on_shards_on_card_fault_matrix(cuda, dtype):
    """The sharded ABFT's loop on 4 shards in one process (threads,
    ``torch_shards.ft_on_shards``) at 2^14 x 8, G = 4: the catalogue's
    four-SEU case corrected (natural and transposed order, chunks=2
    bitwise), its double hit uncorrectable and then recomputed, a clean
    run unflagged; y against torch.fft."""
    from repro_torch.core.fft.distributed import make_dist_plan
    from torch_shards import (FT_SCENARIOS, INJ2, INJ4, expected_verdicts,
                              ft_on_shards, inject_rows, telemetry)

    n = 1 << 14
    sp = make_dist_plan(n, 4)
    name = str(dtype).split(".")[1]
    x = _rand(8, n, dtype, 5).to(cuda)
    ref = torch.fft.fft(x).cpu().numpy()
    thr = FT_SCENARIOS["threshold"][name]
    mag = FT_SCENARIOS["mag"][name]
    tol = ATOL[dtype]
    runs = {}
    for case, inj, kw in (("clean", None, {}), ("four", INJ4, {}),
                          ("four_t", INJ4, dict(natural_order=False)),
                          ("four_t_c2", INJ4, dict(natural_order=False,
                                                   chunks=2)),
                          ("double", INJ2, {}),
                          ("recompute", INJ2, dict(recompute=True))):
        res = ft_on_shards(x, 4, groups=4, threshold=thr,
                           inject=inject_rows(inj, mag), **kw)
        y = res.y
        if not kw.get("natural_order", True):     # back to natural order
            y = y.view(8, sp.n1, sp.n2).transpose(1, 2).reshape(8, n)
        expected_verdicts(case, telemetry(res), y.cpu().numpy(), ref, tol)
        runs[case] = res
    assert torch.equal(runs["four_t_c2"].y, runs["four_t"].y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln,rows,groups", [(20, 64, 4), (4, 3, 1)],
                         ids=["2^20", "2^4-odd-offset"])
def test_checksum_row_launch_at_its_offset_matches_plain(cuda, dtype, ln,
                                                         rows, groups):
    """Pass 1 of a transaction's 2G checksum rows, the second launch into
    the send buffer, at row offset ``rows`` (shard 3 of 4), against its
    plain version on the same card tensors: the data rows' part of the
    buffer untouched. At 2^4 the offset is 3 points (24 bytes at
    complex64), so the launch must leave its 16-byte stores."""
    from repro_torch.core.fft import distributed as sd
    from repro_torch.kernels.stockham import device_key

    n, shards, d = 1 << ln, 4, 3
    p = sd.Pencil(n, shards, dtype, device_key(cuda))
    nrow = rows + 2 * groups
    gen = torch.Generator(device=cuda).manual_seed(ln)
    cs = torch.randn((2 * groups, p.n1, p.n2l), dtype=dtype, device=cuda,
                     generator=gen)
    src = sd.Source(cs.view(-1), 0, p.n1 * p.n2l, p.n2l)
    got, want = (torch.zeros((shards, p.n1l, nrow, p.n2l), dtype=dtype,
                             device=cuda) for _ in range(2))
    launch = p.pass1_launch(src, 2 * groups, d, inverse=False,
                            out_rows=nrow)
    off = rows * p.n2l
    if ln == 4 and dtype == torch.complex64:
        assert got.view(-1)[off:].data_ptr() % 16 != 0
    launch(cs.view(-1), got.view(-1)[off:])
    launch(cs.view(-1), want.view(-1)[off:], plain=True)
    assert not got[:, :, :rows].any()
    _close(got, want)


class _HeldToPlain:
    """Runs every ``block_fft`` launch (``stockham`` and ``ops`` take it by
    name) on the card and, on clones of its operands, on the plain
    version, keeping the largest error over ``ATOL * max|plain|``; the
    threads of ``torch_shards`` launch concurrently, so the record takes
    a lock."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import ops, stockham

        kernel = stockham.block_fft
        self.worst, self.launches = 0.0, 0
        lock = threading.Lock()

        def checked(x, stages, *, out=None, tables=None, **kw):
            x0 = x.clone()
            o0 = None if out is None else (
                x0 if out.data_ptr() == x.data_ptr() else out.clone())
            got = kernel(x, stages, out=out, tables=tables, **kw)
            want = block_fft_plain(x0, stages, out=o0, **kw)
            err = ((got - want).abs().max() / (
                ATOL[want.dtype] * want.abs().max() + 1e-30)).item()
            with lock:
                self.worst = max(self.worst, err)
                self.launches += 1
            return got

        checked.launches = 0         # the kernel counts its launches here
        monkeypatch.setattr(stockham, "block_fft", checked)
        monkeypatch.setattr(ops, "block_fft", checked)


@pytest.mark.parametrize("d,dd", [(4, 1), (2, 2)])
def test_nd_on_shards_on_card_launches_match_plain(cuda, monkeypatch, d, dd):
    """The slab (rank 2 and 3), pencil (natural, transposed with chunks=2,
    TRANSPOSED_IN), real slab and convolution loops of a data x fft grid
    of threads on the card (``torch_shards.grid_on_shards``), every launch
    held to ``block_fft_plain`` on the same card tensors, the results to
    torch.fft."""
    from repro_torch.core.fft import multidim as md
    from torch_shards import grid_on_shards

    held = _HeldToPlain(monkeypatch)
    gen = torch.Generator(device=cuda).manual_seed(d)
    for shape, nd in (((4, 512, 1024), 2), ((2, 64, 128, 256), 3)):
        x = torch.randn(shape, dtype=torch.complex64, device=cuda,
                        generator=gen)
        axes = tuple(ops.axis_fft(n, x.dtype, cuda) for n in shape[-nd:])
        ref = torch.fft.fftn(x, dim=tuple(range(-nd, 0)))
        y = grid_on_shards(lambda r, m: md.slab_local(x, axes, m,
                                                      inverse=False), d, dd)
        _close(y, ref)
        _close(grid_on_shards(lambda r, m: md.slab_local(
            y, axes, m, inverse=True), d, dd), x, factor=2)
        gp = md.GridPencil(shape[-nd:], d, dd, x.dtype, str(cuda))
        _close(grid_on_shards(lambda r, m: md.pencil_local(
            x, gp, m, inverse=False, natural_order=True, chunks=1), d, dd),
            ref)
        yt = grid_on_shards(lambda r, m: md.pencil_local(
            x, gp, m, inverse=False, natural_order=False, chunks=2), d, dd)
        xi = grid_on_shards(lambda r, m: md.pencil_local(
            yt, gp, m, inverse=True, natural_order=False, chunks=2), d, dd)
        _close(xi.reshape(shape), x, factor=2)
    xr = torch.randn((4, 512, 1024), dtype=torch.float32, device=cuda,
                     generator=gen)
    rows, half = (ops.axis_fft(n, torch.complex64, cuda) for n in (512, 512))
    yr = grid_on_shards(lambda r, m: md.rslab_local(
        xr, rows, half, m, inverse=False, cc=1024), d, dd)
    _close(yr, torch.fft.rfft2(xr))
    _close(grid_on_shards(lambda r, m: md.rslab_local(
        yr, rows, half, m, inverse=True, cc=1024), d, dd), xr, factor=2)
    a = torch.randn((4, 200, 240), dtype=torch.float32, device=cuda,
                    generator=gen)
    v = torch.randn((33, 33), dtype=torch.float32, device=cuda, generator=gen)
    nr, nc = md._conv2_shape((200, 240), (33, 33), d)
    axes = (ops.axis_fft(nr, torch.complex64, cuda),
            ops.axis_fft(nc // 2, torch.complex64, cuda))
    got = grid_on_shards(lambda r, m: md.conv2_local(
        md._pad2(a, nr, nc), md._pad2(v, nr, nc), axes, m, sa=(200, 240),
        sv=(33, 33), mode="same", real=True), d, dd)
    s = (232, 272)
    full = torch.fft.ifft2(torch.fft.fft2(a, s=s) * torch.fft.fft2(v, s=s))
    _close(got, full.real[:, 16:216, 16:256])
    assert held.launches > 0 and held.worst <= 1.0, held.worst


@pytest.mark.parametrize("real", [False, True], ids=["c2c", "real"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ft2_on_shards_on_card_fault_matrix(cuda, dtype, real):
    """The 2-D grouped ABFT's loop on 2 x 2 threads at (8, 1024, 2048), G =
    4: clean unflagged, four SEUs corrected, the double hit
    uncorrectable and then recomputed, a cs2 grid hit classified; y
    against torch.fft."""
    from torch_shards import FT2_SCENARIOS, INJ2, INJ4, ft2_on_shards

    name = str(dtype).split(".")[1]
    thr = FT2_SCENARIOS["threshold"][name]
    mag = FT2_SCENARIOS["mag"][name]
    gen = torch.Generator(device=cuda).manual_seed(3)
    if real:
        x = torch.randn((8, 1024, 2048), device=cuda, generator=gen,
                        dtype=torch.float64 if dtype == torch.complex128
                        else torch.float32)
        ref = torch.fft.rfft2(x)
    else:
        x = torch.randn((8, 1024, 2048), dtype=dtype, device=cuda,
                        generator=gen)
        ref = torch.fft.fft2(x)
    # eps sized for the grid: the score is |eps| / (sqrt(C) sqrt(s R C)),
    # the catalogue's at 32 x 64
    scale = mag * (2048 / 64 * 1024 * 2048 / (32 * 64)) ** 0.5
    tol = ATOL[dtype]

    def rows(inj):
        return [r[:5] + [r[5] * scale, r[6] * scale] for r in inj]

    def err(res):
        return ((res.y - ref).abs().max() / ref.abs().max()).item()

    kw = dict(groups=4, threshold=thr, real=real)
    clean = ft2_on_shards(x, 2, 2, **kw)
    assert not clean.flagged.any() and err(clean) < tol
    four = ft2_on_shards(x, 2, 2, inject=rows(INJ4), **kw)
    assert four.correctable.all() and four.location.tolist() == [1, 2, 5, 6]
    assert err(four) < tol
    dbl = ft2_on_shards(x, 2, 2, inject=rows(INJ2), **kw)
    assert dbl.uncorrectable.tolist() == [False, False, True, False]
    fixed = ft2_on_shards(x, 2, 2, inject=rows(INJ2), recompute=True, **kw)
    assert int(fixed.recomputed) == 1 and err(fixed) < tol
    cs2 = ft2_on_shards(x, 2, 2, inject=rows([[1, 9, 4, 2, 1, 1.0, -1.0]]),
                        **kw)
    assert cs2.checksum_fault.tolist() == [False, True, False, False]
    assert err(cs2) < tol


@pytest.mark.parametrize("dtype", DTYPES)
def test_slab_checksum_grid_launch_at_its_row_offset_matches_plain(cuda,
                                                                    dtype):
    """Pass 1 of the 2-D ABFT's 2G checksum grids, the second launch into
    the pass-1 buffer at row offset bl (one rank's R/4 rows of 8 grids of
    (1024, 2048), G = 4), against its plain version on the same card
    tensors: the data rows untouched."""
    from repro_torch.core.fft import multidim as md

    bl, gl, rl, cc = 8, 4, 256, 2048
    ax = ops.axis_fft(cc, dtype, cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    cs = torch.randn((2 * gl, rl, cc), dtype=dtype, device=cuda,
                     generator=gen)
    got, want = (torch.zeros((bl + 2 * gl, rl, cc), dtype=dtype, device=cuda)
                 for _ in range(2))
    md._last_axis(cs, ax, got[bl:], inverse=False)
    want[bl:] = block_fft_plain(cs.view(-1, cc), ax.plan.stages[0]).view(
        cs.shape)
    assert not got[:bl].any()
    _close(got, want)


def test_plan_fft_launches_one_kernel_per_pass(cuda):
    """Under torch.profiler, one plan.fft call at 2^20 runs exactly two CUDA
    kernels, both block_fft: nothing else touches the data."""
    n = 1 << 20
    x = _rand(4, n, torch.complex64).to(cuda)
    p = plan(FFTSpec(shape=(4, n)))
    p.fft(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):      # the tracer can drop an event, never add one
        with torch.profiler.profile(activities=acts) as prof:
            prime()         # late in a process the tracer drops a head
            p.fft(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and PRIMER not in e.name]
        if len(names) == 2:
            break
    assert len(names) == 2 and all("block_fft" in nm for nm in names), names


def test_stage_tables_uploaded_once(cuda):
    stages = make_plan(1024).stages[0]
    t1 = stage_tables(stages, torch.complex64, device="cuda")
    t2 = stage_tables(stages, torch.complex64, device=cuda)
    assert t1 is t2 and t1.is_cuda


def _check_abft(got, want, noise):
    """y to ATOL * max|y|. Each checksum row [X.e2, X.e3, Y.e2, Y.e3] of
    each group to ATOL * its own max: the e3 rows grow with the 1-based
    signal id, so one tolerance over all of them would hide a wrong small
    row. delta elementwise to 1e-3 relative (the injected signal's
    divergence is large) plus ``noise``, the roundoff scale of clean
    signals."""
    (y, delta, cs), (yp, dp, csp) = [[t.cpu() for t in w] for w in (got, want)]
    _close(y, yp)
    for j, part in enumerate(("X.e2", "X.e3", "Y.e2", "Y.e3")):
        err = (cs[j] - csp[j]).abs().amax(-1)
        tol = ATOL[csp.dtype] * csp[j].abs().amax(-1)
        assert (err <= tol).all(), (part, (err / tol).max().item())
    err = (delta - dp).abs()
    tol = 1e-3 * dp.abs() + noise
    assert (err <= tol).all(), ("delta", (err / tol).max().item())


def _delta_noise(delta_clean):
    """4x the plain version's largest clean divergence (the dtype's epsilon
    when it is all zeros, without per-signal checksums)."""
    eps = torch.finfo(delta_clean.dtype).eps
    return 4.0 * max(delta_clean.abs().max().item(), eps)


# (bs, T): T in {1, 3, 4, 8, 16}, bs in {1, 2, 4}; at N = 8192 (bs, T) =
# (4, 8) is 32 tiles on a cluster of 8 (4 tiles a CTA, running sums in
# shared memory) and (1, 3), (2, 3) are 3 and 6 tiles on 4 and 8 CTAs
ABFT_GROUPS = [(1, 1), (1, 3), (2, 3), (1, 4), (4, 4), (4, 8), (1, 16),
               (2, 16)]


@pytest.mark.parametrize("per_signal", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [8, 64, 512, 2048, 4096, 8192])
def test_abft_kernel_matches_plain(cuda, n, dtype, per_signal):
    """Two groups of each (bs, T), clean, then the SEU in the first tile at
    column 0 and in the last tile at column N - 1."""
    stages = make_plan(n).stages[0]
    for bs, t in ABFT_GROUPS:
        b = 2 * bs * t
        x = _rand(b, n, dtype, seed=bs * t).to(cuda)
        noise = None
        for inject in (None, [0, 0, 0, 1, 25.0, -40.0],
                       [b // bs - 1, bs - 1, n - 1, 1, -30.0, 15.0]):
            inj = None if inject is None else torch.tensor(inject)
            kw = dict(bs=bs, transactions=t, per_signal=per_signal,
                      inject=inj)
            before = abft_fft.launches
            got = abft_fft(x, stages, **kw)
            assert abft_fft.launches == before + 1
            want = abft_fft_plain(x, stages, **kw)
            if noise is None:                     # the clean call first
                noise = _delta_noise(want[1])
            _check_abft(got, want, noise)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,bs,t", [(8192, 1, 4), (8192, 4, 8), (256, 2, 3)])
def test_abft_kernel_is_bitwise_repeatable(cuda, n, bs, t, dtype):
    x = _rand(4 * bs * t, n, dtype).to(cuda)
    stages = make_plan(n).stages[0]
    inj = torch.tensor([1, bs - 1, n // 5, 1, 9.0, 2.0])
    a = abft_fft(x, stages, bs=bs, transactions=t, inject=inj)
    b = abft_fft(x, stages, bs=bs, transactions=t, inject=inj)
    for part, u, v in zip(("y", "delta", "cs"), a, b):
        assert torch.equal(u, v), part


@pytest.mark.parametrize("radices,n", [((128, 8), 1024), ((128, 64), 8192),
                                       ((2,) * 7, 128)])
def test_abft_kernel_on_reference_stages(cuda, radices, n):
    """The reference plan's stages (radix 128 included) run the generic
    instance with the same checksum machinery."""
    stages = plan_from_reference(n, (n,), (radices,), 8).stages[0]
    for dtype in DTYPES:
        x = _rand(24, n, dtype).to(cuda)
        inj = torch.tensor([2, 1, n - 1, 1, 25.0, -40.0])
        for per_signal in (False, True):
            kw = dict(bs=2, transactions=3, per_signal=per_signal)
            clean = abft_fft_plain(x, stages, **kw)
            got = abft_fft(x, stages, inject=inj, **kw)
            want = abft_fft_plain(x, stages, inject=inj, **kw)
            _check_abft(got, want, _delta_noise(clean[1]))


# one kernel function at two dynamic shared memory sizes above 48 KB:
# block_fft at complex128 N = 8192 (128 KiB) and N = 4096 one row (64 KiB);
# abft_fft at complex64 N = 8192, bs = 16 (a cluster of 8, two tile steps:
# 98448 bytes) and bs = 1 (65680 bytes)
_TWO_SIZES = {"block_fft": (torch.complex128, [(4, 8192, 0), (1, 4096, 0)]),
              "abft_fft": (torch.complex64, [(16, 8192, 16), (1, 8192, 1)])}


@pytest.mark.parametrize("kernel", sorted(_TWO_SIZES))
def test_two_threads_launch_one_kernel_at_two_shared_memory_sizes(cuda,
                                                                  kernel):
    """Four host threads, two at each of two shared memory sizes, launch
    one kernel function, as a serving runtime's workers do with batches of
    two sizes (abft_fft's threads also ask the card for its clusters, with
    nothing else in the call). The function's shared memory limit is one
    per device, so a thread that set it to its own size could lower it
    under another's launch or cluster query. Every launch and every
    cluster query succeeds, and each thread's last result is the plain
    version's."""
    from repro_torch.kernels import _build, stockham_abft

    dtype, cases = _TWO_SIZES[kernel]
    rounds, errors, results = 2000, [], {}
    start = threading.Barrier(2 * len(cases))
    lib = _build.load("abft_fft", stockham_abft._SIGNATURES)

    def run(k, b, n, bs):
        try:
            x = _rand(b, n, dtype).to(cuda)
            stages = make_plan(n).stages[0]
            if kernel == "abft_fft":
                geo = stockham_abft.launch_geometry(stages, dtype, bs, 1)
                packed = geo.pack(geo.rows)
                query = lib.abft_fft_clusters_c64
            start.wait()
            for _ in range(rounds):
                if kernel == "block_fft":
                    got = block_fft(x, stages)
                else:
                    clusters = query(ctypes.addressof(packed))
                    assert clusters >= 1, (geo, clusters)
                    got = abft_fft(x, stages, bs=bs)
            torch.cuda.synchronize()
            want = (block_fft_plain(x.cpu(), stages) if kernel == "block_fft"
                    else abft_fft_plain(x.cpu(), stages, bs=bs))
            results[k] = (got, want)
        except BaseException as exc:          # reported by the main thread
            errors.append(exc)
            start.abort()

    threads = [threading.Thread(target=run, args=(k,) + cases[k % 2])
               for k in range(2 * len(cases))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:4]
    assert len(results) == len(threads)
    for got, want in results.values():
        if kernel == "block_fft":
            _close(got, want)
        else:
            _check_abft(got, want, _delta_noise(want[1]))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_abft_build_fast_instances_have_no_spills_or_stack(cuda):
    x = _rand(4, 64, torch.complex64).to(cuda)
    abft_fft(x, make_plan(64).stages[0], bs=1, transactions=4)   # builds
    log = ftk._build.library_path("abft_fft").with_suffix(".log")
    rows = _chip_smoke().abft_ptxas(log.read_text())
    assert sorted((r["dtype"], r["fast"]) for r in rows) == [
        ("complex128", False), ("complex128", True),
        ("complex64", False), ("complex64", True)]
    for r in rows:
        if r["fast"]:
            assert r["spill_stores"] == r["spill_loads"] == 0, r
            assert r["stack"] == 0, r
            assert r["registers"] <= (64 if r["dtype"] == "complex64"
                                      else 128), r


def test_abft_timed_geometry_schedules(cuda):
    from repro_torch.kernels.stockham_abft import (launch_geometry,
                                                   max_active_clusters)
    stages = make_plan(8192).stages[0]
    for dtype, bs, t in ((torch.complex64, 1, 4), (torch.complex128, 1, 4),
                         (torch.complex64, 4, 8), (torch.complex128, 4, 8)):
        geo = launch_geometry(stages, dtype, bs, t)
        assert max_active_clusters(geo, cuda) >= 1, geo


# One plan.ft_fft call traced in a fresh process: once a process has run
# for some seconds (17 s in one run on an H100), the tracer drops the first
# kernels of each trace (the launches run, and their cudaLaunchKernel calls
# are traced), more of them the older the process (python -m
# repro_torch.kernels.trace_age; ROADMAP queue 3).
_FT_TRACE = """
import json, torch
from repro_torch.core.fft import FFTSpec, FTConfig, plan
x = torch.randn(256, 4096, dtype=torch.complex64, device="cuda")
p = plan(FFTSpec(shape=(256, 4096), ft=FTConfig()))
p.ft_fft(x)
torch.cuda.synchronize()
acts = [torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]
for _ in range(3):      # the tracer can drop an event, never add one
    with torch.profiler.profile(activities=acts) as prof:
        p.ft_fft(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = (sum("abft_fft" in nm for nm in names),
              sum("block_fft" in nm for nm in names))
    if counts == (1, 1):
        break
print(json.dumps({"counts": counts, "names": names}))
"""


def test_plan_ft_fft_launches_one_abft_and_one_block_fft(cuda):
    """One plan.ft_fft call: one fused kernel, one checksum FFT over the
    (2G, N) block [X.e2; X.e3], by the launch counts and under
    torch.profiler (in a fresh process, see ``_FT_TRACE``)."""
    b, n = 256, 4096
    x = _rand(b, n, torch.complex64).to(cuda)
    p = plan(FFTSpec(shape=(b, n), ft=FTConfig()))
    before = (abft_fft.launches, block_fft.launches)
    p.ft_fft(x)
    assert (abft_fft.launches - before[0], block_fft.launches - before[1]) \
        == (1, 1)
    out = subprocess.run([sys.executable, "-c", _FT_TRACE], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=str(_REPO / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    traced = json.loads(out.stdout.splitlines()[-1])
    assert tuple(traced["counts"]) == (1, 1), traced["names"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_fft_detect_locate_correct_on_card(cuda, dtype):
    b, n, bs = 64, 1024, 2
    x = _rand(b, n, dtype).to(cuda)
    want = torch.fft.fft(x)
    tile, row, col = 5, 1, 37
    inj = torch.tensor([tile, row, col, 1, 40.0, 25.0])
    res = ops.ft_fft(x, transactions=4, bs=bs, inject=inj, threshold=1e-6)
    flagged = res.flagged.cpu()
    assert int(flagged.sum()) == 1 and int(res.corrected) == 1
    assert int(res.location.cpu()[flagged][0]) == tile * bs + row
    _close(res.y, want, factor=2.0)
    clean = plan(FFTSpec(shape=(b, n), dtype=str(dtype).split(".")[1],
                         ft=FTConfig())).ft_fft(x)
    assert not clean.flagged.any()
    _close(clean.y, want)


# ---------------------------------------------------------------------------
# the local extensions on kernels 1 and 2
# ---------------------------------------------------------------------------

RDTYPES = [torch.float32, torch.float64]


def _rrand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy(rng.standard_normal(shape)).to(dtype)


def _crand(shape, dtype, seed=0):
    rng = np.random.default_rng(seed + 3 * sum(shape))
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape)).to(dtype)


def _name(dtype):
    return str(dtype).split(".")[1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 128), (3, 256, 32), (1, 8192, 4),
                                   (2, 12, 30), (2, 8, 16, 32)])
def test_fftn_on_card_matches_torch_fft_and_cpu(cuda, shape, dtype):
    """fft2 / fftn (rank 3 for 4-D shapes) on the card against torch.fft
    and against the same plan's device="cpu" result; a power-of-two axis
    of <= 8192 points is one block_fft launch."""
    rank = 3 if len(shape) == 4 else 2
    x = _crand(shape, dtype)
    p = plan(FFTSpec(shape=shape, dtype=_name(dtype), rank=rank))
    pc = plan(FFTSpec(shape=shape, dtype=_name(dtype), rank=rank,
                      device="cpu"))
    axes = tuple(range(-rank, 0))
    before = block_fft.launches
    got = p.fft(x.to(cuda))
    pow2 = sum(n & (n - 1) == 0 for n in shape[-rank:])
    assert block_fft.launches - before == pow2
    factor = 2.0 if rank == 3 else 1.0
    _close(got, torch.fft.fftn(x.to(cuda), dim=axes), factor)
    _close(got, pc.fft(x), factor)
    back = p.ifft(got)
    _close(back, torch.fft.ifftn(got, dim=axes), factor)
    _close(back, x, factor)


@pytest.mark.parametrize("dtype", RDTYPES)
@pytest.mark.parametrize("n", [64, 1024, 16384, 1 << 15, 511])
def test_rfft_irfft_on_card(cuda, n, dtype):
    """The packed rfft (half length one pass up to 8192, then two passes)
    and its inverse against torch.fft and the CPU path; odd n is the
    direct DFT."""
    from repro_torch.core.fft import extensions as ext

    x = _rrand((3, n), dtype)
    got = ext.rfft(x.to(cuda))
    _close(got, torch.fft.rfft(x.to(cuda)))
    _close(got, ext.rfft(x, device="cpu"))
    back = ext.irfft(got, n=n)
    assert back.shape == x.shape and back.dtype == dtype
    _close(back, x)


@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 512, 1024), (2, 16, 27),
                                   (2, 64, 30)])
def test_rfft2_irfft2_on_card(cuda, shape):
    """rfft2 / irfft2 against torch.fft and the CPU path; C/2+1 is odd in
    the first two shapes (the column launch takes one signal a tile), C is
    odd in the third (the direct DFT)."""
    x = _rrand(shape, torch.float32)
    p = plan(FFTSpec(shape=shape, rank=2, real=True))
    pc = plan(FFTSpec(shape=shape, rank=2, real=True, device="cpu"))
    got = p.rfft2(x.to(cuda))
    _close(got, torch.fft.rfft2(x.to(cuda)))
    _close(got, pc.rfft2(x))
    back = p.irfft2(got)
    assert back.shape == x.shape
    _close(back, x)


@pytest.mark.parametrize("real", [True, False])
def test_convolve_correlate_on_card(cuda, real):
    from repro_torch.core.fft import spectral

    if real:
        a, v = _rrand((4, 700), torch.float32), _rrand((129,), torch.float32)
    else:
        a, v = (_crand((4, 700), torch.complex64),
                _crand((129,), torch.complex64))
    nfft = 1024
    fa = torch.fft.fft(a.to(cuda), n=nfft)
    fv = torch.fft.fft(v.to(cuda), n=nfft)
    want = torch.fft.ifft(fa * fv)[..., :828]
    want = want.real if real else want
    for mode in ("full", "same", "valid"):
        got = spectral.fft_convolve(a.to(cuda), v.to(cuda), mode=mode)
        assert got.is_cuda and got.is_complex() != real
        _close(got, spectral._crop(want, 700, 129, mode))
        _close(got, spectral.fft_convolve(a, v, mode=mode, device="cpu"))
        cor = spectral.correlate(a.to(cuda), v.to(cuda), mode=mode)
        _close(cor, spectral.correlate(a, v, mode=mode, device="cpu"))


def test_fft_convolve2_and_power_spectrum_on_card(cuda):
    from repro_torch.core.fft import multidim, spectral

    a, k = _rrand((2, 60, 50), torch.float32), _rrand((5, 7), torch.float32)
    s = (64, 64)
    want = torch.fft.irfft2(torch.fft.rfft2(a.to(cuda), s=s)
                            * torch.fft.rfft2(k.to(cuda), s=s), s=s)
    got = multidim.fft_convolve2(a.to(cuda), k.to(cuda))
    _close(got, want[..., :64, :56])
    _close(got, multidim.fft_convolve2(a, k, device="cpu"))
    x = _crand((3, 4096), torch.complex64)
    _close(spectral.power_spectrum(x.to(cuda)),
           torch.fft.fft(x.to(cuda)).abs() ** 2 / 4096)
    r = _rrand((3, 4096), torch.float32)
    _close(spectral.power_spectrum(r.to(cuda), real=True),
           torch.fft.rfft(r.to(cuda)).abs() ** 2 / 4096)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ft_ifft_on_card_detects_and_corrects(cuda, dtype):
    from repro_torch.core.fft import extensions as ext

    b, n, bs = 64, 1024, 2
    x = _rand(b, n, dtype).to(cuda)
    before = abft_fft.launches
    res = ext.ft_ifft(x, transactions=4, bs=bs, threshold=1e-6,
                      inject=torch.tensor([5, 1, 37, 1, 40.0, 25.0]))
    assert abft_fft.launches == before + 1
    flagged = res.flagged.cpu()
    assert int(flagged.sum()) == 1 and int(res.corrected) == 1
    assert int(res.location.cpu()[flagged][0]) == 5 * bs + 1
    _close(res.y, torch.fft.ifft(x), factor=2.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,n,inner", [(3, 64, 128), (4, 4096, 65),
                                          (2, 8192, 3), (1, 512, 4096),
                                          (5, 16, 33)])
def test_block_fft_kernel_matches_plain_in_axis_layouts(cuda, lead, n, inner,
                                                        dtype):
    """One launch over the strided columns of a (lead, n, inner) block, in
    place, against the plain version: an odd ``inner`` takes one signal a
    tile and the scalar path."""
    from repro_torch.core.fft.plan import axis_layout

    x = _rand(lead * n, inner, dtype).to(cuda).reshape(lead, n, inner)
    stages = make_plan(n).stages[0]
    lay = axis_layout(lead, n, inner)
    want = block_fft_plain(x, stages, scale=0.25, layout=lay)
    got = x.clone()
    block_fft(got, stages, scale=0.25, layout=lay, out=got)
    _close(got, want)


# ---------------------------------------------------------------------------
# kernel 3: ft_matmul
# ---------------------------------------------------------------------------

GEMM_PARTS = ("c", "out2", "pred2", "out3", "pred3")


def _int_mats(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m + 3 * k + 7 * n)
    x = rng.integers(-4, 5, (m, k)).astype(np.float32)
    w = rng.integers(-4, 5, (k, n)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


@pytest.mark.parametrize("inject", [None, [[171.0, 40.0, 1.0, 333.0],
                                           [3.0, 127.0, 1.0, -50.0],
                                           [9.0, 9.0, 0.0, 70.0]]])
@pytest.mark.parametrize("tiles", [(128, 128, 128), (64, 64, 64),
                                   (128, 64, 128), (64, 128, 64)])
def test_ft_matmul_kernel_bitwise_on_integers(cuda, tiles, inject):
    bm, bk, bn = tiles
    x, w = _int_mats(256, 128, 128)
    inj = None if inject is None else torch.tensor(inject)
    before = ft_matmul.launches
    got = ft_matmul(x.to(cuda), w.to(cuda), bm=bm, bk=bk, bn=bn, inject=inj)
    assert ft_matmul.launches == before + 1
    want = ft_matmul_plain(x, w, inject=inj)
    for part in GEMM_PARTS:
        assert torch.equal(getattr(got, part).cpu(), getattr(want, part)), \
            part


@pytest.mark.parametrize("xdtype,wdtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
def test_ft_matmul_kernel_matches_plain_random(cuda, xdtype, wdtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(512, 1024, device=cuda, generator=gen).to(xdtype)
    w = torch.randn(1024, 384, device=cuda, generator=gen).to(wdtype)
    inj = torch.tensor([[300.0, 200.0, 1.0, 90.0]])
    got = ft_matmul(x, w, inject=inj)
    want = ft_matmul_plain(x, w, inject=inj)
    assert got.c.dtype == xdtype
    for part in GEMM_PARTS:
        g, r = getattr(got, part).float(), getattr(want, part).float()
        step = 2.0 ** -7 if (part == "c" and xdtype == torch.bfloat16) \
            else 1e-4
        err = (g - r).abs().max().item()
        assert err <= step * r.abs().max().item(), (part, err)


def test_ft_matmul_kernel_is_deterministic(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(1024, 512, device=cuda, generator=gen)
    w = torch.randn(512, 1024, device=cuda, generator=gen)
    a, b = ft_matmul(x, w), ft_matmul(x, w)
    for part in GEMM_PARTS:
        assert torch.equal(getattr(a, part), getattr(b, part)), part


def test_ft_matmul_kernel_rejects_what_it_does_not_take(cuda):
    x, w = torch.zeros(256, 128, device=cuda), torch.zeros(128, 128,
                                                           device=cuda)
    with pytest.raises(ValueError, match="tile-aligned"):
        ft_matmul(x[:100], w)
    with pytest.raises(ValueError, match="bm, bn in"):
        ft_matmul(x, w, bm=32)
    with pytest.raises(TypeError, match="float32/bfloat16"):
        ft_matmul(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        ft_matmul(x, w.t())
    with pytest.raises(ValueError, match="one device"):
        ft_matmul(x, w.cpu())


def test_gemm_plan_auto_takes_the_kernel_on_cuda(cuda):
    x, w = _int_mats(256, 128, 256)
    x, w = x.to(cuda), w.to(cuda)
    cfg = FTConfig(threshold=1e-3)
    p = gemm.plan(gemm.spec_for(x, w, ft=cfg))
    assert p.backend == "fused" and p.device.type == "cuda"
    eager = gemm.plan(gemm.spec_for(x, w, ft=cfg, backend="eager"))
    inj = torch.tensor([[200.0, 31.0, 1.0, 500.0], [5.0, 250.0, 1.0, -70.0]])
    before = ft_matmul.launches
    y, s = p.ft_matmul(x, w, inject=inj)
    assert ft_matmul.launches == before + 1
    ye, se = eager.ft_matmul(x, w, inject=inj)
    assert ft_matmul.launches == before + 1       # eager: no kernel
    assert torch.equal(y, x @ w) and torch.equal(ye, y)
    for key in ("flagged", "corrected", "uncorrectable"):
        assert float(s[key]) == float(se[key]) == (0.0 if key ==
                                                    "uncorrectable" else 2.0)
    # a decode-shaped product (M = 4, no multiple of the tile): auto takes
    # the kernel too, on M padded to 64 rows
    x4 = x[:4]
    p4 = gemm.plan(gemm.spec_for(x4, w, ft=cfg))
    assert p4.backend == "fused"
    before = ft_matmul.launches
    y4, s4 = p4.ft_matmul(x4, w)
    assert ft_matmul.launches == before + 1
    assert torch.equal(y4, x4 @ w) and float(s4["flagged"]) == 0.0


@pytest.mark.parametrize("shape", [(4, 100, 128), (4, 128, 100)],
                         ids=["K", "N"])
def test_gemm_plan_unaligned_k_or_n_raises_on_cuda(cuda, shape):
    """No fallback on the card: an unaligned K or N is zero-padded to the
    tiles and runs on the kernel (one launch), its product and stats those
    of the eager path on the same card, a fault corrected; backend='eager'
    still asks for the torch path."""
    cfg = FTConfig(threshold=1e-3)
    m, k, n = shape
    x, w = _path_operands(cuda, m, k, n, torch.float32)
    p = gemm.plan(gemm.spec_for(x, w, ft=cfg))
    assert p.backend == "fused"
    inj = torch.tensor([[m - 1, n - 1, 1, 75.0]])
    before = ft_matmul.launches
    y, st = p.ft_matmul(x, w, inject=inj)
    assert ft_matmul.launches == before + 1
    eager = gemm.plan(gemm.spec_for(x, w, ft=cfg, backend="eager"))
    assert eager.backend == "eager"
    ye, se = eager.ft_matmul(x, w, inject=inj)
    assert (float(st["flagged"]), float(st["corrected"])) == (1.0, 1.0)
    assert (float(se["flagged"]), float(se["corrected"])) == (1.0, 1.0)
    assert (y - ye).abs().max().item() <= GEMM_TOL * ye.abs().max().item()


@pytest.mark.parametrize("m", [1, 4, 100, 200])
def test_padded_ft_matmul_equals_plain_on_unpadded(cuda, m):
    """The kernel on M padded with zero rows to a multiple of 64: its
    product's first M rows and its four strips equal the plain version's on
    the unpadded operands, bit for bit (integer operands), with a fault on
    row M - 1; the plan corrects it."""
    x, w = _int_mats(m, 256, 384)
    x, w = x.to(cuda), w.to(cuda)
    inj = torch.tensor([[m - 1.0, 200.0, 1.0, 300.0]])
    got = ft_matmul(torch.nn.functional.pad(x, (0, 0, 0, -m % 64)), w,
                    bm=64, inject=inj)
    want = ft_matmul_plain(x, w, inject=inj)
    assert torch.equal(got.c[:m], want.c)
    assert not got.c[m:].any()
    for part in GEMM_PARTS[1:]:
        assert torch.equal(getattr(got, part), getattr(want, part)), part
    y, s = gemm.plan(gemm.spec_for(x, w, ft=FTConfig(threshold=1e-3))
                     ).ft_matmul(x, w, inject=inj)
    assert torch.equal(y, x @ w)
    assert (float(s["flagged"]), float(s["corrected"])) == (1.0, 1.0)


@pytest.mark.parametrize("shape", [(64, 3072, 8192), (256, 512, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ft_matmul_float32_x_is_the_bf16_product_unrounded(cuda, shape):
    """The plan hands the kernel X in float32 so that ``c`` stays float32
    through the correction: the kernel widens a bf16 X as it loads it, so
    the float32 product rounded to bf16 is the bf16 launch's ``c`` bit for
    bit, and the strips are the same."""
    m, k, n = shape
    x, w = _path_operands(cuda, m, k, n, torch.bfloat16)
    inj = torch.tensor([[m - 1, n // 3, 1, 75.0]])
    narrow = ft_matmul(x, w, bm=64, inject=inj)
    wide = ft_matmul(x.float(), w, bm=64, inject=inj)
    assert wide.c.dtype == torch.float32
    assert torch.equal(wide.c.to(torch.bfloat16), narrow.c)
    for part in GEMM_PARTS[1:]:
        assert torch.equal(getattr(wide, part), getattr(narrow, part)), part


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_phi4_smoke_on_the_card_matches_the_cpu(cuda):
    """Phi-4-mini SMOKE at float32 (unprotected: its widths are no multiples
    of the tile): the forward and 6 decode steps on the card against the
    port on the CPU, logits within 1e-3 x max|cpu|."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config("phi4_mini_3p8b"),
                              dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    want, _ = m.apply(params, {"tokens": toks}, block_q=8)
    got, _ = m.apply(gparams, {"tokens": toks.to(cuda)}, block_q=8)
    tol = 1e-3 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    caches = {"cpu": m.init_cache(2, 8, dtype=torch.float32, device="cpu"),
              "cuda": m.init_cache(2, 8, dtype=torch.float32, device=cuda)}
    for i in range(6):
        lc, caches["cpu"], _ = m.decode_step(params, caches["cpu"],
                                             toks[:, i:i + 1], i)
        lg, caches["cuda"], _ = m.decode_step(gparams, caches["cuda"],
                                              toks[:, i:i + 1].to(cuda), i)
        tol = 1e-3 * lc.abs().max().item()
        assert (lg.cpu() - lc).abs().max().item() <= tol, i


def test_protected_decode_step_launches_ft_matmul_seven_times_a_layer(cuda):
    """Phi-4-mini's structure at tile-aligned widths, every linear
    protected: one decode step (M = the batch, 4, padded to 64) launches
    ``ft_matmul`` 7 x layers times (q, k, v, o, gate, up, down) and never
    the eager path; its logits agree with the CPU's eager path, and a fault
    at site 3 of every block is corrected in each."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.models import Model

    base = get_smoke_config("phi4_mini_3p8b")
    cfg = dataclasses.replace(
        base, dtype="float32", num_layers=3, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512, ft=dataclasses.replace(
            base.ft, protect_linears=True, threshold=1e-3))
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.tensor([[5], [77], [300], [511]], dtype=torch.int32)
    want, _, _ = m.decode_step(params, m.init_cache(4, 8, device="cpu"),
                               toks, 0)
    eager = abft_gemm.ft_matmul
    calls = []
    abft_gemm.ft_matmul = lambda *a, **k: calls.append(1) or eager(*a, **k)
    try:
        for inject in (None, torch.tensor([[3.0, 2.0, 9.0, 1.0, 60.0]],
                                          device=cuda)):
            before = ft_matmul.launches
            got, _, aux = m.decode_step(
                gparams, m.init_cache(4, 8, device=cuda), toks.to(cuda), 0,
                inject=inject)
            assert ft_matmul.launches - before == 7 * cfg.num_layers
            faults = 0 if inject is None else cfg.num_layers
            assert float(aux["ft_flagged"]) == faults
            assert float(aux["ft_corrected"]) == faults
            tol = 1e-3 * want.abs().max().item()
            assert (got.cpu() - want).abs().max().item() <= tol
    finally:
        abft_gemm.ft_matmul = eager
    assert not calls


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_350m"])
def test_recurrent_smoke_on_the_card_matches_the_cpu(cuda, arch):
    """The recurrent models' SMOKE configs at float32, unprotected: the
    forward (the RG-LRU's doubling scan, the LSTMs' loops) and 6 decode
    steps on the card against the port on the CPU, logits within 1e-3 x
    max|cpu|, and the carried states after them."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    want, _ = m.apply(params, {"tokens": toks}, block_q=8)
    got, _ = m.apply(gparams, {"tokens": toks.to(cuda)}, block_q=8)
    tol = 1e-3 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    caches = {"cpu": m.init_cache(2, 8, dtype=torch.float32, device="cpu"),
              "cuda": m.init_cache(2, 8, dtype=torch.float32, device=cuda)}
    for i in range(6):
        lc, caches["cpu"], _ = m.decode_step(params, caches["cpu"],
                                             toks[:, i:i + 1], i)
        lg, caches["cuda"], _ = m.decode_step(gparams, caches["cuda"],
                                              toks[:, i:i + 1].to(cuda), i)
        tol = 1e-3 * lc.abs().max().item()
        assert (lg.cpu() - lc).abs().max().item() <= tol, i
    state = caches["cpu"]["scan"]["slot0"]
    for key, t in state.items():
        g = caches["cuda"]["scan"]["slot0"][key].cpu().float()
        tol = 1e-3 * max(t.abs().max().item(), 1e-30)
        assert (g - t.float()).abs().max().item() <= tol, key


# the recurrent models' protected products a block, by mixer: RG-LRU 3 + the
# MLP's 3, local attention 4 + 3, mLSTM 5, sLSTM 4 + its SwiGLU's 3
RECURRENT_SITES = {"rglru": 6, "local": 7, "mlstm": 5, "slstm": 7}


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_350m"])
def test_protected_recurrent_decode_step_launches_ft_matmul_every_site(
        cuda, arch):
    """Every linear protected, widths the kernel tiles (RecurrentGemma at
    d_model 128 with 64-wide heads; xLSTM's SMOKE widths as they are, its
    64-wide FFN on 64-wide tiles): one decode step launches ``ft_matmul``
    once a protected site of every layer and never the eager path; its
    logits agree with the CPU's eager path, and a fault at site 1 of every
    block is corrected in each."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.models import Model
    from repro_torch.models.transformer import effective_kinds

    base = get_smoke_config(arch)
    widths = dict(d_model=128, lru_width=128, num_heads=2, num_kv_heads=1,
                  head_dim=64, d_ff=256) if arch == "recurrentgemma_2b" \
        else {}
    cfg = dataclasses.replace(base, dtype="float32", **widths,
                              ft=dataclasses.replace(
                                  base.ft, protect_linears=True,
                                  threshold=1e-3))
    sites = sum(RECURRENT_SITES[k.split("|")[0]]
                for k in effective_kinds(cfg))
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.tensor([[5], [77], [300], [511]], dtype=torch.int32)
    want, _, _ = m.decode_step(params, m.init_cache(4, 8, device="cpu"),
                               toks, 0)
    eager = abft_gemm.ft_matmul
    calls = []
    abft_gemm.ft_matmul = lambda *a, **k: calls.append(1) or eager(*a, **k)
    try:
        for inject in (None, torch.tensor([[1.0, 2.0, 9.0, 1.0, 60.0]],
                                          device=cuda)):
            before = ft_matmul.launches
            got, _, aux = m.decode_step(
                gparams, m.init_cache(4, 8, device=cuda), toks.to(cuda), 0,
                inject=inject)
            assert ft_matmul.launches - before == sites
            faults = 0 if inject is None else cfg.num_layers
            assert float(aux["ft_flagged"]) == faults
            assert float(aux["ft_corrected"]) == faults
            tol = 1e-3 * want.abs().max().item()
            assert (got.cpu() - want).abs().max().item() <= tol
    finally:
        abft_gemm.ft_matmul = eager
    assert not calls


@pytest.mark.parametrize("shape", [(4, 1024, 1344), (4, 1344, 1024)],
                         ids=["gate", "down"])
def test_slstm_ffn_product_launches_ft_matmul_on_64_wide_tiles(cuda, shape):
    """xLSTM-350M's sLSTM FFN (1344 = 64 x 21) through the plan that
    ``FTContext`` builds: 64-wide tiles, one ``ft_matmul`` launch, the
    plain version's product and a fault corrected."""
    from repro_torch.core.plan import FTConfig

    m, k, n = shape
    x, w = _path_operands(cuda, m, k, n, torch.float32)
    p = gemm.plan(gemm.spec_for(x, w, ft=FTConfig(threshold=1e-3)))
    assert p.backend == "fused" and 64 in p.spec.tiles[1:]
    inj = torch.tensor([[m - 1, n - 5, 1, 75.0]])
    before = ft_matmul.launches
    y, s = p.ft_matmul(x, w, inject=inj)
    assert ft_matmul.launches == before + 1
    assert (float(s["flagged"]), float(s["corrected"])) == (1.0, 1.0)
    want = ft_matmul_plain(x, w).c
    assert (y - want).abs().max().item() <= \
        GEMM_TOL * want.abs().max().item()
    xp = torch.nn.functional.pad(x, (0, 0, 0, 60))
    got, plain = ft_matmul(xp, w, bm=64, bn=64, bk=64), ft_matmul_plain(xp, w)
    for part in GEMM_PARTS:
        g, r = getattr(got, part), getattr(plain, part)
        assert (g - r).abs().max().item() <= \
            GEMM_TOL * r.abs().max().item(), part


# the checked-GEMM path's products at Phi-4-mini 3.8B's MLP widths, (M, K, N)
GEMM_SHAPES = [(2048, 3072, 8192), (2048, 8192, 3072)]
GEMM_TOL, BF16_STEP = 1e-4, 2.0 ** -7


def _path_operands(cuda, m, k, n, xdtype):
    """Seeded (M, K) activations ~N(0, 1) in ``xdtype`` and float32 (K, N)
    weights ~N(0, 1/K), as ``chip_smoke.py`` makes them."""
    gen = torch.Generator(device=cuda).manual_seed(m + 3 * k + 7 * n)
    x = torch.randn((m, k), device=cuda, generator=gen)
    w = torch.randn((k, n), device=cuda, generator=gen) / math.sqrt(k)
    return x.to(xdtype), w


@pytest.mark.parametrize("injected", [False, True], ids=["clean", "inject"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_ft_matmul_kernel_matches_plain_at_path_shapes(cuda, shape, xdtype,
                                                       injected):
    m, k, n = shape
    x, w = _path_operands(cuda, m, k, n, xdtype)
    inj = torch.tensor([[m - 1, n // 3, 1, 75.0], [5, 7, 1, -30.0]]) \
        if injected else None
    before = ft_matmul.launches
    got = ft_matmul(x, w, inject=inj)
    assert ft_matmul.launches == before + 1
    want = ft_matmul_plain(x, w, inject=inj)
    for part in GEMM_PARTS:
        g, r = getattr(got, part).float(), getattr(want, part).float()
        step = BF16_STEP if (part == "c" and xdtype == torch.bfloat16) \
            else GEMM_TOL
        err = (g - r).abs().max().item()
        assert err <= step * r.abs().max().item(), (part, err)


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_ft_matmul_kernel_is_bitwise_equal_across_cta_tiles(cuda, xdtype):
    m, k, n = GEMM_SHAPES[1]
    x, w = _path_operands(cuda, m, k, n, xdtype)
    inj = torch.tensor([[m - 1, n // 3, 1, 75.0], [70, 7, 1, -30.0]])
    tiles = [(tm, tn) for tm in ftk.KERNEL_TILES for tn in ftk.KERNEL_TILES]
    outs = [ftk._launch(x, w, inj, *t) for t in tiles]
    for t, o in zip(tiles[1:], outs[1:]):
        for part in GEMM_PARTS:
            assert torch.equal(getattr(o, part), getattr(outs[0], part)), \
                (t, part)


def test_ft_matmul_build_has_no_spills_and_two_ctas_per_sm(cuda):
    ft_matmul(*(t.to(cuda) for t in _int_mats(128, 128, 128)))   # builds
    smoke = _chip_smoke()
    build_log = ftk._build.library_path("ft_matmul").with_suffix(".log")
    rows = smoke.ft_matmul_ptxas(build_log.read_text())
    assert len(rows) == 16                # 4 operand types x 4 CTA tiles
    assert all(r["spill_stores"] == r["spill_loads"] == 0 for r in rows)
    assert all(r["registers"] <= 128 for r in rows)
    assert ftk.blocks_per_sm(torch.float32, torch.float32, 128, 128) >= 2
    # the down projection's grid is 1.45 waves of 128 x 128 CTAs: the
    # wrapper takes a tile that fills its waves
    m, _, n = GEMM_SHAPES[1]
    assert ftk.device_cta_tile(m, n, 128, 128, torch.float32, torch.float32,
                               cuda) != (128, 128)


# ---------------------------------------------------------------------------
# the serving runtime on the card
# ---------------------------------------------------------------------------

def _runtime(**kw):
    from repro_torch.serve import RuntimeConfig, ServeRuntime
    cfg = dict(max_batch=8, deadline_ms=2.0, workers=2, queue_depth=512)
    cfg.update(kw)
    return ServeRuntime(RuntimeConfig(**cfg))


def _clients(submit, n_clients, per_client):
    """``n_clients`` threads, each calling ``submit(client, i)`` for its
    ``per_client`` requests and waiting for every result."""
    errors = []

    def run(c):
        try:
            hs = [submit(c, i) for i in range(per_client)]
            for h in hs:
                h.result(timeout=120.0)
        except Exception as e:          # reported below
            errors.append(e)

    ts = [threading.Thread(target=run, args=(c,)) for c in range(n_clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors[:1]


def test_serve_workers_launch_on_their_own_streams(cuda, monkeypatch):
    seen = []
    launch = ops.block_fft

    def spy(*args, **kw):
        seen.append((threading.current_thread().name,
                     torch.cuda.current_stream().cuda_stream))
        return launch(*args, **kw)

    x = _rand(1, 8192, torch.complex64)[0].numpy()
    with _runtime(max_batch=2, deadline_ms=0.5) as rt:
        rt.submit(x).result(timeout=60.0)          # admission, warm-up
        monkeypatch.setattr(ops, "block_fft", spy)
        _clients(lambda c, i: rt.submit(x), 4, 16)
    streams = {}
    for thread, stream in seen:
        streams.setdefault(thread, set()).add(stream)
    assert set(streams) == {"serve-worker-0", "serve-worker-1"}, streams
    assert all(len(s) == 1 for s in streams.values()), streams
    mine = [next(iter(s)) for s in streams.values()]
    assert len(set(mine)) == 2
    assert torch.cuda.default_stream().cuda_stream not in mine


def test_serve_request_latency_covers_its_batch_device_time(cuda):
    n = 1 << 20
    xs = [_rand(1, n, torch.complex64, seed=i)[0] for i in range(16)]
    with _runtime(max_batch=8, deadline_ms=5.0) as rt:
        rt.submit(xs[0].numpy()).result(timeout=60.0)
        hs = [rt.submit(x.to(cuda) if i % 2 else x.numpy())
              for i, x in enumerate(xs)]
        ys = [h.result(timeout=60.0) for h in hs]
    for x, y, h in zip(xs, ys, hs):
        dev_ms = h.info["device_ms"]
        assert 0 < dev_ms <= h.latency_s * 1e3, (dev_ms, h.latency_s)
        _close(torch.as_tensor(y), torch.fft.fft(x.to(cuda)))


def _memcpys(fn):
    """(host-to-device, device-to-host) copies on the card while ``fn``
    runs, from torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prime()             # late in a process the tracer drops a head
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum("HtoD" in nm for nm in names),
            sum("DtoH" in nm for nm in names))


def test_serve_results_come_back_where_requests_came_from(cuda):
    """A batch of card requests is served without a host copy and its
    results are card tensors; a batch of host requests takes one
    host-to-device and one device-to-host copy and its results are a numpy
    array and a CPU tensor; each is its request's own transform."""
    xs = [_rand(1, 4096, torch.complex64, seed=i)[0] for i in range(4)]
    with _runtime(max_batch=4, deadline_ms=10_000.0, workers=1) as rt:
        warm = rt.submit(xs[0].numpy())
        rt.drain()
        warm.result(timeout=60.0)
        on_card = [x.to(cuda) for x in xs]
        torch.cuda.synchronize()
        got = {}
        copies = _memcpys(lambda: got.update(card=[
            h.result(timeout=60.0) for h in [rt.submit(x) for x in on_card]]))
        assert copies == (0, 0), copies
        for x, y in zip(xs, got["card"]):
            assert y.device == on_card[0].device
            _close(y, torch.fft.fft(x))
        host = [x.numpy() if i % 2 else x for i, x in enumerate(xs)]
        for _ in range(3):      # the tracer can drop an event, never add one
            copies = _memcpys(lambda: got.update(host=[
                h.result(timeout=60.0) for h in [rt.submit(x) for x in host]]))
            if copies == (1, 1):
                break
        assert copies == (1, 1), copies
    for i, (x, y) in enumerate(zip(xs, got["host"])):
        assert isinstance(y, np.ndarray) if i % 2 else (
            torch.is_tensor(y) and y.device.type == "cpu")
        _close(torch.as_tensor(y), torch.fft.fft(x))


def test_serve_launch_counts_are_exact_with_two_workers(cuda):
    """Four clients and two workers over three buckets (one pass, two
    passes, and ft), the interpreter switching threads every microsecond:
    the launch counts equal each bucket plan's launches a batch over its
    batches."""
    from repro_torch.serve import serve_plan

    reqs = [(_rand(1, 8192, torch.complex64)[0], {}),
            (_rand(1, 16384, torch.complex64)[0], {}),
            (_rand(1, 8192, torch.complex64, seed=1)[0], {"ft": True})]
    switch = sys.getswitchinterval()
    with _runtime(max_batch=4, deadline_ms=1.0) as rt:
        per_batch = {}
        for x, kw in reqs:
            key = rt.bucketer.key_for(tuple(x.shape), x.dtype, **kw)
            p = rt.admit(key)
            before = (block_fft.launches, abft_fft.launches)
            serve_plan(p, torch.zeros((4,) + key.tshape, dtype=x.dtype,
                                      device=cuda))
            per_batch[key.label] = (block_fft.launches - before[0],
                                    abft_fft.launches - before[1])
        torch.cuda.synchronize()
        before = (block_fft.launches, abft_fft.launches)
        try:
            sys.setswitchinterval(1e-6)
            _clients(lambda c, i: rt.submit(
                reqs[(c + i) % 3][0].to(cuda) if i % 2
                else reqs[(c + i) % 3][0].numpy(), **reqs[(c + i) % 3][1]),
                4, 48)
        finally:
            sys.setswitchinterval(switch)
        got = (block_fft.launches - before[0], abft_fft.launches - before[1])
        stats = rt.stats()["buckets"]
    want = [0, 0]
    for label, st in stats.items():
        assert st["completed"] == st["submitted"] == 64 and \
            st["failed"] == 0, (label, st)
        for k in (0, 1):
            want[k] += st["batches"] * per_batch[label][k]
    assert per_batch == {"fft:8192:c64": (1, 0), "fft:16384:c64": (2, 0),
                         "fft:8192:c64:ft": (1, 1)}
    assert got == tuple(want), (got, want, stats)


_NCCL_ONE_RANK = r"""
import json, socket, threading
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.serve import Fault, RuntimeConfig, ServeRuntime

dev = torch.device("cuda", 0)
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=0, world_size=1, device_id=dev)
seen, launch = set(), ops.block_fft


def spy(*a, **k):
    seen.add((threading.current_thread().name,
              torch.cuda.current_stream().cuda_stream))
    return launch(*a, **k)


ops.block_fft = spy
rng = np.random.default_rng(0)
reqs = []
for i in range(24):
    n = (8192, 6000, 1 << 17, 8192)[i % 4]
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    reqs.append((x, ({}, {"op": "spectrum"}, {}, {"ft": True})[i % 4]))
runs = []
for mesh in (make_fft_mesh(1), None):
    with ServeRuntime(RuntimeConfig(max_batch=4, deadline_ms=60000.0),
                      mesh=mesh) as rt:
        for x, kw in reqs[:4]:          # admission warms up on this thread
            rt.admit(rt.bucketer.key_for(x.shape, x.dtype, **kw))
        seen.clear()
        hs = [rt.submit(torch.from_numpy(x).to(dev) if i % 2 else x,
                        faults=Fault(col=7, eps_re=300.0) if i == 3 else None,
                        **kw) for i, (x, kw) in enumerate(reqs)]
        rt.drain()
        ys = [torch.as_tensor(h.result(timeout=120)).cpu() for h in hs]
        runs.append({"ys": ys, "local": rt.channel is None,
                     "corrected": [h.info.get("corrected") for h in hs],
                     "threads": sorted({t for t, _ in seen}),
                     "streams": sorted({s for _, s in seen}),
                     "on_card": [torch.is_tensor(h.result()) and
                                 h.result().is_cuda for h in hs]})
dist.destroy_process_group()
a, b = runs
print(json.dumps({
    "bitwise": all(torch.equal(x, y) for x, y in zip(a["ys"], b["ys"])),
    "local": [a["local"], b["local"]],
    "corrected": [a["corrected"], b["corrected"]],
    "threads": [a["threads"], b["threads"]],
    "streams": [len(a["streams"]), len(b["streams"])],
    "default_stream": torch.cuda.default_stream(dev).cuda_stream in
    a["streams"] + b["streams"],
    "on_card": a["on_card"]}))
"""


def test_serve_runtime_over_a_one_rank_nccl_mesh_is_the_local_runtime(cuda):
    """In a fresh process with one NCCL rank: ``ServeRuntime(mesh=
    make_fft_mesh(1))`` is the local runtime (no command channel), serves
    the same requests bitwise equal to ``ServeRuntime()``, on its two
    workers' own streams, card requests coming back on the card, the ft
    request's SEU corrected."""
    out = subprocess.run([sys.executable, "-c", _NCCL_ONE_RANK],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(_REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bitwise"] and res["local"] == [True, True], res
    assert res["corrected"][0] == res["corrected"][1]
    assert res["corrected"][0][3] == 1
    assert res["threads"] == [["serve-worker-0", "serve-worker-1"]] * 2
    assert res["streams"] == [2, 2] and not res["default_stream"]
    assert res["on_card"] == [bool(i % 2) for i in range(24)]


_MESH_CLIENT_STREAM = r"""
import json, sys, tempfile
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store, out):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=2)
    from repro_torch.launch.mesh import make_fft_mesh
    from repro_torch.serve import RuntimeConfig, ServeRuntime

    dev = torch.device("cuda", 0)
    rt = ServeRuntime(RuntimeConfig(max_batch=1, deadline_ms=60000.0),
                      mesh=make_fft_mesh(2))
    if rank == 0:
        s = torch.cuda.Stream(dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        rows = []
        with torch.cuda.stream(s):
            xs = [torch.randn(8192, dtype=torch.complex64, device=dev,
                              generator=gen) for _ in range(12)]
            refs = [torch.fft.fft(x) for x in xs]
            for x, ref in zip(xs, refs):
                y = rt.submit(x).result(timeout=120)
                # read the result on this stream, behind a long kernel,
                # and drop it while that read is queued: the next batch
                # runs meanwhile
                before = y.abs().square().sum()
                torch.cuda._sleep(50_000_000)
                after = y.abs().square().sum()
                err = (y - ref).abs().max() / ref.abs().max()
                rows.append((before, after, err))
                del y
        s.synchronize()
        res = {"same": [bool(torch.equal(a, b)) for a, b, _ in rows],
               "err": max(float(e) for _, _, e in rows),
               "streams": s.cuda_stream != torch.cuda.default_stream(
                   dev).cuda_stream}
        with open(out, "w") as f:
            json.dump(res, f)
    rt.close()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(run, args=(tempfile.mktemp(), sys.argv[1]), nprocs=2)
"""


def test_serve_runtime_over_a_mesh_keeps_a_card_result_for_its_stream(
        cuda, tmp_path):
    """Two gloo ranks on the card, a runtime over a mesh of 2 (one request
    a batch): the leader's client works on its own stream, reads each
    result there behind a long kernel and drops it while that read is
    queued, and the next batch runs meanwhile. Every read sees the value
    it read before the kernel (the result's memory is not handed to the
    next batch while the client's stream still reads it), and every result
    is torch.fft's."""
    script, out = tmp_path / "client_stream.py", tmp_path / "res.json"
    script.write_text(_MESH_CLIENT_STREAM)
    run = subprocess.run([sys.executable, str(script), str(out)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(_REPO / "src")))
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["streams"] and all(res["same"]), res
    assert res["err"] < ATOL[torch.complex64], res


# ---- the MoE FFN and MLA (DeepSeek-V3, Llama-4 Maverick) ------------------

MOE_ARCHS = ["deepseek_v3_671b", "llama4_maverick"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_and_mla_smoke_on_the_card_match_the_cpu(cuda, arch):
    """The MoE models' SMOKE configs at float32, unprotected: the MoE block
    and (DeepSeek) MLA alone, then the forward and 6 decode steps on the
    card against the port on the CPU, within 1e-3 x max|cpu|."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model, attention, moe

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    mp = moe.make_moe_params(gen, cfg, device="cpu")
    want, waux = moe.moe_block(mp, x, cfg)
    got, gaux = moe.moe_block(_tree_to(mp, cuda), x.to(cuda), cfg)
    tol = 1e-3 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    assert abs(float(gaux) - float(waux)) <= 1e-5 * float(waux)
    if cfg.kv_lora_rank:
        ap = attention.make_mla_params(gen, cfg, device="cpu")
        pos = torch.arange(16)
        want, _ = attention.mla_attention(ap, x, cfg=cfg, positions=pos)
        got, _ = attention.mla_attention(_tree_to(ap, cuda), x.to(cuda),
                                         cfg=cfg, positions=pos.to(cuda))
        tol = 1e-3 * want.abs().max().item()
        assert (got.cpu() - want).abs().max().item() <= tol
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)), dtype=torch.int32)
    want, _ = m.apply(params, {"tokens": toks}, block_q=8)
    got, _ = m.apply(gparams, {"tokens": toks.to(cuda)}, block_q=8)
    tol = 1e-3 * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    caches = {"cpu": m.init_cache(2, 8, dtype=torch.float32, device="cpu"),
              "cuda": m.init_cache(2, 8, dtype=torch.float32, device=cuda)}
    for i in range(6):
        lc, caches["cpu"], _ = m.decode_step(params, caches["cpu"],
                                             toks[:, i:i + 1], i)
        lg, caches["cuda"], _ = m.decode_step(gparams, caches["cuda"],
                                              toks[:, i:i + 1].to(cuda), i)
        tol = 1e-3 * lc.abs().max().item()
        assert (lg.cpu() - lc).abs().max().item() <= tol, i


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_protected_moe_decode_step_launch_counts(cuda, arch):
    """The MoE models' SMOKE configs, every linear protected (their 40- and
    48-wide products zero-padded to the kernel's tiles): one decode step
    launches ``ft_matmul`` 7 times a layer (MLA's or attention's 4, then
    the dense FFN's or the shared expert's 3) and calls the eager batched
    product 3 times a MoE layer (the routed experts) and the eager 2-D
    path never; its logits agree with the CPU's, and a fault at site 1 of
    every block is corrected in each."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.models import Model
    from repro_torch.models.transformer import effective_kinds

    base = get_smoke_config(arch)
    cfg = dataclasses.replace(base, dtype="float32", ft=dataclasses.replace(
        base.ft, protect_linears=True, threshold=1e-3))
    moe_layers = sum(k.endswith("|moe") for k in effective_kinds(cfg))
    assert moe_layers > 0
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    gparams = _tree_to(params, cuda)
    toks = torch.tensor([[5], [77], [300], [511]], dtype=torch.int32)
    want, _, _ = m.decode_step(params, m.init_cache(4, 8, device="cpu"),
                               toks, 0)
    eager, batched = abft_gemm.ft_matmul, abft_gemm.ft_matmul_batched
    calls = {"eager": 0, "batched": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    abft_gemm.ft_matmul = count("eager", eager)
    abft_gemm.ft_matmul_batched = count("batched", batched)
    try:
        for inject in (None, torch.tensor([[1.0, 2.0, 9.0, 1.0, 60.0]],
                                          device=cuda)):
            before = ft_matmul.launches
            calls["batched"] = 0
            got, _, aux = m.decode_step(
                gparams, m.init_cache(4, 8, device=cuda), toks.to(cuda), 0,
                inject=inject)
            assert ft_matmul.launches - before == 7 * cfg.num_layers
            assert calls["batched"] == 3 * moe_layers
            faults = 0 if inject is None else cfg.num_layers
            assert float(aux["ft_flagged"]) == faults
            assert float(aux["ft_corrected"]) == faults
            tol = 1e-3 * want.abs().max().item()
            assert (got.cpu() - want).abs().max().item() <= tol
    finally:
        abft_gemm.ft_matmul, abft_gemm.ft_matmul_batched = eager, batched
    assert calls["eager"] == 0


def test_ft_matmul_batched_on_the_card_matches_the_cpu(cuda):
    """The routed experts' checked product (E, C, d) @ (E, d, f) on the
    card: y and the per-expert stats of the CPU's, a fault an expert
    corrected."""
    from repro_torch.core.abft import gemm as abft_gemm

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 8, 256, generator=gen).to(torch.bfloat16)
    w = torch.randn(8, 256, 128, generator=gen)
    inj = torch.stack([torch.tensor([[float(e % 8), float(3 * e), 50.0]])
                       for e in range(8)])
    want, ws = abft_gemm.ft_matmul_batched(x, w, inject=inj)
    got, gs = abft_gemm.ft_matmul_batched(x.to(cuda), w.to(cuda),
                                          inject=inj.to(cuda))
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -7 * want.float().abs().max().item()
    assert (got.cpu().float() - want.float()).abs().max().item() <= tol
    for key in ("flagged", "corrected", "uncorrectable"):
        assert gs[key].cpu().tolist() == ws[key].tolist() == (
            [1.0] * 8 if key != "uncorrectable" else [0.0] * 8), key



@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_fused_linear_gradients_match_the_eager_path(cuda, xdtype):
    """The protected linear under autograd on the card: the fused path
    (``core.gemm.api._FusedLinear``: one ``ft_matmul`` launch forward, the
    float32 product's gradient backward, no launch) against autograd
    through the eager path, with one SEU corrected on each. grad_x comes
    back in x's dtype, grad_w in float32; each within 1e-5 x max (float32)
    or one bf16 step (2^-8 x max) of the eager path's."""
    from repro_torch.core.ft import FTPolicy
    from repro_torch.models.layers import FTContext, dense

    gen = torch.Generator(device=cuda).manual_seed(3)
    x0 = torch.randn((2, 64, 256), generator=gen, device=cuda).to(xdtype)
    w0 = torch.randn((256, 384), generator=gen, device=cuda)
    g = torch.randn((2, 64, 384), generator=gen, device=cuda).to(xdtype)
    out = {}
    for backend in ("fused", "eager"):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        ctx = FTContext(FTPolicy(protect_linears=True, gemm_backend=backend),
                        inject=torch.tensor([[0.0, 70.0, 9.0, 1.0, 50.0]],
                                            device=cuda))
        before = ft_matmul.launches
        y = dense({"w": w}, x, ft=ctx)
        forward = ft_matmul.launches - before
        y.backward(g)
        torch.cuda.synchronize()
        assert forward == (backend == "fused")
        assert ft_matmul.launches - before == forward
        assert float(ctx.summary()["ft_corrected"]) == 1
        assert x.grad.dtype == xdtype and w.grad.dtype == torch.float32
        out[backend] = (x.grad.float(), w.grad)
    tol = 1e-5 if xdtype == torch.float32 else 2.0 ** -8
    for got, want in zip(out["fused"], out["eager"]):
        assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_protected_train_step_launches_ft_matmul_only_forward(cuda):
    """One train step of a tile-aligned dense model at float32, every
    linear protected: 7 x layers ``ft_matmul`` launches, all in the
    forward, no eager ABFT call; its loss and gradients those of the eager
    path and of the unprotected step (loss 1e-5 relative, each gradient
    leaf 1e-4 x its max)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.abft import gemm as abft_gemm
    from repro_torch.models import Model
    from repro_torch.train import loop

    base = get_smoke_config("phi4_mini_3p8b")
    cfg = dataclasses.replace(
        base, dtype="float32", num_layers=3, d_model=256, num_heads=4,
        num_kv_heads=2, head_dim=64, d_ff=512)
    params = Model(cfg).init(torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen,
                         device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    eager = abft_gemm.ft_matmul
    calls = []
    abft_gemm.ft_matmul = lambda *a, **k: calls.append(1) or eager(*a, **k)
    res = {}
    try:
        for backend in ("fused", "eager", "none"):
            c = cfg if backend == "none" else dataclasses.replace(
                cfg, ft=dataclasses.replace(cfg.ft, protect_linears=True,
                                            gemm_backend=backend))
            before, n_calls = ft_matmul.launches, len(calls)
            with torch.no_grad():
                loop._loss_fn(Model(c), params, batch, block_q=0,
                              remat="none")
            forward = ft_matmul.launches - before
            (total, (_, aux)), grads = loop._value_and_grad(
                Model(c), params, batch, block_q=0, remat="none")
            torch.cuda.synchronize()
            launches = ft_matmul.launches - before - forward
            assert (forward, launches) == ((7 * 3, 7 * 3) if backend == "fused"
                                           else (0, 0))
            assert (len(calls) - n_calls > 0) == (backend == "eager")
            assert float(aux["ft_flagged"]) == 0
            res[backend] = (float(total), grads)
    finally:
        abft_gemm.ft_matmul = eager

    def leaves(t):
        return [v for x in t.values() for v in leaves(x)] \
            if isinstance(t, dict) else [t]

    for other in ("eager", "none"):
        assert abs(res["fused"][0] - res[other][0]) <= 1e-5 * abs(
            res[other][0])
        for got, want in zip(leaves(res["fused"][1]), leaves(res[other][1])):
            assert (got - want).abs().max().item() <= \
                1e-4 * want.abs().max().item()


_NCCL_LM_ONE_RANK = r"""
import dataclasses, json, socket
import torch
import torch.distributed as dist
from repro_torch import optim
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ParallelConfig, RunConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Model, moe
from repro_torch.parallel import sharding
from repro_torch.train import make_train_step
from repro_torch.tree import leaves, tree_map

dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                        rank=0, world_size=1, device_id=dev)
mesh = make_host_mesh(1, 1)
res = {"mesh": [list(mesh.mesh_dim_names), list(mesh.shape)]}
cfg = dataclasses.replace(get_smoke_config("deepseek_v3_671b"),
                          num_layers=2, dtype="float32")
gen = torch.Generator(device=dev).manual_seed(0)
p = moe.make_moe_params(gen, cfg, device=dev)
x = torch.randn((4, 256, cfg.d_model), generator=gen, device=dev)
calls = [0]
ep = moe.moe_block_ep


def counted(*a, **k):
    calls[0] += 1
    return ep(*a, **k)


moe.moe_block_ep = counted
with torch.no_grad():
    y0, a0 = moe._moe_block_portable(p, x, cfg)
    with sharding.use_mesh(mesh):
        y1, a1 = moe.moe_block(p, x, cfg)
res["ep_calls"] = calls[0]
res["ep_bitwise"] = bool(torch.equal(y0, y1)) and bool(torch.equal(a0, a1))
model = Model(cfg)
run = RunConfig(model=cfg, parallel=ParallelConfig(remat="none"),
                learning_rate=1e-3, warmup_steps=2, total_steps=20)
params = model.init(torch.Generator(device=dev).manual_seed(1), device=dev)
toks = torch.randint(0, cfg.vocab_size, (2, 513), generator=gen,
                     device=dev)
batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
outs = []
for m in (None, None, mesh):
    pp = tree_map(lambda t: t.clone(), params)
    st = optim.init_state(pp)
    step = make_train_step(model, run, m)
    ms = []
    for s in range(2):
        pp, st, met = step(pp, st, batch, s)
        ms.append({k: float(v) for k, v in met.items()})
    outs.append((pp, st, ms))
res["ep_calls_step"] = calls[0] - res["ep_calls"]
(a, sa, ma), (a2, sa2, _), (b, sb, mb) = outs
res["metrics_equal"] = ma == mb
# the unsharded step's own run-to-run difference (the embedding's
# gradient accumulates in an order that may change between runs)
res["params_close"] = all(
    (u - v).abs().max() <= 1e-5 * u.abs().max() for u, v in
    zip(leaves((a, sa)), leaves((b, sb))))
res["bitwise_leaves"] = sum(torch.equal(u, v) for u, v in
                            zip(leaves((a, sa)), leaves((b, sb))))
res["repeatable_leaves"] = sum(torch.equal(u, w) for u, w in
                               zip(leaves((a, sa)), leaves((a2, sa2))))
dist.destroy_process_group()
print(json.dumps(res))
"""


def test_lm_parallel_on_a_one_rank_nccl_mesh(cuda):
    """In a fresh process with one NCCL rank and ``make_host_mesh(1, 1)``:
    ``moe_block`` under ``use_mesh`` takes the expert-parallel path at
    DeepSeek-V3 SMOKE (1024 tokens) and is bitwise the portable path; two
    sharded train steps of DeepSeek SMOKE (EP inside) give the unsharded
    step's metrics bitwise, and its params and moments bitwise on as many
    leaves as two unsharded runs agree on bitwise (the embedding's
    gradient accumulates in an order that may change between runs), the
    others within 1e-5 x max."""
    out = subprocess.run([sys.executable, "-c", _NCCL_LM_ONE_RANK],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(_REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["mesh"] == [["data", "model"], [1, 1]]
    assert res["ep_calls"] == 1 and res["ep_bitwise"], res
    assert res["ep_calls_step"] > 0
    assert res["metrics_equal"] and res["params_close"], res
    assert res["bitwise_leaves"] >= res["repeatable_leaves"], res
