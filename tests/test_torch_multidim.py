"""The port's local multi-dimensional transforms against the reference on
the same numpy inputs, and their launches.

* ``plan(FFTSpec(rank=2|3)).fft/ifft`` against the reference's local
  ``distributed_fft2/fftn`` (mesh=None), mirroring
  ``tests/test_fft_multidim.py``'s local cases (power-of-two, odd, rank 3,
  ``fft_convolve2``);
* the real rank-2 plans (``rfft2``/``irfft2``) against the reference's,
  mirroring the local cases of ``tests/test_fft_real.py`` (spec
  validation, dtype policy, executor guards, power-of-two and odd grids);
* the launches, on the CPU through a dispatch spy: ``fft2`` of (B, R, C)
  is exactly two ``block_fft`` calls, the second over the strided columns
  in place (``axis_layout``), with no copy of the operand; rank 3 is three;
  a numpy model of ``axis_layout`` reaches every element of the operand
  once, in the order of a moved axis; a non-last axis over 8192 points
  takes the copy path; an odd column count takes one signal a tile.

Everything runs on the CPU (``device="cpu"``: the block kernel's plain
version). Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5
complex64, 1e-11 complex128; rank 3 twice that, as the reference's test).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

from repro.core.fft import api as ref_api
from repro.core.fft import extensions as ref_ext
from repro.core.fft import multidim as ref_md

from repro_torch.core.fft import FFTSpec, FTConfig, extensions, plan, spec_for
from repro_torch.core.fft import multidim
from repro_torch.core.fft.plan import axis_layout, make_plan
from repro_torch.kernels import ops, stockham

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _plan(shape, dtype=np.complex64, **kw):
    return plan(FFTSpec(shape=shape, dtype=dtype, device=CPU, **kw))


# ---------------------------------------------------------------------------
# C2C rank 2 and 3 against the reference's local path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 128), (32, 256), (256, 32)])
def test_local_fft2_matches_reference(shape, crand, assert_spectrum_close):
    x = crand(2 * shape[0], shape[1]).reshape((2,) + shape)
    p = _plan(x.shape, rank=2)
    got = p.fft2(_t(x))
    assert_spectrum_close(got.numpy(), np.asarray(ref_md.distributed_fft2(x)))
    assert_spectrum_close(got.numpy(), np.fft.fft2(x))
    back = p.ifft2(got)
    assert_spectrum_close(back.numpy(), np.asarray(
        ref_md.distributed_ifft2(ref_md.distributed_fft2(x))))
    assert_spectrum_close(back.numpy(), x)


@pytest.mark.parametrize("shape", [(12, 30), (15, 64), (64, 21)])
def test_local_fft2_odd_sizes(shape, rng, assert_spectrum_close):
    """Odd / non-power-of-two axes run the direct DFT."""
    x = (rng.standard_normal((2,) + shape)
         + 1j * rng.standard_normal((2,) + shape)).astype(np.complex64)
    p = _plan(x.shape, rank=2)
    got = p.fft(_t(x))
    assert_spectrum_close(got.numpy(), np.asarray(ref_md.distributed_fft2(x)))
    assert_spectrum_close(p.ifft(got).numpy(), x)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_local_fftn3_and_roundtrip(dtype, crand, assert_spectrum_close):
    x = crand(2 * 8 * 16, 32, dtype=dtype).reshape(2, 8, 16, 32)
    p = _plan(x.shape, dtype, rank=3)
    got = p.fftn(_t(x))
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    want = np.asarray(ref_md.distributed_fftn(x, ndim=3))
    assert_spectrum_close(got.numpy(), want, factor=2)
    assert_spectrum_close(got.numpy(), np.fft.fftn(x, axes=(-3, -2, -1)),
                          factor=2)
    back = p.ifftn(_t(want))
    assert_spectrum_close(back.numpy(), np.asarray(
        ref_md.distributed_ifftn(jnp.asarray(want), ndim=3)), factor=2)
    assert_spectrum_close(back.numpy(), x, factor=2)


def test_fftn_validation():
    with pytest.raises(ValueError, match="rank"):
        FFTSpec(shape=(2, 8, 8), rank=4, device=CPU)
    with pytest.raises(ValueError, match="fewer axes"):
        FFTSpec(shape=(8,), rank=2, device=CPU)
    with pytest.raises(ValueError, match="needs a mesh with an 'fft' axis"):
        FFTSpec(shape=(2, 8, 8), rank=2, ft=FTConfig(), device=CPU)
    with pytest.raises(ValueError, match="rank=3 has no ft"):
        FFTSpec(shape=(2, 8, 8, 8), rank=3, ft=FTConfig(), device=CPU)
    with pytest.raises(ValueError, match="fft2 needs a rank>=2"):
        _plan((2, 64)).fft2(torch.zeros((2, 64), dtype=torch.complex64))
    with pytest.raises(ValueError, match="transform axes"):
        _plan((2, 8, 8), rank=2).fft(torch.zeros((2, 8, 16)))
    with pytest.raises(ValueError, match="no FTConfig"):
        _plan((2, 8, 8), rank=2).ft_fft(torch.zeros((2, 8, 8)))


def test_ops_and_extensions_agree(crand, assert_spectrum_close):
    """``kernels.ops.fft2``, ``core.fft.extensions.fft2`` and the rank-2
    plan are one path, and agree with the reference's."""
    x = crand(2 * 32, 64).reshape(2, 32, 64)
    want = np.asarray(ref_ext.fft2(jnp.asarray(x)))
    for got in (ops.fft2(_t(x), device=CPU),
                extensions.fft2(_t(x), device=CPU),
                _plan(x.shape, rank=2).fft2(_t(x))):
        assert_spectrum_close(got.numpy(), want)
    assert_spectrum_close(ops.ifft2(_t(want), device=CPU).numpy(), x)


def test_fft_convolve2_local_matches_reference(rng):
    a = rng.standard_normal((2, 20, 24)).astype(np.float32)
    v = rng.standard_normal((5, 7)).astype(np.float32)
    for mode in ("full", "same", "valid"):
        got = multidim.fft_convolve2(_t(a), _t(v), mode=mode, device=CPU)
        want = np.asarray(ref_md.fft_convolve2(a, v, mode=mode))
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want.shape, mode
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=4e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fft_convolve2_complex_and_per_signal(dtype, crand,
                                              assert_spectrum_close):
    a = crand(3 * 12, 16, dtype).reshape(3, 12, 16)
    v = crand(3 * 3, 5, dtype).reshape(3, 3, 5)
    for mode in ("full", "same", "valid"):
        got = multidim.fft_convolve2(_t(a), _t(v), mode=mode, device=CPU)
        want = np.asarray(ref_md.fft_convolve2(a, v, mode=mode))
        assert got.dtype == getattr(torch, np.dtype(dtype).name)
        assert tuple(got.shape) == want.shape, mode
        assert_spectrum_close(got.numpy(), want)


def test_fft_convolve2_mesh_and_plan_checks(rng):
    a = _t(rng.standard_normal((2, 20, 24)).astype(np.float32))
    v = _t(rng.standard_normal((5, 7)).astype(np.float32))
    with pytest.raises(ValueError, match="has no 'fft' axis"):
        multidim.fft_convolve2(a, v, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="2-D operands"):
        multidim.fft_convolve2(a[0, 0], v, device=CPU)
    p = _plan((2, 16, 32), rank=2, real=True)
    with pytest.raises(ValueError, match=r"need a \(32, 32\) plan"):
        p.convolve(a, v)
    with pytest.raises(ValueError, match="rank 1 and 2"):
        _plan((2, 8, 8, 8), rank=3).convolve(a, v)


# ---------------------------------------------------------------------------
# real rank-2 plans (the local cases of test_fft_real.py)
# ---------------------------------------------------------------------------


def test_real_spec_validation():
    with pytest.raises(ValueError, match="rank=3"):
        FFTSpec(shape=(8, 16, 32), rank=3, real=True, device=CPU)
    with pytest.raises(ValueError, match="no ft pipeline"):
        FFTSpec(shape=(4, 1024), ft=FTConfig(), real=True, device=CPU)
    # the reference's rank-2 real ABFT runs on a mesh only
    with pytest.raises(ValueError, match="rfft2 runs .* needs a mesh"):
        FFTSpec(shape=(8, 32, 64), rank=2, ft=FTConfig(), real=True,
                device=CPU)
    with pytest.raises(ValueError, match="rank=3"):
        ref_api.FFTSpec(shape=(8, 16, 32), rank=3, real=True)


def test_spec_for_real_dtype_policy():
    x32 = torch.zeros((2, 64), dtype=torch.float32)
    x64 = torch.zeros((2, 64), dtype=torch.float64)
    assert spec_for(x32, real=True, device=CPU).dtype == "complex64"
    assert spec_for(x64, real=True, device=CPU).dtype == "complex128"
    assert spec_for(x64, device=CPU).dtype == "complex64"
    assert spec_for(x32, real=True).real and not spec_for(x32).real
    for x in (np.zeros((2, 64), np.float32), np.zeros((2, 64))):
        assert spec_for(x, real=True, device=CPU).dtype \
            == ref_api.spec_for(x, real=True).dtype


def test_plan_executor_guards(rng):
    preal = _plan((2, 32, 64), rank=2, real=True)
    pc2c = _plan((2, 32, 64), rank=2)
    x = _t(rng.standard_normal((2, 32, 64)).astype(np.float32))
    with pytest.raises(ValueError, match="real-input"):
        preal.fft(x)
    with pytest.raises(ValueError, match="real-input"):
        preal.ifft(x)
    with pytest.raises(ValueError, match="real=True"):
        pc2c.rfft(x)
    with pytest.raises(ValueError, match="real=True"):
        pc2c.irfft(x)
    with pytest.raises(ValueError, match="real operand"):
        preal.rfft(x.to(torch.complex64))
    with pytest.raises(ValueError, match="half-spectrum"):
        preal.irfft(torch.zeros((2, 32, 64), dtype=torch.complex64))
    with pytest.raises(ValueError, match="rank-2"):
        _plan((2, 1024), real=True).rfft2(x[:, 0])


@pytest.mark.parametrize("shape", [(64, 128), (32, 256), (256, 32)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_local_rfft2_matches_reference(shape, dtype, rng,
                                       assert_spectrum_close):
    x = rng.standard_normal((3,) + shape).astype(dtype)
    p = plan(spec_for(_t(x), rank=2, real=True, device=CPU))
    want = np.asarray(ref_api.plan(ref_api.spec_for(x, rank=2, real=True))
                      .rfft2(x))
    got = p.rfft2(_t(x))
    assert tuple(got.shape) == (3,) + shape[:-1] + (shape[-1] // 2 + 1,)
    assert_spectrum_close(got.numpy(), want)
    assert_spectrum_close(got.numpy(), np.fft.rfft2(x))
    back = p.irfft2(got)
    assert back.dtype == getattr(torch, np.dtype(dtype).name)
    assert_spectrum_close(back.numpy(), x)


@pytest.mark.parametrize("shape", [(12, 30), (15, 64), (64, 22)])
def test_local_rfft2_odd_sizes(shape, rng, assert_spectrum_close):
    """Odd / non-power-of-two axes run the direct DFT."""
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    got = extensions.rfft2(_t(x), device=CPU)
    assert_spectrum_close(got.numpy(), np.asarray(ref_ext.rfft2(x)))
    back = extensions.irfft2(got, device=CPU)
    assert_spectrum_close(back.numpy(), np.asarray(ref_ext.irfft2(
        jnp.asarray(got.numpy()))))
    assert_spectrum_close(back.numpy(), x)


@pytest.mark.parametrize("cols", [27, 33])
def test_local_rfft2_odd_columns(cols, rng, assert_spectrum_close):
    """An odd column count: direct DFT over the columns, then one launch
    over the (C+1)/2 strided columns; the plan's inverse reconstructs the
    odd width."""
    x = rng.standard_normal((2, 16, cols)).astype(np.float32)
    p = plan(spec_for(_t(x), rank=2, real=True, device=CPU))
    rp = ref_api.plan(ref_api.spec_for(x, rank=2, real=True))
    got = p.rfft2(_t(x))
    assert_spectrum_close(got.numpy(), np.asarray(rp.rfft2(x)))
    back = p.irfft2(got)
    assert tuple(back.shape) == x.shape
    assert_spectrum_close(back.numpy(), np.asarray(rp.irfft2(
        jnp.asarray(got.numpy()))))
    assert_spectrum_close(back.numpy(), x)


def test_extensions_rfft2_rejects_complex(crand):
    with pytest.raises(ValueError, match="real input"):
        extensions.rfft2(_t(crand(2, 64).reshape(2, 8, 8)), device=CPU)
    with pytest.raises(ValueError, match="single-bin"):
        extensions.irfft2(torch.zeros((2, 8, 1), dtype=torch.complex64),
                          device=CPU)


# ---------------------------------------------------------------------------
# launches: one block_fft per axis, in place, no copy
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """Records every aten operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


# allocating the output and viewing the operand
_ALLOWED = {"aten.empty_like", "aten.empty", "aten.view", "aten.alias",
            "aten._reshape_alias", "aten._unsafe_view"}


def _spy(monkeypatch):
    calls = []

    def spy(x, stages, *, inverse, scale, tables, layout=None, twiddle=None,
            out=None):
        out = torch.empty_like(x) if out is None else out
        calls.append(dict(stages=stages, tables=tables, layout=layout,
                          scale=scale, inverse=inverse, src=x.data_ptr(),
                          dst=out.data_ptr()))
        return out

    monkeypatch.setattr(ops, "block_fft", spy)
    return calls


@pytest.mark.parametrize("inverse", [False, True])
def test_fft2_is_two_block_fft_launches_in_place(monkeypatch, inverse):
    b, r, c = 3, 64, 128
    p = _plan((b, r, c), rank=2)
    calls = _spy(monkeypatch)
    x = torch.zeros((b, r, c), dtype=torch.complex64)
    with _Ops() as rec:
        y = p.ifft2(x) if inverse else p.fft2(x)
    assert set(rec.ops) <= _ALLOWED, rec.ops
    assert len(calls) == 2
    rows, cols = calls
    # the last axis: contiguous rows of x into a new tensor
    assert rows["layout"] is None and rows["src"] == x.data_ptr()
    # axis -2: one launch over the strided columns of that tensor, in place
    assert cols["layout"] == axis_layout(b, r, c)
    assert cols["src"] == cols["dst"] == rows["dst"] == y.data_ptr()
    for call, ax in zip((cols, rows), p.axes):
        assert call["stages"] is ax.plan.stages[0]
        assert call["tables"] is ax.tables[inverse][0]
        assert call["inverse"] == inverse
        n = ax.plan.n
        assert call["scale"] == pytest.approx(1.0 / n if inverse else 1.0)


def test_fftn3_is_three_block_fft_launches(monkeypatch):
    shape = (2, 8, 16, 32)
    p = _plan(shape, rank=3)
    calls = _spy(monkeypatch)
    x = torch.zeros(shape, dtype=torch.complex64)
    with _Ops() as rec:
        y = p.fftn(x)
    assert set(rec.ops) <= _ALLOWED, rec.ops
    assert [c["layout"] for c in calls] == [None, axis_layout(16, 16, 32),
                                            axis_layout(2, 8, 16 * 32)]
    assert all(c["src"] == c["dst"] == y.data_ptr() for c in calls[1:])


def test_rfft2_launches(monkeypatch):
    """rfft2: one half-length launch over the packed rows, then one launch
    over the C/2+1 strided columns of the half spectrum, in place;
    irfft2: the columns first (into a new tensor), then the packed rows in
    place."""
    b, r, c = 2, 32, 64
    p = _plan((b, r, c), rank=2, real=True)
    calls = _spy(monkeypatch)
    y = p.rfft2(torch.zeros((b, r, c)))
    assert [k["layout"] for k in calls] == [None,
                                            axis_layout(b, r, c // 2 + 1)]
    assert calls[1]["src"] == calls[1]["dst"] == y.data_ptr()
    calls.clear()
    p.irfft2(y)
    assert [k["layout"] for k in calls] == [axis_layout(b, r, c // 2 + 1),
                                            None]
    assert calls[1]["src"] == calls[1]["dst"]
    assert calls[0]["scale"] == pytest.approx(1.0 / r)
    assert calls[1]["scale"] == pytest.approx(2.0 / c)


def _layout_addresses(layout, n):
    """The storage index of point p of every signal, in the kernel's
    signal order (the last axis fastest), as a (signals, n) array."""
    idx = np.zeros((1,), np.int64)
    for count, stride, _ in layout.axes:
        idx = (idx[:, None] + stride * np.arange(count)[None, :]).ravel()
    return idx[:, None] + layout.point_in * np.arange(n)[None, :]


@pytest.mark.parametrize("shape,axis", [((3, 64, 128), -2), ((5, 16, 33), -2),
                                        ((1, 64, 8), -2), ((2, 8, 16, 32), -3),
                                        ((8, 16, 32), -3), ((4, 7, 9), -1)])
def test_axis_layout_reaches_every_element_once(shape, axis):
    """A numpy model of the launch: the signals of ``axis_layout`` are the
    operand with ``axis`` moved last, element for element, reading and
    writing the same places."""
    ax = axis % len(shape)
    lead = math.prod(shape[:ax])
    inner = math.prod(shape[ax + 1:])
    n = shape[ax]
    lay = axis_layout(lead, n, inner)
    assert lay.point_in == lay.point_out
    assert all(a[1] == a[2] for a in lay.axes)
    got = _layout_addresses(lay, n)
    want = np.moveaxis(np.arange(math.prod(shape)).reshape(shape), ax,
                       -1).reshape(-1, n)
    np.testing.assert_array_equal(got, want)
    assert stockham._reach(lay, n, 1) == math.prod(shape)
    if inner == 1:
        assert lay == stockham._rows(lead, n)


@pytest.mark.parametrize("cols,sigs,vec", [(2049, 1, 0), (33, 1, 0),
                                           (4096, 2, 1), (6, 2, 1)])
def test_odd_column_count_takes_one_signal_a_tile(cols, sigs, vec):
    """A CTA's tile never straddles two rows of columns: at an odd column
    count (rfft2's C/2+1) it holds one signal, and the 16-byte path of
    neighbouring signals is off (the scalar column path)."""
    lay = axis_layout(4, 4096, cols)
    desc = stockham._launch_desc(lay, 4096, True, True)[0]
    assert desc[12] == sigs == stockham._tile_signals(4096, lay)
    assert lay.fast_count % sigs == 0
    assert desc[14] == desc[15] == vec


def test_long_non_last_axis_takes_the_copy_path(monkeypatch, crand,
                                                assert_spectrum_close):
    """A non-last axis over 8192 points is moved last (one copy), run as
    its passes, and moved back (a second copy)."""
    b, r, c = 2, 1 << 14, 4
    p = _plan((b, r, c), rank=2)
    x = crand(b * r, c).reshape(b, r, c)
    want = np.fft.fft2(x)
    assert_spectrum_close(p.fft2(_t(x)).numpy(), want)
    calls = _spy(monkeypatch)
    x = torch.zeros((b, r, c), dtype=torch.complex64)
    with _Ops() as rec:
        p.fft2(x)
    passes = make_plan(r).num_passes
    assert passes == 2 and len(calls) == 1 + passes
    copies = [op for op in rec.ops if op not in _ALLOWED]
    assert sorted(copies) == ["aten.clone", "aten.copy_", "aten.permute",
                              "aten.permute"], rec.ops
