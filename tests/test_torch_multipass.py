"""The multi-pass FFT as one block-FFT launch per pass, on the CPU.

Each pass of a 2- or 3-pass plan is one launch in the layout
``pass_layouts`` gives it; on a CPU tensor the launch runs the kernel's
plain version (strided torch views, the same composition the card runs).
Held here, on numpy inputs from a seed:

* each pass's launch against an independent numpy model of that pass
  (FFT along one axis of the tiled signal, the pass twiddle, the last pass's
  transposed write), forward and inverse;
* the whole transform against ``np.fft`` and the reference's
  ``repro.core.fft.stockham.fft``/``ifft`` (not ``repro.kernels.ops.ifft``,
  whose multi-pass inverse is scaled twice);
* the split-exponent pass-twiddle tables against float64 ``exp``;
* ``_fft_multipass``: exactly one ``block_fft`` call per pass and no other
  tensor operation on the data.

Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11
complex128) through ``assert_spectrum_close``.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core.fft import stockham as ref_stockham

from repro_torch.core.fft import FFTSpec, factors, make_plan, plan
from repro_torch.core.fft.plan import PassLayout, pass_layouts
from repro_torch.kernels import ops
from repro_torch.kernels.stockham import block_fft, pass_twiddle_table

CPU = "cpu"
SIZES = [1 << 14, 1 << 17, 1 << 23]


def _batch(n):
    return 1 if n > 1 << 20 else 2


def _dft(z, axis, inverse):
    """Unnormalized DFT along ``axis`` (the kernel's inverse is too)."""
    if inverse:
        return np.fft.ifft(z, axis=axis) * z.shape[axis]
    return np.fft.fft(z, axis=axis)


def _twiddle(rows, cols, inverse):
    """w_M^(k*i), M = rows*cols, k < rows, i < cols, in float64."""
    sign = 1.0 if inverse else -1.0
    e = (np.arange(rows)[:, None] * np.arange(cols)[None, :]) % (rows * cols)
    return np.exp(sign * 2j * np.pi * e / (rows * cols))


def _numpy_passes(x, facs, inverse):
    """The storage after each pass of the N1 x N2 (x N3) transform, modelled
    in numpy on (B, f1, f2[, f3]) views: pass i transforms axis i + 1 and
    multiplies by the twiddle of that axis against the later ones; the last
    pass writes k = k1 + f1*k2 (+ f1*f2*k3). 1/N rides the first pass."""
    b, n = x.shape
    z = x.astype(np.complex128).reshape((b,) + tuple(facs))
    out = []
    for i, f in enumerate(facs):
        z = _dft(z, i + 1, inverse)
        if i == 0 and inverse:
            z = z / n
        if i < len(facs) - 1:
            rest = math.prod(facs[i + 1:])
            tw = _twiddle(f, rest, inverse).reshape((f,) + tuple(facs[i + 1:]))
            z = z * tw
            out.append(z.reshape(b, n))
        else:
            perm = (0,) + tuple(range(len(facs), 0, -1))
            out.append(z.transpose(perm).reshape(b, n))
    return out


def test_pass_layouts_are_the_index_maps_of_the_passes():
    f1, f2, f3 = 8, 4, 2
    n = f1 * f2 * f3
    assert pass_layouts(3, (n,)) == (PassLayout.rows(3, n),)
    two = pass_layouts(3, (f1, f2 * f3))
    assert two == (PassLayout(((3, n, n), (f2 * f3, 1, 1)), f2 * f3,
                              f2 * f3),
                   PassLayout(((3, n, n), (f1, f2 * f3, 1)), 1, f1))
    three = pass_layouts(3, (f1, f2, f3))
    assert three == (
        PassLayout(((3, n, n), (f2 * f3, 1, 1)), f2 * f3, f2 * f3),
        # (B, f1) fuse into one axis of stride f2*f3
        PassLayout(((3 * f1, f2 * f3, f2 * f3), (f3, 1, 1)), f3, f3),
        PassLayout(((3, n, n), (f2, f3, f1), (f1, f2 * f3, 1)), 1, f1 * f2))
    # a batch of one drops its axis
    assert pass_layouts(1, (f1, f2 * f3))[0].axes == ((f2 * f3, 1, 1),)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_each_pass_launch_matches_its_numpy_model(n, inverse, dtype, rng,
                                                  assert_spectrum_close):
    """Pass i's launch, fed the numpy model's storage before it, gives the
    model's storage after it; the middle pass of three also in place."""
    b = _batch(n)
    p = make_plan(n)
    facs = p.kernel_factors
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(dtype)
    want = _numpy_passes(x, facs, inverse)
    tdtype = torch.complex64 if dtype == np.complex64 else torch.complex128
    src = x
    for i, layout in enumerate(pass_layouts(b, facs)):
        last = i == len(facs) - 1
        tw = None if last else pass_twiddle_table(math.prod(facs[i:]),
                                                  tdtype, inverse=inverse)
        kw = dict(inverse=inverse, scale=1.0 / n if inverse and i == 0
                  else 1.0, layout=layout, twiddle=tw)
        inp = torch.from_numpy(np.ascontiguousarray(src))
        got = block_fft(inp, p.stages[i], **kw)
        assert got.shape == inp.shape and got.dtype == tdtype
        assert_spectrum_close(got.numpy(), want[i])
        if 0 < i < len(facs) - 1:
            inplace = inp.clone()
            block_fft(inplace, p.stages[i], out=inplace, **kw)
            assert_spectrum_close(inplace.numpy(), want[i])
        src = want[i].astype(dtype)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_multipass_transform_vs_numpy_and_reference(n, inverse, rng,
                                                    assert_spectrum_close):
    b = _batch(n)
    x = (rng.standard_normal((b, n))
         + 1j * rng.standard_normal((b, n))).astype(np.complex64)
    p = plan(FFTSpec(shape=(b, n), device=CPU))
    assert p.local_plan.num_passes == (2 if n < 1 << 23 else 3)
    if inverse:
        got = p.ifft(torch.from_numpy(x)).numpy()
        assert_spectrum_close(got, np.fft.ifft(x))
        assert_spectrum_close(got, np.asarray(ref_stockham.ifft(x)))
    else:
        got = p.fft(torch.from_numpy(x)).numpy()
        assert_spectrum_close(got, np.fft.fft(x))
        assert_spectrum_close(got, np.asarray(ref_stockham.fft(x)))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [2, 1 << 7, 1 << 14, 1 << 17, 1 << 25])
def test_pass_twiddle_tables_within_two_ulp_of_exp(m, inverse):
    """Every entry of the two tables within 2 ulp (float64) of exp of its
    angle; the twiddle the complex64 kernel forms, lo * hi in float32,
    within 2 float32 ulp of float64 exp for every exponent e < M."""
    table, log_l = factors.pass_twiddle(m, inverse=inverse)
    lo_n = 1 << log_l
    assert table.shape == (lo_n + (m >> log_l),)
    sign = 1.0 if inverse else -1.0
    expo = np.concatenate([np.arange(lo_n),
                           (np.arange(m >> log_l) * lo_n) % m])
    exact = np.exp(sign * 2j * np.pi * expo / m)
    ulp64 = np.finfo(np.float64).eps
    assert np.abs(table.real - exact.real).max() <= 2 * ulp64
    assert np.abs(table.imag - exact.imag).max() <= 2 * ulp64

    t32 = pass_twiddle_table(m, torch.complex64, inverse=inverse).numpy()
    e = np.arange(m)
    w = t32[e & (lo_n - 1)] * t32[lo_n + (e >> log_l)]   # complex64 product
    want = np.exp(sign * 2j * np.pi * e / m)
    ulp32 = float(np.finfo(np.float32).eps)
    assert np.abs(w.real - want.real).max() <= 2 * ulp32
    assert np.abs(w.imag - want.imag).max() <= 2 * ulp32


class _Ops(TorchDispatchMode):
    """Records every aten operation dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


# allocating the scratch and output buffers and viewing the operand
_ALLOWED = {"aten.empty_like", "aten.empty", "aten.view", "aten.alias",
            "aten._reshape_alias", "aten._unsafe_view"}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [1 << 14, 1 << 23])
def test_multipass_is_one_launch_per_pass_and_nothing_else(monkeypatch, n,
                                                           inverse):
    b = _batch(n)
    p = plan(FFTSpec(shape=(b, n), device=CPU))
    passes = p.local_plan.num_passes
    calls = []

    def spy(x, stages, *, inverse, scale, tables, layout, twiddle, out):
        calls.append((stages, tables, layout, twiddle, scale,
                      x.data_ptr(), out.data_ptr()))
        return out

    monkeypatch.setattr(ops, "block_fft", spy)
    x = torch.zeros((b, n), dtype=torch.complex64)
    with _Ops() as rec:
        y = p.ifft(x) if inverse else p.fft(x)
    assert len(calls) == passes
    assert set(rec.ops) <= _ALLOWED, rec.ops
    assert sum(op in ("aten.empty_like", "aten.empty") for op in rec.ops) == 2
    layouts = pass_layouts(b, p.local_plan.kernel_factors)
    for i, (stages, tables, layout, twiddle, scale, src, dst) in \
            enumerate(calls):
        assert stages is p.local_plan.stages[i]
        assert tables is p.tables[inverse][i]
        assert layout == layouts[i]
        if i < passes - 1:
            assert twiddle is p.twiddles[inverse][i]
        else:
            assert twiddle is None and dst == y.data_ptr()
        assert scale == (1.0 / n if inverse and i == 0 else 1.0)
        # pass 0 reads the operand; each later pass reads what the one
        # before it wrote; the middle pass of three works in place
        assert src == (x.data_ptr() if i == 0 else calls[i - 1][6])
        if 0 < i < passes - 1:
            assert dst == src
