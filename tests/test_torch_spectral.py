"""The port's local spectral consumers (``repro_torch.core.fft.spectral``:
fft_convolve, correlate, power_spectrum, conv_spec) against the reference's
``repro.core.fft.spectral`` on the same numpy inputs, mirroring the local
cases of ``tests/test_fft_spectral.py`` and of ``tests/test_fft_real.py``
(the packed real pipeline: the kernel rides the imaginary part of ONE
transform pair). Everything runs on the CPU (``device="cpu"``: the block
kernel's plain version).

Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5 complex64 and
float32, 1e-11 complex128 and float64).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.fft import spectral as ref

from repro_torch.core.fft import FFTSpec, plan, spectral
from repro_torch.kernels import ops

CPU = "cpu"
MODES = ["full", "same", "valid"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("mode", MODES)
def test_convolve_local_matches_reference(mode, rng, assert_spectrum_close):
    a = rng.standard_normal((3, 200)).astype(np.float32)
    v = rng.standard_normal(31).astype(np.float32)
    got = spectral.fft_convolve(_t(a), _t(v), mode=mode, device=CPU)
    want = np.asarray(ref.fft_convolve(a, v, mode=mode))
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32          # real in -> real out
    assert_spectrum_close(got.numpy(), want)
    assert_spectrum_close(got.numpy(), np.stack(
        [np.convolve(r, v, mode) for r in a]).astype(np.float32))


@pytest.mark.parametrize("mode", MODES)
def test_correlate_local_matches_reference(mode, crand,
                                           assert_spectrum_close):
    a = crand(2, 160)
    v = crand(1, 24)[0]
    got = spectral.correlate(_t(a), _t(v), mode=mode, device=CPU)
    want = np.asarray(ref.correlate(a, v, mode=mode))
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.complex64
    assert_spectrum_close(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
def test_real_convolve_correlate_local(mode, rng, assert_spectrum_close):
    """Real operands ride the packed pipeline and match the reference's
    packed pipeline and numpy."""
    a = rng.standard_normal((3, 200)).astype(np.float32)
    v = rng.standard_normal(31).astype(np.float32)
    got = spectral.correlate(_t(a), _t(v), mode=mode, device=CPU)
    want = np.asarray(ref.correlate(a, v, mode=mode))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_spectrum_close(got.numpy(), want)
    assert_spectrum_close(got.numpy(), np.stack(
        [np.correlate(r, v, mode) for r in a]).astype(np.float32))


def test_real_convolve_fp64_local(rng, assert_spectrum_close):
    a = rng.standard_normal((2, 100))
    v = rng.standard_normal(9)
    got = spectral.fft_convolve(_t(a), _t(v), device=CPU)
    assert got.dtype == torch.float64
    assert_spectrum_close(got.numpy(), np.asarray(ref.fft_convolve(a, v)))
    assert_spectrum_close(got.numpy(),
                          np.stack([np.convolve(r, v) for r in a]))


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_convolve_per_signal_kernels(dtype, crand, assert_spectrum_close):
    """A batch of kernels (one per signal) convolves row-wise."""
    a = crand(4, 120, dtype)
    v = crand(4, 17, dtype)
    got = spectral.fft_convolve(_t(a), _t(v), device=CPU)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    assert_spectrum_close(got.numpy(), np.asarray(ref.fft_convolve(a, v)))
    assert_spectrum_close(got.numpy(), np.stack(
        [np.convolve(r, k, "full") for r, k in zip(a, v)]).astype(dtype))


def test_mixed_operands_promote(rng, crand, assert_spectrum_close):
    """A complex signal with a real float64 kernel computes in complex128,
    as the reference's ``_result_dtypes`` says."""
    a = crand(2, 64)
    v = rng.standard_normal(9)
    got = spectral.fft_convolve(_t(a), _t(v), device=CPU)
    assert got.dtype == torch.complex128
    assert_spectrum_close(got.numpy(), np.asarray(ref.fft_convolve(a, v)))


def test_power_spectrum_local(crand, assert_spectrum_close):
    x = crand(3, 512)
    got = spectral.power_spectrum(_t(x), device=CPU)
    want = np.asarray(ref.power_spectrum(x))
    assert not got.is_complex() and got.dtype == torch.float32
    assert_spectrum_close(got.numpy(), want)


def test_power_spectrum_real_one_sided(rng, assert_spectrum_close):
    x = rng.standard_normal((3, 1024)).astype(np.float32)
    got = spectral.power_spectrum(_t(x), real=True, device=CPU)
    want = np.asarray(ref.power_spectrum(x, real=True))
    assert tuple(got.shape) == (3, 513)
    assert_spectrum_close(got.numpy(), want)
    with pytest.raises(ValueError, match="real input"):
        spectral.power_spectrum(_t(x.astype(np.complex64)), real=True,
                                device=CPU)


def test_conv_spec_matches_reference(rng, crand):
    cases = [(rng.standard_normal((3, 200)).astype(np.float32),
              rng.standard_normal(31).astype(np.float32)),
             (crand(2, 160), crand(1, 24)[0]),
             (rng.standard_normal((2, 100)), rng.standard_normal(9))]
    for a, v in cases:
        got = spectral.conv_spec(_t(a), _t(v), device=CPU)
        want = ref.conv_spec(a, v)
        assert (got.shape, got.dtype, got.real) \
            == (want.shape, want.dtype, want.real)
    # a mesh without an fft dimension is refused (the mesh paths run in
    # test_torch_distributed_fft.py's spawn)
    with pytest.raises(ValueError, match="no 'fft' axis"):
        spectral.conv_spec(_t(a), _t(v), object(), device=CPU)
    with pytest.raises(ValueError, match="no 'fft' axis"):
        spectral.power_spectrum(_t(a), object(), device=CPU)


def test_plan_spectral_guards(rng, crand):
    a = _t(rng.standard_normal((3, 200)).astype(np.float32))
    v = _t(rng.standard_normal(31).astype(np.float32))
    p = plan(spectral.conv_spec(a, v, device=CPU))
    with pytest.raises(ValueError, match="nfft=256"):
        plan(FFTSpec(shape=(3, 512), real=True, device=CPU)).convolve(a, v)
    with pytest.raises(ValueError, match="real operands"):
        p.convolve(_t(crand(3, 200)), v)
    with pytest.raises(ValueError, match="mode"):
        p.convolve(a, v, mode="circular")
    with pytest.raises(ValueError, match="1-D only"):
        plan(FFTSpec(shape=(2, 8, 8), rank=2, device=CPU)).correlate(a, v)


def test_real_convolve_is_one_packed_transform_pair(monkeypatch, rng):
    """Two real operands: ONE forward and ONE inverse launch over the
    packed a + i*v (the kernel rides the imaginary part), both on the
    plan's own tables; a complex pair takes three (a, v, the inverse)."""
    calls = []
    real_block_fft = ops.block_fft

    def spy(x, stages, **kw):
        calls.append(kw["tables"])
        return real_block_fft(x, stages, **kw)

    monkeypatch.setattr(ops, "block_fft", spy)
    a = _t(rng.standard_normal((3, 200)).astype(np.float32))
    v = _t(rng.standard_normal(31).astype(np.float32))
    p = plan(spectral.conv_spec(a, v, device=CPU))
    p.convolve(a, v)
    ax = ops.axis_fft(256, torch.complex64, CPU)
    assert len(calls) == 2
    assert calls[0] is ax.tables[False][0] and calls[1] is ax.tables[True][0]
    calls.clear()
    p.correlate(a, v)
    assert len(calls) == 2
    calls.clear()
    spectral.fft_convolve(a.to(torch.complex64), v, device=CPU)
    assert len(calls) == 3
