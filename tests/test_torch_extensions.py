"""The port's local extensions (``repro_torch.core.fft.extensions``: rfft /
irfft, fft2 / ifft2, ft_ifft) against the reference's
``repro.core.fft.extensions`` on the same numpy inputs, mirroring
``tests/test_fft_extensions.py`` (all but its mesh/interpret kwargs test),
plus the even-``n`` irfft that the port refuses where the reference returns
a shorter signal. Everything runs on the CPU (``device="cpu"``: the block
kernel's plain version).

Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11
complex128), the odd-length (direct-DFT) cases included.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fft as ref_fft
from repro.core.fft import extensions as ref

from repro_torch.core import fft as tfft
from repro_torch.core.fft import extensions as ext
from repro_torch.kernels import ops

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", [64, 256, 1024])
def test_rfft_matches_reference(n, rng, assert_spectrum_close):
    x = rng.standard_normal((3, n)).astype(np.float32)
    got = ext.rfft(_t(x), device=CPU)
    want = np.asarray(ref.rfft(jnp.asarray(x)))
    assert got.shape == (3, n // 2 + 1) and got.dtype == torch.complex64
    assert_spectrum_close(_np(got), want)
    assert_spectrum_close(_np(got), np.fft.rfft(x))


def test_irfft_roundtrip(rng, assert_spectrum_close):
    x = rng.standard_normal((2, 512)).astype(np.float32)
    y = ext.rfft(_t(x), device=CPU)
    got = ext.irfft(y, device=CPU)
    want = np.asarray(ref.irfft(ref.rfft(jnp.asarray(x))))
    assert got.dtype == torch.float32 and got.shape == (2, 512)
    assert_spectrum_close(_np(got), want)
    assert_spectrum_close(_np(got), x)


def test_irfft_explicit_n(rng, assert_spectrum_close):
    """Explicit ``n``: the default is recoverable by passing it, and a
    shorter even n truncates the reconstructed signal (the reference's
    semantics)."""
    x = rng.standard_normal((2, 512)).astype(np.float32)
    y = ext.rfft(_t(x), device=CPU)
    yj = jnp.asarray(_np(y))
    assert_spectrum_close(_np(ext.irfft(y, n=512, device=CPU)),
                          np.asarray(ref.irfft(yj, n=512)))
    got = ext.irfft(y, n=500, device=CPU)
    assert got.shape == (2, 500)
    assert_spectrum_close(_np(got), np.asarray(ref.irfft(yj, n=500)))
    assert_spectrum_close(_np(got), x[:, :500])


def test_irfft_even_n_beyond_the_spectrum_raises(rng):
    """The reference returns 2*(bins-1) samples for an even n above it
    (``irfft(rfft(x512), n=600).shape == (2, 512)``); the port refuses
    and names the largest n."""
    x = rng.standard_normal((2, 512)).astype(np.float32)
    assert ref.irfft(ref.rfft(jnp.asarray(x)), n=600).shape == (2, 512)
    y = ext.rfft(_t(x), device=CPU)
    with pytest.raises(ValueError, match="at most n=512"):
        ext.irfft(y, n=600, device=CPU)
    assert ext.irfft(y, n=512, device=CPU).shape == (2, 512)


def test_irfft_odd_n_matches_reference(rng, assert_spectrum_close):
    """Odd ``n`` has no Nyquist bin: the Hermitian tail is
    ``conj(y[..., 1:][..., ::-1])``; complex128 in, float64 out."""
    x = rng.standard_normal((2, 511))
    y = np.fft.rfft(x)
    got = ext.irfft(_t(y), n=511, device=CPU)
    assert got.shape == (2, 511) and got.dtype == torch.float64
    assert_spectrum_close(_np(got), np.asarray(ref.irfft(jnp.asarray(y),
                                                         n=511)))
    assert_spectrum_close(_np(got), x)


def test_irfft_odd_n_crops_spectrum_like_the_reference(rng):
    x = rng.standard_normal((2, 512)).astype(np.float32)
    y = ext.rfft(_t(x), device=CPU)
    got = _np(ext.irfft(y, n=511, device=CPU))
    want = np.asarray(ref.irfft(jnp.asarray(_np(y)), n=511))
    assert got.shape == want.shape == (2, 511)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4e-5 * np.abs(want).max())
    wrong = _np(ext.irfft(y, n=512, device=CPU))[:, :511]
    assert np.abs(wrong - want).max() > 1e-3


def test_irfft_odd_n_rejects_short_spectrum():
    with pytest.raises(ValueError, match="odd n"):
        ext.irfft(torch.ones(4, dtype=torch.complex64), n=9, device=CPU)


def test_fft2_matches_reference(crand, assert_spectrum_close):
    x = crand(2 * 64, 128).reshape(2, 64, 128)
    got = ext.fft2(_t(x), device=CPU)
    assert_spectrum_close(_np(got), np.asarray(ref.fft2(jnp.asarray(x))))
    assert_spectrum_close(_np(got), np.fft.fft2(x))
    want = np.fft.fft2(x)
    back = ext.ifft2(_t(want.astype(np.complex64)), device=CPU)
    assert_spectrum_close(_np(back),
                          np.asarray(ref.ifft2(jnp.asarray(want))))
    assert_spectrum_close(_np(back), x)


@pytest.mark.parametrize("rows,cols", [(32, 256), (256, 32), (16, 1024)])
def test_fft2_rectangular(rows, cols, crand, assert_spectrum_close):
    """Each axis uses its own length (catches a transposed-plan mixup)."""
    x = crand(rows, cols).reshape(1, rows, cols)
    got = ext.fft2(_t(x), device=CPU)
    assert_spectrum_close(_np(got), np.asarray(ref.fft2(jnp.asarray(x))))
    assert_spectrum_close(_np(ext.ifft2(got, device=CPU)), x)


@pytest.mark.parametrize("rows,cols", [(11, 18), (18, 11), (27, 64), (64, 27)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fft2_odd_sizes_and_roundtrip(rows, cols, dtype, crand,
                                      assert_spectrum_close):
    """Odd / non-power-of-two grids (the direct-DFT axes) in both
    precisions, and the round trip."""
    x = crand(rows, cols, dtype=dtype).reshape(1, rows, cols)
    got = ext.fft2(_t(x), device=CPU)
    assert got.dtype == getattr(torch, np.dtype(dtype).name)
    assert_spectrum_close(_np(got), np.asarray(ref.fft2(jnp.asarray(x))))
    assert_spectrum_close(_np(ext.ifft2(got, device=CPU)), x)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_fft2_roundtrip_pow2(dtype, crand, assert_spectrum_close):
    x = crand(64, 128, dtype=dtype).reshape(1, 64, 128)
    assert_spectrum_close(
        _np(ext.ifft2(ext.fft2(_t(x), device=CPU), device=CPU)), x)
    assert_spectrum_close(
        _np(ext.fft2(ext.ifft2(_t(x), device=CPU), device=CPU)), x)


def test_ops_fft2_is_the_same_plan(crand, assert_spectrum_close):
    """``kernels.ops.fft2/ifft2`` mirror ``repro.kernels.ops.fft2/ifft2``
    (without the deprecated mesh kwargs)."""
    from repro.kernels import ops as ref_ops

    x = crand(2 * 32, 64).reshape(2, 32, 64)
    got = ops.fft2(_t(x), device=CPU)
    assert_spectrum_close(_np(got), np.asarray(ref_ops.fft2(x)))
    assert_spectrum_close(_np(ops.ifft2(got, device=CPU)),
                          np.asarray(ref_ops.ifft2(ref_ops.fft2(x))))


# ---------------------------------------------------------------------------
# transform invariants (reference-free), on the plan path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 4096, 1 << 14])
def test_parseval(n, crand):
    x = crand(3, n)
    y = _np(ops.fft(_t(x), device=CPU))
    e_t = np.sum(np.abs(x) ** 2, axis=-1)
    e_f = np.sum(np.abs(y) ** 2, axis=-1) / n
    np.testing.assert_allclose(e_f, e_t, rtol=1e-5)


@pytest.mark.parametrize("shift", [1, 17, 255])
def test_time_shift_theorem(shift, crand, assert_spectrum_close):
    n = 512
    x = crand(2, n)
    lhs = _np(ops.fft(_t(np.roll(x, shift, axis=-1)), device=CPU))
    phase = np.exp(-2j * np.pi * np.arange(n) * shift / n)
    rhs = _np(ops.fft(_t(x), device=CPU)) * phase
    assert_spectrum_close(lhs, rhs.astype(np.complex64))


def test_rfft_hermitian_symmetry(rng, assert_spectrum_close):
    """The half spectrum is the first N/2+1 bins of the complex transform
    of the same real input."""
    x = rng.standard_normal((2, 256)).astype(np.float32)
    half = _np(ext.rfft(_t(x), device=CPU))
    full = _np(ops.fft(_t(x.astype(np.complex64)), device=CPU))
    assert_spectrum_close(half, full[:, :129])
    assert_spectrum_close(half, np.asarray(ref_fft.fft(x))[:, :129])


def test_ft_ifft_detects_and_corrects(rng, assert_spectrum_close):
    x = (rng.standard_normal((16, 256)) +
         1j * rng.standard_normal((16, 256))).astype(np.complex64)
    inj = [1, 2, 9, 1, 60.0, -10.0]
    res = ext.ft_ifft(_t(x), transactions=2, bs=8,
                      inject=torch.tensor(inj), device=CPU)
    want = ref.ft_ifft(jnp.asarray(x), transactions=2, bs=8,
                       inject=jnp.asarray(inj, jnp.float32))
    assert int(res.corrected) == int(want.corrected) == 1
    np.testing.assert_array_equal(_np(res.flagged), np.asarray(want.flagged))
    np.testing.assert_array_equal(_np(res.location),
                                  np.asarray(want.location))
    assert_spectrum_close(_np(res.y), np.asarray(want.y))
    assert_spectrum_close(_np(res.y), np.fft.ifft(x).astype(np.complex64))
    # the conjugation is physical: the operand is not touched
    assert_spectrum_close(_np(ext.ft_ifft(_t(x), device=CPU).y),
                          np.fft.ifft(x).astype(np.complex64))


# ---------------------------------------------------------------------------
# edge cases: degenerate sizes + fp64 precision
# ---------------------------------------------------------------------------


def test_rfft_odd_n_matches_reference(rng):
    x = rng.standard_normal((2, 511)).astype(np.float32)
    got = _np(ext.rfft(_t(x), device=CPU))
    want = np.asarray(ref.rfft(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 256)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4e-5 * np.abs(want).max())


def test_rfft_irfft_degenerate_sizes_raise_valueerror():
    with pytest.raises(ValueError, match="empty"):
        ext.rfft(torch.zeros((2, 0)), device=CPU)
    with pytest.raises(ValueError, match="empty"):
        ext.irfft(torch.zeros((2, 0), dtype=torch.complex64), device=CPU)
    with pytest.raises(ValueError, match="single-bin"):
        ext.irfft(torch.ones((2, 1), dtype=torch.complex64), device=CPU)
    with pytest.raises(ValueError, match="n"):
        ext.irfft(torch.ones((2, 5), dtype=torch.complex64), n=0,
                  device=CPU)


def test_irfft_n1_explicit():
    y = np.asarray([[3.5 + 2.0j], [-1.25 + 0.5j]], np.complex64)
    got = ext.irfft(_t(y), n=1, device=CPU)
    np.testing.assert_allclose(_np(got), np.asarray(ref.irfft(
        jnp.asarray(y), n=1)), atol=1e-6)


@pytest.mark.parametrize("fn_pair", ["fft2", "ft_ifft"])
def test_fp64_not_clobbered(fn_pair, rng, assert_spectrum_close):
    """complex128 operands keep full precision end to end."""
    x = (rng.standard_normal((4, 32, 64)) +
         1j * rng.standard_normal((4, 32, 64))).astype(np.complex128)
    if fn_pair == "fft2":
        y = ext.fft2(_t(x), device=CPU)
        assert y.dtype == torch.complex128
        assert_spectrum_close(_np(y), np.asarray(ref.fft2(jnp.asarray(x))))
        back = ext.ifft2(y, device=CPU)
        assert back.dtype == torch.complex128
        assert_spectrum_close(_np(back), x)
    else:
        xs = x.reshape(8, 1024)[:, :256]
        res = ext.ft_ifft(_t(xs), transactions=2, bs=8, device=CPU)
        want = ref.ft_ifft(jnp.asarray(xs), transactions=2, bs=8)
        assert res.y.dtype == torch.complex128
        assert_spectrum_close(_np(res.y), np.asarray(want.y))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rfft_keeps_the_operand_precision(dtype, rng, assert_spectrum_close):
    """A float64 signal plans a complex128 half spectrum, as the
    reference's real spec does; the inverse gives float64 back."""
    x = rng.standard_normal((3, 1 << 14)).astype(dtype)
    got = ext.rfft(_t(x), device=CPU)
    cdt = np.complex128 if dtype == np.float64 else np.complex64
    assert got.dtype == getattr(torch, np.dtype(cdt).name)
    assert_spectrum_close(_np(got), np.asarray(ref.rfft(jnp.asarray(x))))
    back = ext.irfft(got, device=CPU)
    assert back.dtype == getattr(torch, np.dtype(dtype).name)
    assert_spectrum_close(_np(back), x)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=`` every entry point plans for ``"cuda"``; without a
    card that raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros((2, 8, 8))
    calls = [lambda: ext.rfft(x), lambda: ext.irfft(x.to(torch.complex64)),
             lambda: ext.fft2(x), lambda: ext.ifft2(x),
             lambda: ext.rfft2(x), lambda: ext.irfft2(x), lambda: ops.fft2(x),
             lambda: tfft.fft_convolve(x, x), lambda: tfft.correlate(x, x),
             lambda: tfft.power_spectrum(x), lambda: tfft.fft_convolve2(x, x)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
