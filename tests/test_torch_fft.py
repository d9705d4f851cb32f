"""The port's local fft / ifft against the reference on the same numpy
inputs: the block-FFT sweep of test_kernels.py (reference kernel in
interpret mode), the multi-pass sizes, the inverse (held against
``np.fft.ifft`` and ``repro.core.fft.stockham.ifft``), the round trip, the
eager Stockham module, the oracles, and the local cases of test_fft_api.py.
Everything runs on the CPU (``device="cpu"``: the kernels' plain versions).

Tolerance: the suite's ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11
complex128), the bound both implementations are held to against numpy.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.fft import stockham as ref_stockham
from repro.core.fft.large import fft_large as ref_fft_large
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels.stockham import block_fft_pallas

from repro_torch.core.fft import (FFTSpec, FTConfig, fft_large, make_plan,
                                  plan, plan_from_reference)
from repro_torch.core.fft import stockham
from repro_torch.kernels import ops, ref
from repro_torch.core.fft.plan import pass_layouts
from repro_torch.kernels.stockham import (block_fft, pass_twiddle_table,
                                          stage_tables)
from repro_torch.kernels.stockham_abft import abft_fft

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _plan(x, **kw):
    return plan(FFTSpec(shape=x.shape, dtype=x.dtype, device=CPU, **kw))


# ---------------------------------------------------------------------------
# block FFT: sweep against the reference kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                               8192])
def test_block_fft_sweep_vs_reference_kernel(n, dtype, crand,
                                             assert_spectrum_close):
    x = crand(8, n, dtype)
    yr, yi = block_fft_pallas(jnp.real(x), jnp.imag(x), bs=8)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    got = _plan(x).fft(_t(x)).numpy()
    assert got.dtype == dtype
    assert_spectrum_close(got, want)
    assert_spectrum_close(got, np.fft.fft(x))


@pytest.mark.parametrize("n", [1024, 8192])
def test_block_fft_on_reference_stages(n, crand, assert_spectrum_close):
    """The kernel wrapper runs the reference plan's own stages (radix 128
    included) and agrees with the reference kernel on them."""
    rp = ref_ops.make_plan(n, batch=8)
    p = plan_from_reference(rp.n, rp.kernel_factors,
                            tuple(tuple(s.radix for s in st)
                                  for st in rp.stages), rp.bs)
    x = crand(8, n)
    yr, yi = block_fft_pallas(jnp.real(x), jnp.imag(x), plan=rp, bs=8)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    assert_spectrum_close(block_fft(_t(x), p.stages[0]).numpy(), want)


def test_block_fft_inverse_vs_reference_kernel(crand, assert_spectrum_close):
    x = crand(8, 512)
    yr, yi = block_fft_pallas(jnp.real(x), jnp.imag(x), bs=8, inverse=True)
    want = np.asarray(yr) + 1j * np.asarray(yi)
    got = _plan(x).ifft(_t(x)).numpy()
    assert_spectrum_close(got, want)
    assert_spectrum_close(got, np.fft.ifft(x))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_block_fft_tiny_n(n, crand, assert_spectrum_close):
    x = crand(3, n)
    assert_spectrum_close(ops.fft(x, device=CPU).numpy(), np.fft.fft(x))
    assert_spectrum_close(ops.ifft(x, device=CPU).numpy(), np.fft.ifft(x))


def test_block_fft_scale_rides_the_launch(crand):
    x = _t(crand(4, 256))
    stages = make_plan(256).stages[0]
    np.testing.assert_allclose(
        block_fft(x, stages, inverse=True, scale=0.25).numpy(),
        0.25 * block_fft(x, stages, inverse=True).numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# multi-pass sizes and the inverse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1 << 14, 1 << 17])
def test_multipass_fft_vs_reference(n, crand, assert_spectrum_close):
    x = crand(2, n)
    got = ops.fft(x, device=CPU).numpy()
    assert _plan(x).local_plan.num_passes == 2
    assert_spectrum_close(got, np.asarray(ref_ops.fft(x)))
    assert_spectrum_close(got, np.fft.fft(x))


@pytest.mark.parametrize("n", [1 << 14, 1 << 17])
def test_multipass_ifft_is_the_true_inverse(n, crand, assert_spectrum_close):
    """Scaled by 1/N exactly once (the reference's kernels.ops.ifft scales
    the multi-pass inverse twice, so it is not the oracle here)."""
    x = crand(2, n)
    got = ops.ifft(x, device=CPU).numpy()
    assert_spectrum_close(got, np.fft.ifft(x))
    assert_spectrum_close(got, np.asarray(ref_stockham.ifft(x)))


@pytest.mark.parametrize("n", [2048, 1 << 15])
def test_ifft_roundtrip(n, crand):
    x = crand(4, n)
    got = ops.ifft(ops.fft(x, device=CPU), device=CPU).numpy()
    np.testing.assert_allclose(got, x, atol=2e-6 * np.abs(x).max())


def test_fp64_spectrum(crand, assert_spectrum_close):
    x = crand(8, 1024, np.complex128)
    got = ops.fft(x, device=CPU).numpy()
    assert got.dtype == np.complex128
    assert_spectrum_close(got, np.fft.fft(x))


def test_leading_batch_dims_and_real_input(rng, assert_spectrum_close):
    x = rng.standard_normal((2, 3, 256))
    got = ops.fft(x, device=CPU)
    assert got.shape == (2, 3, 256) and got.dtype == torch.complex64
    assert_spectrum_close(got.numpy(), np.fft.fft(x).astype(np.complex64))


# ---------------------------------------------------------------------------
# the eager Stockham module and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 64, 1 << 14])
def test_stockham_module_vs_reference(n, crand, assert_spectrum_close):
    x = crand(3, n)
    for got, want in ((stockham.fft(_t(x)), ref_stockham.fft(x)),
                      (stockham.ifft(_t(x)), ref_stockham.ifft(x))):
        assert_spectrum_close(got.numpy(), np.asarray(want))
    if n <= 64:
        assert_spectrum_close(stockham.naive_dft(_t(x)).numpy(),
                              np.asarray(ref_stockham.naive_dft(x)))
        assert_spectrum_close(
            stockham.radix2_fft(_t(x), inverse=True).numpy(),
            np.asarray(ref_stockham.radix2_fft(x, inverse=True)))
        assert_spectrum_close(stockham.block_fft_stages(_t(x)).numpy(),
                              np.asarray(ref_stockham.block_fft_stages(x)))


@pytest.mark.parametrize("n,inverse", [(1 << 14, False), (1 << 23, True)])
def test_fft_large_vs_reference(n, inverse, rng, assert_spectrum_close):
    x = (rng.standard_normal((1, n))
         + 1j * rng.standard_normal((1, n))).astype(np.complex64)
    p = make_plan(n, inverse=inverse)
    assert p.num_passes == (2 if n < 1 << 23 else 3)
    got = fft_large(_t(x), p).numpy()
    want = np.fft.ifft(x) if inverse else np.fft.fft(x)
    assert_spectrum_close(got, want)
    if n < 1 << 23:
        assert_spectrum_close(got, np.asarray(ref_fft_large(x)))
    with pytest.raises(ValueError, match="plan is for"):
        fft_large(_t(x[:, :n // 2]), p)


def test_fft_with_plan_rejects_multipass(crand):
    with pytest.raises(ValueError, match="single-pass"):
        stockham.fft_with_plan(_t(crand(1, 1 << 14)), make_plan(1 << 14))


def test_oracles_match_reference(crand, assert_spectrum_close):
    x = crand(4, 128)
    for inverse in (False, True):
        assert_spectrum_close(
            ref.fft_ref(_t(x), inverse=inverse).numpy(),
            np.asarray(ref_oracles.fft_ref(jnp.asarray(x), inverse=inverse)))
        got = ref.fft_ri_ref(_t(x.real.copy()), _t(x.imag.copy()),
                             inverse=inverse)
        want = ref_oracles.fft_ri_ref(jnp.asarray(x.real),
                                      jnp.asarray(x.imag), inverse=inverse)
        for g, w in zip(got, want):
            assert_spectrum_close(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the plan API, local cases of test_fft_api.py
# ---------------------------------------------------------------------------


def test_plan_cache_same_spec_same_plan(crand):
    spec = FFTSpec(shape=(8, 4096), device=CPU)
    p1 = plan(spec)
    assert plan(FFTSpec(shape=(8, 4096), device=CPU)) is p1
    x = _t(crand(8, 4096))
    y1 = p1.fft(x)
    for _ in range(3):
        y2 = plan(FFTSpec(shape=(8, 4096), device=CPU)).fft(x)
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())


def test_plan_cache_distinct_keys():
    base = FFTSpec(shape=(8, 4096), device=CPU)
    others = [FFTSpec(shape=(8, 4096), dtype="complex128", device=CPU),
              FFTSpec(shape=(8, 4096), device=CPU, ft=FTConfig(groups=4)),
              FFTSpec(shape=(8, 4096), device=CPU,
                      ft=FTConfig(groups=4, threshold=1e-6)),
              FFTSpec(shape=(4, 4096), device=CPU)]
    plans = [plan(s) for s in [base] + others]
    assert len({id(p) for p in plans}) == len(plans)


def test_plan_resolves_once_and_keeps_device_tables(monkeypatch, crand):
    """The plan decides the stages and uploads their tables and the pass
    twiddles once; its executors launch the block kernel with exactly
    those, pass by pass, in the passes' layouts."""
    p = plan(FFTSpec(shape=(8, 1 << 14), device=CPU))
    assert p.decomp == "local" and p.groups is None
    lp = p.local_plan
    assert lp.num_passes == 2
    for inverse, tabs in p.tables.items():
        assert len(tabs) == lp.num_passes
        for stages, tab in zip(lp.stages, tabs):
            assert tab is stage_tables(stages, torch.complex64,
                                       inverse=inverse)
        (tw,) = p.twiddles[inverse]
        assert tw is pass_twiddle_table(1 << 14, torch.complex64,
                                        inverse=inverse)
    assert "decomp='local'" in repr(p) and "device='cpu'" in repr(p)

    seen = []

    def spy(x, stages, *, inverse, scale, tables, layout=None, twiddle=None,
            out=None):
        seen.append((stages, tables, inverse, layout, twiddle))
        return block_fft(x, stages, inverse=inverse, scale=scale,
                         tables=tables, layout=layout, twiddle=twiddle,
                         out=out)

    monkeypatch.setattr(ops, "block_fft", spy)
    x = _t(crand(8, 1 << 14))
    p.fft(x)
    p.ifft(x)
    layouts = pass_layouts(8, lp.kernel_factors)
    want = [(st, p.tables[inv][i], inv, layouts[i],
             p.twiddles[inv][i] if i == 0 else None)
            for inv in (False, True) for i, st in enumerate(lp.stages)]
    assert len(seen) == len(want)
    for got, exp in zip(seen, want):
        st, tab, inv, lay, tw = got
        st_w, tab_w, inv_w, lay_w, tw_w = exp
        assert st is st_w and tab is tab_w and inv == inv_w
        assert lay == lay_w and tw is tw_w

    seen.clear()
    fused = []

    def spy_abft(x, stages, **kw):
        fused.append((stages, kw["tables"]))
        return abft_fft(x, stages, **kw)

    monkeypatch.setattr(ops, "abft_fft", spy_abft)
    pf = plan(FFTSpec(shape=(16, 256), ft=FTConfig(), device=CPU))
    pf.ft_fft(_t(crand(16, 256)))
    # the fused kernel, then detect_locate's one checksum FFT over the
    # (2G, N) block [X.e2; X.e3]
    for st, tab, *_ in fused + seen:
        assert st is pf.local_plan.stages[0] and tab is pf.tables[False][0]
    assert len(fused) == 1 and len(seen) == 1


def test_plan_rejects_wrong_transform_axis(crand):
    p = plan(FFTSpec(shape=(2, 64), device=CPU))
    with pytest.raises(ValueError, match="transform axes"):
        p.fft(_t(crand(2, 128)))
    with pytest.raises(ValueError, match="no FTConfig"):
        p.ft_fft(_t(crand(2, 64)))


def test_local_ft_plan_treats_groups_as_noop(crand):
    x = crand(6, 256)                # 4 does not divide 6
    p = plan(FFTSpec(shape=(6, 256), ft=FTConfig(groups=4), device=CPU))
    assert p.groups is None
    res = p.ft_fft(_t(x))
    assert int(res.corrected) == 0
    np.testing.assert_allclose(res.y.numpy(), np.fft.fft(x), atol=1e-3)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor reaches a plain version; any other device takes the
    kernel path or raises."""
    x = torch.empty((2, 16), dtype=torch.complex64, device="meta")
    stages = make_plan(16).stages[0]
    with pytest.raises(ValueError, match="cuda"):
        block_fft(x, stages)
    with pytest.raises(ValueError, match="cuda"):
        abft_fft(x, stages, bs=1)
