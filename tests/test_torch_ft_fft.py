"""The port's fault-tolerant path against the reference on the same numpy
inputs: the fused ABFT kernel's plain version against ``abft_fft_pallas``
(interpret mode) on ``(y, delta, cs)`` — ``ref.abft_fft_ref`` raises, so the
reference kernel is the oracle — and the whole ``ft_fft`` against
``repro.kernels.ops.ft_fft`` on the ABFT cases of test_kernels.py, plus the
two-side decode and the fault model. Everything runs on the CPU.

Tolerances: y and cs to the suite's ``ATOL[dtype] * max|ref|``; delta, a
relative divergence that is roundoff-sized on clean signals, to 1e-5
absolute at complex64 plus 1e-4 relative; group scores, roundoff-sized on
clean groups, are compared through the detection threshold (both below it),
and to 1e-4 relative where a fault makes them large.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import abft as ref_abft
from repro.core.ft import injection as ref_injection
from repro.kernels import ops as ref_ops
from repro.kernels.stockham_abft import abft_fft_pallas

from repro_torch.core.abft import twoside
from repro_torch.core.fft import FFTSpec, FTConfig, make_plan, plan
from repro_torch.core.ft import injection
from repro_torch.kernels import ops
from repro_torch.kernels.stockham import block_fft_plain
from repro_torch.kernels.stockham_abft import abft_fft, abft_fft_plain

CPU = "cpu"
ATOL = {np.dtype(np.complex64): 4e-5, np.dtype(np.complex128): 1e-11}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    atol = factor * ATOL[np.dtype(got.dtype)] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _ref_ft(x, **kw):
    inj = kw.pop("inject", None)
    if inj is not None:
        kw["inject"] = jnp.asarray(inj, dtype=jnp.float32)
    return ref_ops.ft_fft(x, **kw)


def _port_ft(x, **kw):
    inj = kw.pop("inject", None)
    if inj is not None:
        kw["inject"] = torch.tensor(inj, dtype=torch.float32)
    return ops.ft_fft(x, device=CPU, **kw)


# ---------------------------------------------------------------------------
# the fused kernel's plain version vs the reference kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,transactions,per_signal,inject", [
    (np.complex64, 1, True, None),
    (np.complex64, 2, True, [3, 1, 17, 1, 40.0, -25.0]),
    (np.complex64, 4, False, [6, 3, 200, 1, -7.0, 9.0]),
    (np.complex128, 2, True, [1, 0, 0, 1, 5.0, 5.0]),
])
def test_abft_plain_vs_reference_kernel(dtype, transactions, per_signal,
                                        inject, crand):
    b, n, bs = 32, 256, 4
    x = crand(b, n, dtype)
    kw = dict(bs=bs, transactions=transactions, per_signal=per_signal)
    ref_inj = None if inject is None else jnp.asarray(inject, jnp.float32)
    yr, yi, delta, cs = abft_fft_pallas(
        jnp.real(x), jnp.imag(x), inject=ref_inj, **kw)
    y, d, c = abft_fft_plain(
        _t(x), make_plan(n).stages[0],
        inject=None if inject is None else torch.tensor(inject), **kw)
    _close(y.numpy(), np.asarray(yr) + 1j * np.asarray(yi))
    cs = np.asarray(cs)                              # (G, 8, N) split re/im
    cs_c = (cs[:, 0::2] + 1j * cs[:, 1::2]).transpose(1, 0, 2)
    assert c.shape == cs_c.shape                     # (4, G, N) complex
    for j in range(4):
        _close(c[j].numpy(), cs_c[j])
    delta = np.asarray(delta)
    atol = (1e-5 if dtype == np.complex64 else 1e-12) \
        + 1e-4 * np.abs(delta).max()
    np.testing.assert_allclose(d.numpy(), delta, rtol=0, atol=atol)
    if not per_signal:
        assert not d.numpy().any()


def test_abft_geometry_and_inverse_errors_match_reference(crand):
    x = _t(crand(12, 64))
    stages = make_plan(64).stages[0]
    with pytest.raises(ValueError, match="divisible by tile size"):
        abft_fft(x, stages, bs=5)
    with pytest.raises(ValueError, match="transactions"):
        abft_fft(x, stages, bs=4, transactions=2)
    with pytest.raises(NotImplementedError, match="forward"):
        abft_fft(x, stages, bs=4, inverse=True)
    # an unknown encoding raises whether or not per-signal checksums are
    # taken, on the kernel's CPU path and through ft_fft, as the reference
    xn = crand(8, 64)
    for per_signal in (False, True):
        with pytest.raises(ValueError, match="unknown encoding"):
            abft_fft(x, stages, bs=4, transactions=3, per_signal=per_signal,
                     encoding="bogus")
        kw = dict(transactions=2, bs=2, per_signal=per_signal,
                  encoding="e3")
        with pytest.raises(ValueError, match="unknown encoding"):
            _port_ft(xn, **kw)
        with pytest.raises(ValueError, match="unknown encoding"):
            _ref_ft(xn, **kw)


# ---------------------------------------------------------------------------
# the whole ft_fft vs repro.kernels.ops.ft_fft (test_kernels.py ABFT cases)
# ---------------------------------------------------------------------------


def test_ftfft_result_fields_match_reference():
    assert [f.name for f in dataclasses.fields(ops.FTFFTResult)] == \
        [f.name for f in dataclasses.fields(ref_ops.FTFFTResult)]


@pytest.mark.parametrize("transactions", [1, 2, 4])
@pytest.mark.parametrize("per_signal", [True, False])
def test_clean_no_false_alarm(transactions, per_signal, crand):
    x = crand(32, 512)
    kw = dict(transactions=transactions, bs=8, per_signal=per_signal)
    res, want = _port_ft(x, **kw), _ref_ft(x, **kw)
    _close(res.y.numpy(), np.asarray(want.y))
    _close(res.y.numpy(), np.fft.fft(x))
    assert int(res.corrected) == 0 == int(want.corrected)
    assert not res.flagged.any()
    assert res.group_score.shape == np.asarray(want.group_score).shape
    assert float(res.group_score.max()) < 1e-4
    if per_signal:
        assert float(res.delta.max()) < 1e-4


@pytest.mark.parametrize("transactions", [1, 2, 4])
def test_detect_locate_correct(transactions, crand):
    b, n, bs = 32, 512, 8
    x = crand(b, n)
    tile, row, col = 2, 5, 37
    sig = tile * bs + row
    kw = dict(transactions=transactions, bs=bs, per_signal=True,
              inject=[tile, row, col, 1, 40.0, 25.0])
    res, want = _port_ft(x, **dict(kw)), _ref_ft(x, **dict(kw))
    flagged = res.flagged.numpy()
    np.testing.assert_array_equal(flagged, np.asarray(want.flagged))
    assert flagged.sum() == 1
    g = int(np.argmax(flagged))
    assert res.location.numpy()[g] == sig == np.asarray(want.location)[g]
    assert int(torch.argmax(res.delta)) == sig
    np.testing.assert_allclose(res.group_score.numpy()[g],
                               np.asarray(want.group_score)[g], rtol=1e-4)
    _close(res.y.numpy(), np.fft.fft(x), factor=1.25)
    _close(res.y.numpy(), np.asarray(want.y), factor=1.25)


def test_correction_disabled_keeps_error(crand):
    b, n, bs = 16, 256, 8
    x = crand(b, n)
    kw = dict(transactions=1, bs=bs, correct=False,
              inject=[0, 0, 0, 1, 100.0, 0.0])
    res, want = _port_ft(x, **dict(kw)), _ref_ft(x, **dict(kw))
    err = np.abs(res.y.numpy() - np.fft.fft(x)).max()
    assert err > 50.0
    assert res.flagged.any() and np.asarray(want.flagged).any()
    _close(res.y.numpy(), np.asarray(want.y))


def test_fp64(crand):
    x = crand(16, 1024, np.complex128)
    kw = dict(transactions=2, bs=8, threshold=1e-8,
              inject=[1, 2, 3, 1, 7.0, -3.0])
    res, want = _port_ft(x, **dict(kw)), _ref_ft(x, **dict(kw))
    assert res.y.dtype == torch.complex128
    np.testing.assert_allclose(res.y.numpy(), np.fft.fft(x),
                               atol=1e-9 * np.abs(np.fft.fft(x)).max())
    assert int(res.corrected) == 1 == int(want.corrected)
    np.testing.assert_array_equal(res.location.numpy(),
                                  np.asarray(want.location))


def test_ragged_batch(crand):
    b, n, bs = 13, 256, 8   # prime batch, bs does not divide it
    x = crand(b, n)
    res = _port_ft(x, transactions=1, bs=bs)
    assert res.y.shape == (b, n) and res.delta.shape == (b,)
    assert not res.flagged.any()
    _close(res.y.numpy(), np.fft.fft(x))
    kw = dict(transactions=1, bs=bs, inject=[0, 2, 9, 1, 60.0, -10.0])
    res, want = _port_ft(x, **dict(kw)), _ref_ft(x, **dict(kw))
    assert int(res.corrected) == 1 == int(want.corrected)
    _close(res.y.numpy(), np.fft.fft(x), factor=2.5)
    _close(res.y.numpy(), np.asarray(want.y), factor=2.5)


def test_multi_transaction_checksum_equivalence(crand):
    """T transactions accumulate the same group checksums as T=1 over the
    same signals (paper §4.3), so detection is transaction-count
    invariant."""
    x = crand(32, 256)
    r1 = _port_ft(x, transactions=1, bs=32)
    r4 = _port_ft(x, transactions=4, bs=8)
    np.testing.assert_allclose(r1.group_score.numpy(),
                               r4.group_score.numpy(), atol=1e-5)
    np.testing.assert_allclose(r1.y.numpy(), r4.y.numpy(),
                               atol=1e-5 * np.abs(r1.y.numpy()).max())


def test_ft_plan_defaults_and_batch_check(crand):
    x = crand(8, 128)
    p = plan(FFTSpec(shape=(8, 128), ft=FTConfig(), device=CPU))
    res = p.ft_fft(_t(x))               # default bs from the Hopper plan
    _close(res.y.numpy(), np.fft.fft(x))
    with pytest.raises(ValueError, match="batch"):
        plan(FFTSpec(shape=(8, 128), ft=FTConfig(),
                     device=CPU)).ft_fft(_t(crand(8, 128).reshape(4, 2, 128)
                                            [:2]))
    with pytest.raises(ValueError, match="single-pass"):
        ops.ft_fft(crand(1, 1 << 14), device=CPU)


# ---------------------------------------------------------------------------
# two-side decode and the fault model
# ---------------------------------------------------------------------------


def test_detect_locate_and_correction_vs_reference(rng):
    g, n, b = 4, 64, 16
    cs = (rng.standard_normal((4, g, n))
          + 1j * rng.standard_normal((4, g, n)))
    fwd = np.fft.fft
    cs[2] = fwd(cs[0])
    cs[3] = fwd(cs[1])
    eps = np.zeros(n, complex)
    eps[5] = 3.0 - 2.0j
    cs[2, 1] += eps
    cs[3, 1] += 7 * eps                      # signal id 7 -> location 6
    got = twoside.detect_locate(twoside.GroupChecksums.from_packed(_t(cs)),
                                lambda c: torch.fft.fft(c), 1e-6)
    packed = np.empty((g, 8, n))
    packed[:, 0::2] = cs.real.transpose(1, 0, 2)
    packed[:, 1::2] = cs.imag.transpose(1, 0, 2)
    want = ref_abft.detect_locate(
        ref_abft.GroupChecksums.from_packed(jnp.asarray(packed)),
        forward=lambda c: jnp.fft.fft(c), threshold=1e-6)
    np.testing.assert_array_equal(got.flagged.numpy(),
                                  np.asarray(want.flagged))
    np.testing.assert_array_equal(got.location.numpy(),
                                  np.asarray(want.location))
    assert got.location.numpy()[1] == 6
    np.testing.assert_allclose(got.error_score.numpy()[1],
                               np.asarray(want.error_score)[1], rtol=1e-9)
    y = rng.standard_normal((b, n)) + 0j
    fixed, applied = twoside.apply_correction(_t(y.copy()), got)
    ref_fixed, _ = ref_abft.apply_correction(jnp.asarray(y), want)
    np.testing.assert_allclose(fixed.numpy(), np.asarray(ref_fixed),
                               atol=1e-12)
    np.testing.assert_allclose(fixed.numpy()[6] - y[6], -eps, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("g,n", [(1, 8), (1, 16), (2, 32), (3, 512),
                                 (5, 8192), (8, 1024), (256, 64)])
def test_merged_checksum_fft_gives_the_verdict_of_two_calls(g, n, dtype,
                                                            rng):
    """detect_locate runs the protected operator once on the (2G, N) block
    [X.e2; X.e3] of the fused kernel's cs; that is bitwise the verdict of
    one call on X.e2 and one on X.e3. One CPU thread: torch's elementwise
    kernels split a large tensor over threads at offsets that move with its
    size, and a chunk's scalar tail rounds a complex product unlike the
    vector body."""
    stages = make_plan(n).stages[0]
    cs = (rng.standard_normal((4, g, n))
          + 1j * rng.standard_normal((4, g, n))).astype(dtype)
    cs[2] = np.fft.fft(cs[0])
    cs[3] = np.fft.fft(cs[1])
    cs[2, g - 1, n // 3] += 5.0 - 4.0j           # one SEU in the last group
    cs[3, g - 1, n // 3] += 7 * (5.0 - 4.0j)
    calls = []

    def merged(c):
        calls.append(c.shape)
        return block_fft_plain(c, stages)

    def two_calls(c):
        calls.append(c.shape)
        return torch.cat([block_fft_plain(c[:g], stages),
                          block_fft_plain(c[g:], stages)])

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = twoside.detect_locate(
            twoside.GroupChecksums.from_packed(_t(cs)), merged, 1e-4)
        want = twoside.detect_locate(
            twoside.GroupChecksums.from_packed(_t(cs)), two_calls, 1e-4)
    finally:
        torch.set_num_threads(threads)
    assert calls == [(2 * g, n)] * 2
    for field in ("error_score", "flagged", "location", "correction"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert bool(got.flagged[g - 1]) and int(got.location[g - 1]) == 6
    # a GroupChecksums built field by field takes the same single call
    sums = twoside.GroupChecksums(*(_t(cs[j]) for j in range(4)))
    again = twoside.detect_locate(sums, merged, 1e-4)
    assert calls[-1] == (2 * g, n)
    assert torch.equal(again.location, got.location)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_bit_flips_match_reference(dtype, rng):
    x = (rng.standard_normal((4, 8)) * 3).astype(dtype)
    for bit in (0, 22, 30, 31):
        np.testing.assert_array_equal(
            injection.flip_bit(x, (1, 2), bit),
            ref_injection.flip_bit(x, (1, 2), bit))
    seed = int(rng.integers(1 << 31))
    got = injection.random_flip(np.random.default_rng(seed), x)
    want = ref_injection.random_flip(np.random.default_rng(seed), x)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_poisson_schedule_and_descriptors_match_reference():
    kw = dict(steps=40, rate_per_step=0.3, tiles=16, bs=8, n=512)
    got = injection.poisson_schedule(np.random.default_rng(3), **kw)
    want = ref_injection.poisson_schedule(np.random.default_rng(3), **kw)
    assert got.entries == want.entries and got.num_faults > 0
    for step in range(kw["steps"]):
        d = got.for_step(step)
        assert d.dtype == torch.float32 and d.shape == (6,)
        np.testing.assert_array_equal(d.numpy(),
                                      np.asarray(want.for_step(step)))


def test_schedule_drives_ft_fft_end_to_end(crand):
    b, n, bs = 16, 128, 2
    x = crand(b, n)
    sched = injection.poisson_schedule(np.random.default_rng(0), steps=6,
                                       rate_per_step=0.7, tiles=b // bs,
                                       bs=bs, n=n)
    p = plan(FFTSpec(shape=(b, n), ft=FTConfig(transactions=2), device=CPU))
    want = np.fft.fft(x)
    for step in range(6):
        inj = sched.for_step(step)
        res = p.ft_fft(_t(x), inject=inj, bs=bs)
        hit = float(inj[3]) > 0
        assert int(res.corrected) == int(hit)
        if hit:
            g = int(torch.argmax(res.flagged.to(torch.int32)))
            assert int(res.location[g]) == int(inj[0]) * bs + int(inj[1])
        _close(res.y.numpy(), want, factor=2.5)
