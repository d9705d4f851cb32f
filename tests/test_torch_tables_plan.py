"""The port's host-side state against the reference: factor/twiddle tables
and ABFT encodings bitwise equal, FTConfig fields, plans (Hopper re-tune and
``plan_from_reference``), FFTSpec validation and the thread-safe plan cache.

Tolerance: the tables are compared bitwise (both sides build them in
float64 numpy and cast once); stage intermediates on the reference's own
stages to 1e-6 * max|ref| at complex64 (two implementations of the same
contraction, summed in different orders).
"""
from __future__ import annotations

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import plan as ref_planbase
from repro.core.abft import encoding as ref_encoding
from repro.core.fft import factors as ref_factors
from repro.core.fft import stockham as ref_stockham

from repro_torch.core import plan as planbase
from repro_torch.core.abft import encoding
from repro_torch.core.fft import api, factors, stockham
from repro_torch.core.fft.plan import (MAX_BLOCK_N, NUM_SMS, block_radices,
                                       make_plan, plan_from_reference)

# the package re-exports plan() under the submodule's name
ref_plan = importlib.import_module("repro.core.fft.plan")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("r,m", [(2, 1), (8, 64), (16, 512), (128, 64)])
def test_factor_tables_bitwise_equal(r, m, dtype, inverse):
    for got, want in zip(factors.dft_matrix_ri(r, dtype, inverse=inverse),
                         ref_factors.dft_matrix_ri(r, dtype,
                                                   inverse=inverse)):
        _bits_equal(got, want)
    for got, want in zip(
            factors.stage_twiddle_ri(r, m, dtype, inverse=inverse),
            ref_factors.stage_twiddle_ri(r, m, dtype, inverse=inverse)):
        _bits_equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 512, 8192])
def test_encoding_vectors_bitwise_equal(n):
    _bits_equal(factors.wang_encoding(n), ref_factors.wang_encoding(n))
    _bits_equal(factors.location_encoding(n, offset=3),
                ref_factors.location_encoding(n, offset=3))
    _bits_equal(factors.ones_encoding(n), ref_factors.ones_encoding(n))
    for kind in ("wang", "ones"):
        _bits_equal(encoding.left_encoding(n, kind),
                    ref_encoding.left_encoding(n, kind))
        for inverse in (False, True):
            _bits_equal(encoding.left_encoding_image(n, kind, inverse),
                        ref_encoding.left_encoding_image(n, kind, inverse))
    assert encoding.EPS == ref_encoding.EPS
    with pytest.raises(ValueError, match="unknown encoding"):
        encoding.left_encoding(n, "gray")


def test_ftconfig_fields_and_defaults_match_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(api.FTConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_planbase.FTConfig)]
    assert got == want
    cfg = api.FTConfig(transactions=2, per_signal=True)
    assert hash(cfg) == hash(api.FTConfig(transactions=2, per_signal=True))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("log", list(range(0, 30)))
def test_hopper_plan_keeps_regimes_and_register_radices(log):
    n = 1 << log
    p = make_plan(n, batch=4)
    ref = ref_plan.make_plan(n, batch=4)
    # the paper's 1/2/3-pass regime boundaries are the reference's
    assert p.kernel_factors == ref.kernel_factors
    assert p.num_passes == (1 if n <= MAX_BLOCK_N else 2 if log <= 22 else 3)
    for f, stages in zip(p.kernel_factors, p.stages):
        radices = [s.radix for s in stages]
        assert all(2 <= r <= 16 for r in radices)
        assert int(np.prod(radices, dtype=np.int64)) == f
        assert radices == sorted(radices, reverse=True)
        assert len(radices) == -(-(f.bit_length() - 1) // 4)
        assert stages[-1].m == 1 if stages else f == 1


def test_block_radices_examples():
    assert block_radices(8192) == (16, 8, 8, 8)
    assert block_radices(1024) == (16, 8, 8)
    assert block_radices(32) == (8, 4)
    assert block_radices(2) == (2,)
    with pytest.raises(ValueError, match="power-of-two"):
        block_radices(24)


@pytest.mark.parametrize("batch,bs", [(1, 1), (1024, 1), (4096, 4),
                                      (1 << 16, 64)])
def test_default_bs_fills_the_sms(batch, bs):
    p = make_plan(8192, batch=batch)
    assert p.bs == bs
    groups = batch // (p.bs * 4)
    assert groups >= NUM_SMS or p.bs == 1
    assert batch // (2 * p.bs * 4) < NUM_SMS


@pytest.mark.parametrize("n,batch", [(16, 8), (1024, 1024), (8192, 64),
                                     (1 << 17, 64), (1 << 23, 4)])
def test_plan_from_reference_carries_the_reference_plan(n, batch):
    ref = ref_plan.make_plan(n, batch=batch)
    p = plan_from_reference(
        ref.n, ref.kernel_factors,
        tuple(tuple(s.radix for s in st) for st in ref.stages), ref.bs,
        ref.inverse)
    assert p.describe() == ref.describe()
    assert [[(s.radix, s.m) for s in st] for st in p.stages] == \
        [[(s.radix, s.m) for s in st] for st in ref.stages]
    assert (p.n, p.kernel_factors, p.bs, p.inverse, p.num_passes) == \
        (ref.n, ref.kernel_factors, ref.bs, ref.inverse, ref.num_passes)


def test_plan_from_reference_rejects_bad_fields():
    with pytest.raises(ValueError, match="multiply"):
        plan_from_reference(1024, (512,), ((512,),), 8)
    with pytest.raises(ValueError, match="radix tuples"):
        plan_from_reference(1024, (1024,), ((32, 32), (2,)), 8)
    with pytest.raises(ValueError, match="do not split|multiply"):
        plan_from_reference(1024, (1024,), ((32, 16),), 8)


@pytest.mark.parametrize("n", [1024, 8192])
def test_reference_stages_match_stage_by_stage(n, rng):
    """On the reference's own stages the port's recursion agrees with the
    reference's after every stage prefix (the intermediates) and at the
    end."""
    ref = ref_plan.make_plan(n, batch=4)
    p = plan_from_reference(
        ref.n, ref.kernel_factors,
        tuple(tuple(s.radix for s in st) for st in ref.stages), ref.bs)
    x = (rng.standard_normal((4, n))
         + 1j * rng.standard_normal((4, n))).astype(np.complex64)
    for k in range(1, len(p.stages[0]) + 1):
        got = stockham._fft_recursive(torch.from_numpy(x),
                                      list(p.stages[0][:k]), False).numpy()
        want = np.asarray(ref_stockham._fft_recursive(
            x, list(ref.stages[0][:k]), False))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# FFTSpec
# ---------------------------------------------------------------------------


def test_spec_is_hashable_value_object():
    s1 = api.FFTSpec(shape=(8, 1024), ft=api.FTConfig(groups=4))
    s2 = api.FFTSpec(shape=(8, 1024), ft=api.FTConfig(groups=4))
    assert s1 == s2 and hash(s1) == hash(s2)
    assert {s1: "a"}[s2] == "a"
    assert s1 != dataclasses.replace(s1, dtype="complex128")
    assert s1 != dataclasses.replace(s1, ft=api.FTConfig(groups=2))
    assert s1 != dataclasses.replace(s1, device="cpu")
    # canonicalization: dtype objects and list shapes normalize
    for dt in (torch.complex64, np.complex64, np.dtype("complex64")):
        assert api.FFTSpec(shape=[8, 1024], dtype=dt,
                           ft=api.FTConfig(groups=4)) == s1
    assert api.FFTSpec(shape=(8, 1024), device=torch.device("cpu")).device \
        == "cpu"


def test_spec_validation_messages():
    with pytest.raises(ValueError, match="positive sizes"):
        api.FFTSpec(shape=())
    with pytest.raises(ValueError, match="complex"):
        api.FFTSpec(shape=(8, 64), dtype="float32")
    with pytest.raises(ValueError, match="rank"):
        api.FFTSpec(shape=(8, 64), rank=4)
    with pytest.raises(ValueError, match="fewer axes"):
        api.FFTSpec(shape=(64,), rank=2)
    with pytest.raises(ValueError, match="FTConfig"):
        api.FFTSpec(shape=(8, 64), ft={"groups": 4})
    with pytest.raises(TypeError, match="FFTSpec"):
        api.plan({"shape": (8, 64)})


class _FftMesh:
    """Four ``fft`` ranks as the spec validates a mesh (no process group)."""

    mesh_dim_names = ("fft",)
    device_type = "cpu"

    def size(self, dim=None):
        return 4


@pytest.mark.parametrize("kw,decomp", [
    (dict(mesh=_FftMesh(), rank=2, ft=api.FTConfig()), "slab"),
    (dict(mesh=_FftMesh(), rank=2), "slab")])
def test_spec_rejects_unported_paths_naming_the_roadmap_item(kw, decomp):
    """The n-D mesh paths, the 2-D ABFT among them, are ported: the specs
    that raised naming their roadmap item now plan (an (8, 64) grid on
    four fft ranks: the slab's one all-to-all beats the pencil's
    natural-order gathers on the modelled bytes, the ABFT rides the
    slab)."""
    p = api.plan(api.FFTSpec(shape=(8, 64), device="cpu", **kw))
    assert p.decomp == decomp and p.volume is not None


@pytest.mark.parametrize("kw,shape", [(dict(rank=2), (8, 64, 64)),
                                      (dict(real=True), (8, 64))])
def test_rank2_and_real_specs_plan_and_run_on_the_cpu(kw, shape):
    """The local extensions' specs plan, with every axis's tables uploaded
    at build, and run: rank 2 against np.fft.fft2, real against
    np.fft.rfft."""
    rng = np.random.default_rng(sum(shape))
    p = api.plan(api.FFTSpec(shape=shape, device="cpu", **kw))
    assert all(ax is not None and ax.tables[False] for ax in p.axes)
    if kw.get("real"):
        x = rng.standard_normal(shape).astype(np.float32)
        got, want = p.rfft(torch.from_numpy(x)), np.fft.rfft(x)
        np.testing.assert_allclose(p.irfft(got).numpy(), x, rtol=0,
                                   atol=4e-5 * np.abs(x).max())
    else:
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        got, want = p.fft(torch.from_numpy(x)), np.fft.fft2(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4e-5 * np.abs(want).max())


def test_cuda_request_without_a_card_raises(monkeypatch):
    """The default device is cuda; without a card plan() raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = api.FFTSpec(shape=(2, 16))
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.plan(spec)
    with pytest.raises(ValueError, match="cuda or cpu"):
        api.plan(api.FFTSpec(shape=(2, 16), device="meta"))


# ---------------------------------------------------------------------------
# the plan cache under threads (port of test_plan_cache_threads.py)
# ---------------------------------------------------------------------------


def _hammer(fn, threads: int):
    barrier = threading.Barrier(threads)
    results = [None] * threads
    errors = []

    def worker(i):
        try:
            barrier.wait()
            results[i] = fn(i)
        except BaseException as e:          # pragma: no cover - fail path
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert not errors, errors
    return results


@dataclasses.dataclass(frozen=True)
class _RaceSpec:
    tag: int


class _RacePlan(planbase.Plan):
    builds: list[int] = []

    def __init__(self, spec):
        super().__init__(spec)
        _RacePlan.builds.append(spec.tag)
        time.sleep(0.05)      # hold the miss open across every racer


@pytest.fixture
def race_registry():
    planbase.register_plan_type(_RaceSpec, _RacePlan)
    _RacePlan.builds = []
    yield
    planbase._PLAN_TYPES.pop(_RaceSpec, None)
    planbase.plan_cache_clear()


def test_identical_spec_hammer_builds_exactly_once(race_registry):
    spec = _RaceSpec(tag=7)
    results = _hammer(lambda i: planbase.plan(spec), threads=16)
    assert _RacePlan.builds == [7]
    assert all(r is results[0] for r in results)


def test_distinct_specs_hammer_builds_one_each(race_registry):
    results = _hammer(lambda i: planbase.plan(_RaceSpec(tag=i % 4)),
                      threads=32)
    assert sorted(_RacePlan.builds) == [0, 1, 2, 3]
    for tag in range(4):
        group = [r for r in results if r.spec.tag == tag]
        assert all(r is group[0] for r in group)


def test_distinct_specs_build_concurrently(race_registry):
    t0 = time.perf_counter()
    _hammer(lambda i: planbase.plan(_RaceSpec(tag=100 + i)), threads=4)
    assert time.perf_counter() - t0 < 0.15, \
        "distinct-spec constructions serialized behind one lock"


def test_failed_build_retries_and_does_not_poison(race_registry):
    @dataclasses.dataclass(frozen=True)
    class _FlakySpec:
        tag: int

    calls = []

    class _FlakyPlan(planbase.Plan):
        def __init__(self, spec):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("transient build failure")
            super().__init__(spec)

    planbase.register_plan_type(_FlakySpec, _FlakyPlan)
    try:
        with pytest.raises(RuntimeError, match="transient"):
            planbase.plan(_FlakySpec(tag=0))
        assert isinstance(planbase.plan(_FlakySpec(tag=0)), _FlakyPlan)
    finally:
        planbase._PLAN_TYPES.pop(_FlakySpec, None)
        planbase.plan_cache_clear()


def test_fft_spec_hammer_one_plan(crand):
    """N threads planning one FFTSpec get the identical FFTPlan, the cache
    records one miss, and dispatch from every thread agrees bitwise."""
    api.plan_cache_clear()
    spec = api.FFTSpec(shape=(4, 256), device="cpu")
    results = _hammer(lambda i: api.plan(spec), threads=12)
    p = results[0]
    assert all(r is p for r in results)
    info = api.plan_cache_info()
    assert info.misses == 1 and info.hits == 11
    assert spec in api.plan_cache_keys()
    x = torch.from_numpy(crand(4, 256))
    y0 = p.fft(x).numpy()
    for y in _hammer(lambda i: api.plan(spec).fft(x).numpy(), threads=8):
        np.testing.assert_array_equal(y, y0)
    assert api.plan_cache_info().misses == 1


def test_cache_keys_and_info_shapes():
    api.plan_cache_clear()
    s1 = api.FFTSpec(shape=(2, 64), device="cpu")
    s2 = api.FFTSpec(shape=(2, 128), device="cpu")
    p1, p2 = api.plan(s1), api.plan(s2)
    assert api.plan(s1) is p1 and api.plan(s2) is p2
    keys = api.plan_cache_keys()
    assert keys[-1] == s2 and s1 in keys
    info = api.plan_cache_info()
    assert info.currsize == 2 and info.maxsize == 512
    api.plan_cache_clear()
    assert api.plan_cache_info().currsize == 0
    assert api.plan_cache_keys() == []
