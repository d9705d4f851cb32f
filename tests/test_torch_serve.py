"""The port's serving stack (``repro_torch.serve``: bucketing, scheduler,
telemetry, specs, runtime) against the reference ``repro.serve`` on the
same seeded inputs, on the CPU (``device="cpu"``: the kernels' plain
versions).

Mirrors every test of ``tests/test_serving_runtime.py`` and the local ones
of ``tests/test_serve_plan.py``; where the reference runs too, both get the
same numpy inputs and their outputs agree within the suite's ``ATOL[dtype]
* max|ref|`` (4e-5 complex64 and float32). Bucket labels, padded shapes,
``serve_plan``'s telemetry and the deterministic telemetry counters are
held equal. Every ``result()`` has a timeout.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serve as ref_serve
from repro.core.fft import api as ref_api

from repro_torch.core.fft import api
from repro_torch.serve import (BucketKey, DeadlineBatcher, Fault,
                               QueueFullError, RequestHandle,
                               RequestTimeoutError, RuntimeClosedError,
                               RuntimeConfig, ServeRequest, ServeRuntime,
                               SpecBucketer, build_fft_spec,
                               pad_transform_shape, percentiles, serve_plan)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.plan_cache_clear()
    ref_api.plan_cache_clear()
    yield
    api.plan_cache_clear()
    ref_api.plan_cache_clear()


def _cfg(**kw) -> RuntimeConfig:
    return RuntimeConfig(device=CPU, **kw)


def _np(y) -> np.ndarray:
    return y.numpy() if torch.is_tensor(y) else np.asarray(y)


def _served_by_reference(cfg: dict, requests):
    """The reference runtime's results for ``requests`` = [(x, submit
    kwargs)] under ``RuntimeConfig(**cfg)``."""
    with ref_serve.ServeRuntime(ref_serve.RuntimeConfig(**cfg)) as rt:
        hs = [rt.submit(x, **kw) for x, kw in requests]
        return [np.asarray(h.result(timeout=60.0)) for h in hs]


# -- bucketing policy -------------------------------------------------------

def test_pad_transform_shape_pow2():
    assert pad_transform_shape((1000,)) == (1024,)
    assert pad_transform_shape((1024,)) == (1024,)
    assert pad_transform_shape((100, 60)) == (128, 64)


def test_pad_transform_shape_mesh_floors():
    assert pad_transform_shape((8,), shards=4) == (16,)
    assert pad_transform_shape((8,), shards=4, real=True) == (32,)
    assert pad_transform_shape((64,), shards=4) == (64,)
    assert pad_transform_shape((2, 8), shards=4) == (4, 16)


def test_pad_transform_shape_rejects_bad():
    with pytest.raises(ValueError):
        pad_transform_shape(())
    with pytest.raises(ValueError):
        pad_transform_shape((0,))


@settings(max_examples=60, deadline=None)
@given(shape=st.lists(st.integers(1, 5000), min_size=1, max_size=3),
       shards=st.sampled_from([1, 2, 4, 8]), real=st.booleans())
def test_pad_transform_shape_matches_reference(shape, shards, real):
    assert pad_transform_shape(tuple(shape), shards=shards, real=real) \
        == ref_serve.pad_transform_shape(tuple(shape), shards=shards,
                                         real=real)


_DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64),
           (np.complex64, torch.complex64), (np.complex128, torch.complex128)]


@settings(max_examples=80, deadline=None)
@given(shape=st.lists(st.integers(1, 5000), min_size=1, max_size=2),
       dtypes=st.sampled_from(_DTYPES),
       op=st.sampled_from(["fft", "spectrum"]),
       real=st.booleans(), ft=st.booleans())
def test_key_for_matches_reference(shape, dtypes, op, real, ft):
    """Over a sample of request shapes and dtypes (numpy and torch): the
    same bucket, label and padding as the reference, or the same
    rejection."""
    npdt, tdt = dtypes
    ours, theirs = SpecBucketer(max_batch=4), ref_serve.SpecBucketer(
        max_batch=4)
    kw = dict(op=op, real=real, ft=ft)
    try:
        want = theirs.key_for(tuple(shape), npdt, **kw)
    except ValueError:
        for dt in (npdt, tdt):
            with pytest.raises(ValueError):
                ours.key_for(tuple(shape), dt, **kw)
        return
    for dt in (npdt, tdt):
        got = ours.key_for(tuple(shape), dt, **kw)
        assert dict(got.__dict__) == dict(want.__dict__)
        assert got.label == want.label
        assert ours.pad_elems(got, shape) == theirs.pad_elems(want, shape)


def test_key_for_canonicalizes():
    b = SpecBucketer(max_batch=4)
    k = b.key_for((1000,), np.float32, op="fft")
    assert k == BucketKey(tshape=(1024,), rank=1, dtype="complex64",
                          op="fft", real=False, ft=False)
    assert k.label == "fft:1024:c64"
    assert b.key_for((513,), np.complex64, op="fft") == k
    assert b.key_for((513,), torch.complex64, op="fft") == k
    assert b.key_for((1000,), np.float64, op="fft",
                     real=True).dtype == "complex128"
    assert b.key_for((1000,), np.float32, op="fft",
                     real=True).dtype == "complex64"
    assert "real" in b.key_for((8,), np.float32, op="fft", real=True).label
    assert b.key_for((8192,), np.complex64, ft=True).label \
        == "fft:8192:c64:ft"


def test_key_for_rejections():
    b = SpecBucketer(max_batch=4)
    with pytest.raises(ValueError, match="convolve"):
        b.key_for((64,), np.complex64, op="convolve")
    with pytest.raises(ValueError, match="ft=True"):
        b.key_for((64,), np.complex64, op="spectrum", ft=True)
    with pytest.raises(ValueError, match="single signals"):
        b.key_for((2, 3, 4), np.complex64)
    with pytest.raises(ValueError, match="real=True"):
        b.key_for((64,), np.complex64, real=True)


def test_pad_elems():
    b = SpecBucketer(max_batch=4)
    k = b.key_for((1000,), np.complex64)
    assert b.pad_elems(k, (1000,)) == 24
    assert b.pad_elems(k, (1024,)) == 0


def test_spec_for_requires_ft_config():
    b = SpecBucketer(max_batch=4, device=CPU)
    k = b.key_for((64,), np.complex64, ft=True)
    with pytest.raises(ValueError, match="FTConfig"):
        b.spec_for(k)
    spec = b.spec_for(b.key_for((64,), np.complex64))
    assert spec.shape == (4, 64) and spec.ft is None
    assert spec.device == "cpu"


# -- scheduler: deadline batching + backpressure ----------------------------

def _req(key="k", timeout_ms=None):
    return ServeRequest(key=key, x=None, handle=RequestHandle(),
                        timeout_ms=timeout_ms)


def test_batcher_closes_on_max_batch():
    b = DeadlineBatcher(max_batch=3, deadline_ms=10_000, queue_depth=16)
    try:
        reqs = [_req() for _ in range(3)]
        for r in reqs:
            b.submit(r)
        batch = b.next_batch(timeout=1.0)
        assert batch is not None and len(batch.requests) == 3
        assert [r.handle for r in batch.requests] == [r.handle for r in reqs]
        assert b.pending == 0
    finally:
        b.close(drain=False)


def test_batcher_closes_on_deadline():
    b = DeadlineBatcher(max_batch=64, deadline_ms=20, queue_depth=16)
    try:
        t0 = time.monotonic()
        b.submit(_req())
        batch = b.next_batch(timeout=2.0)
        dt = time.monotonic() - t0
        assert batch is not None and len(batch.requests) == 1
        assert dt >= 0.015, f"closed before the deadline ({dt*1e3:.1f}ms)"
    finally:
        b.close(drain=False)


def test_batcher_backpressure():
    b = DeadlineBatcher(max_batch=64, deadline_ms=10_000, queue_depth=2)
    try:
        b.submit(_req())
        b.submit(_req())
        with pytest.raises(QueueFullError):
            b.submit(_req())
    finally:
        b.close(drain=False)


def test_batcher_request_timeout():
    b = DeadlineBatcher(max_batch=64, deadline_ms=10_000, queue_depth=4)
    try:
        timed_out = []
        b._on_timeout = timed_out.append
        r = _req(timeout_ms=20)
        b.submit(r)
        with pytest.raises(RequestTimeoutError):
            r.handle.result(timeout=2.0)
        assert timed_out == ["k"]
        assert b.pending == 0
    finally:
        b.close(drain=False)


def test_batcher_close_drain_flushes_partials():
    b = DeadlineBatcher(max_batch=64, deadline_ms=10_000, queue_depth=4)
    b.submit(_req("a"))
    b.submit(_req("b"))
    b.close(drain=True)
    keys = {b2.key for b2 in iter(lambda: b.next_batch(timeout=0.2), None)}
    assert keys == {"a", "b"}
    with pytest.raises(RuntimeClosedError):
        b.submit(_req())


def test_batcher_close_nodrain_fails_pending():
    b = DeadlineBatcher(max_batch=64, deadline_ms=10_000, queue_depth=4)
    r = _req()
    b.submit(r)
    b.close(drain=False)
    with pytest.raises(RuntimeClosedError):
        r.handle.result(timeout=1.0)


def test_percentiles_shape():
    assert percentiles([]) == {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}
    p = percentiles([0.001, 0.002, 0.100])
    assert p["p50_ms"] == pytest.approx(2.0)
    assert p["p99_ms"] > p["p50_ms"]
    assert p == ref_serve.percentiles([0.001, 0.002, 0.100])


# -- runtime end-to-end (the CPU device) ------------------------------------

def test_runtime_padded_fft_roundtrip(assert_spectrum_close):
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(n).astype(np.float32)
          for n in (1000, 1024, 513, 700)]
    with ServeRuntime(_cfg(max_batch=4, deadline_ms=5.0, workers=2)) as rt:
        handles = [rt.submit(x) for x in xs]
        got = [h.result(timeout=30.0) for h in handles]
        for h in handles:
            assert h.info["bucket"] == "fft:1024:c64"
        stats = rt.stats()["buckets"]["fft:1024:c64"]
        assert stats["submitted"] == 4 and stats["completed"] == 4
        assert stats["pad_waste"] > 0
        assert stats["p50_ms"] > 0
    assert api.plan_cache_info().currsize == 1
    want = _served_by_reference(dict(max_batch=4, deadline_ms=5.0),
                                [(x, {}) for x in xs])
    for x, y, w in zip(xs, got, want):
        assert isinstance(y, np.ndarray) and y.shape == (1024,)
        assert_spectrum_close(y, w)
        assert_spectrum_close(y, np.fft.fft(x, 1024).astype(np.complex64))


def test_runtime_one_batch_when_full():
    rng = np.random.default_rng(1)
    with ServeRuntime(_cfg(max_batch=4, deadline_ms=10_000.0,
                           workers=1)) as rt:
        hs = [rt.submit(rng.standard_normal(256).astype(np.float32))
              for _ in range(4)]
        for h in hs:
            h.result(timeout=30.0)
        st_ = rt.stats()["buckets"]["fft:256:c64"]
        assert st_["batches"] == 1 and st_["batch_occupancy"] == 1.0


def test_runtime_mixed_buckets(assert_spectrum_close):
    rng = np.random.default_rng(2)
    reqs = [(rng.standard_normal(100).astype(np.float32), {}),
            (rng.standard_normal((20, 30)).astype(np.float32), {}),
            (rng.standard_normal(256).astype(np.float32),
             {"op": "spectrum"})]
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=5.0)) as rt:
        hs = [rt.submit(x, **kw) for x, kw in reqs]
        got = [h.result(timeout=30.0) for h in hs]
        assert [y.shape for y in got] == [(128,), (32, 32), (256,)]
        assert got[2].dtype.kind == "f"
        assert set(rt.stats()["buckets"]) == {"fft:128:c64", "fft:32x32:c64",
                                              "spectrum:256:c64"}
    assert api.plan_cache_info().currsize == 3
    for y, w in zip(got, _served_by_reference(
            dict(max_batch=2, deadline_ms=5.0), reqs)):
        assert_spectrum_close(y, w)


def test_runtime_real_bucket(assert_spectrum_close):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(1000).astype(np.float32)
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=5.0)) as rt:
        y = rt.submit(x, real=True).result(timeout=30.0)
    assert y.shape == (513,)
    (w,) = _served_by_reference(dict(max_batch=2, deadline_ms=5.0),
                                [(x, {"real": True})])
    assert_spectrum_close(y, w)
    assert_spectrum_close(y, np.fft.rfft(x, 1024).astype(np.complex64))


def test_runtime_rejects_bad_requests():
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=5.0)) as rt:
        with pytest.raises(ValueError, match="convolve"):
            rt.submit(np.zeros(64, np.complex64), op="convolve")
        with pytest.raises(ValueError, match="ft=True"):
            rt.submit(np.zeros(64, np.float32), faults=Fault())
    with pytest.raises(RuntimeClosedError):
        rt.submit(np.zeros(64, np.float32))


def test_runtime_backpressure_counts_rejects():
    with ServeRuntime(_cfg(max_batch=64, deadline_ms=10_000.0,
                           queue_depth=2, workers=1)) as rt:
        x = np.zeros(128, np.float32)
        rt.submit(x)
        rt.submit(x)
        with pytest.raises(QueueFullError):
            rt.submit(x)
        assert rt.stats()["buckets"]["fft:128:c64"]["rejected"] == 1
        rt.batcher.flush()


def test_runtime_ft_injection_local(assert_spectrum_close):
    """One SEU per batch through the fused-kernel ABFT: detected, located,
    corrected — the telemetry ledger is exact and the same as the
    reference's."""
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal(256).astype(np.float32) for _ in range(4)]
    def reqs_of(fault_cls):
        faults = [None, fault_cls(col=7, eps_re=300.0), None, None]
        return [(x, dict(ft=True, faults=f)) for x, f in zip(xs, faults)]

    reqs = reqs_of(Fault)
    with ServeRuntime(_cfg(max_batch=4, deadline_ms=10_000.0,
                           workers=1)) as rt:
        hs = [rt.submit(x, **kw) for x, kw in reqs]
        ys = [h.result(timeout=60.0) for h in hs]
        st_ = rt.stats()["buckets"]["fft:256:c64:ft"]
    for x, y in zip(xs, ys):
        assert_spectrum_close(y, np.fft.fft(x).astype(np.complex64))
    assert (st_["injected"], st_["detected"], st_["corrected"]) == (1, 1, 1)
    assert st_.get("uncorrectable", 0) == 0
    assert hs[1].info["flagged"] and hs[1].info["corrected"] == 1
    assert hs[1].info["location"] == 1           # the faulted batch row
    with ref_serve.ServeRuntime(ref_serve.RuntimeConfig(
            max_batch=4, deadline_ms=10_000.0, workers=1)) as rt:
        rh = [rt.submit(x, **kw) for x, kw in reqs_of(ref_serve.Fault)]
        want = [np.asarray(h.result(timeout=60.0)) for h in rh]
        ref_st = rt.stats()["buckets"]["fft:256:c64:ft"]
    for y, w in zip(ys, want):
        assert_spectrum_close(y, w)
    for k in ("injected", "detected", "corrected", "uncorrectable",
              "batches", "batch_occupancy", "pad_waste"):
        assert st_[k] == ref_st[k], k
    for k in ("flagged", "location", "corrected"):
        assert hs[1].info[k] == rh[1].info[k], k


def test_runtime_ft_local_single_seu_limit():
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=10_000.0,
                           workers=1)) as rt:
        x = np.zeros(256, np.float32)
        h1 = rt.submit(x, ft=True, faults=Fault())
        h2 = rt.submit(x, ft=True, faults=Fault())
        with pytest.raises(ValueError, match="one SEU"):
            h1.result(timeout=30.0)
        with pytest.raises(ValueError, match="one SEU"):
            h2.result(timeout=30.0)
        assert rt.stats()["buckets"]["fft:256:c64:ft"]["failed"] == 2


def test_runtime_warmup_means_one_trace():
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=2.0, workers=1)) as rt:
        x = np.zeros(512, np.float32)
        for _ in range(3):
            rt.submit(x).result(timeout=30.0)
        assert api.plan_cache_info().currsize == 1
        assert rt.stats()["buckets"]["fft:512:c64"]["batches"] >= 1


def test_runtime_concurrent_submitters(assert_spectrum_close):
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(128).astype(np.float32) for _ in range(16)]
    results = [None] * 16
    with ServeRuntime(_cfg(max_batch=4, deadline_ms=2.0, workers=2)) as rt:
        def client(i):
            results[i] = rt.submit(xs[i]).result(timeout=60.0)
        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in ts)
        assert rt.stats()["buckets"]["fft:128:c64"]["completed"] == 16
    for x, y in zip(xs, results):
        assert_spectrum_close(y, np.fft.fft(x, 128).astype(np.complex64))


def test_runtime_results_come_back_as_sent(assert_spectrum_close):
    """A numpy request gets a numpy row, a CPU tensor a CPU tensor; each
    is the request's own padded transform, and no two results share a
    batch buffer that a later batch overwrites."""
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal(n).astype(np.float32) for n in (60, 64, 33)]
    with ServeRuntime(_cfg(max_batch=2, deadline_ms=10_000.0,
                           workers=1)) as rt:
        first = [rt.submit(xs[0]), rt.submit(torch.from_numpy(xs[1]))]
        got = [h.result(timeout=30.0) for h in first]
        kept = [_np(y).copy() for y in got]
        later = [rt.submit(xs[2]), rt.submit(xs[2])]
        for h in later:
            h.result(timeout=30.0)
    assert isinstance(got[0], np.ndarray)
    assert torch.is_tensor(got[1]) and got[1].device.type == "cpu"
    for x, y, k in zip(xs, got, kept):
        assert_spectrum_close(_np(y), np.fft.fft(x, 64).astype(np.complex64))
        np.testing.assert_array_equal(_np(y), k)


def test_runtime_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeRuntime(RuntimeConfig())
    assert RuntimeConfig().device == "cuda"


def test_runtime_telemetry_counters_match_reference():
    """One worker and a long deadline make the batches deterministic: the
    counters of every bucket equal the reference's."""
    rng = np.random.default_rng(7)
    reqs = ([(rng.standard_normal(n).astype(np.float32), {})
             for n in (100, 128, 77, 128, 90, 65, 128, 128, 99)]
            + [(rng.standard_normal((10, 12)).astype(np.float32), {})] * 3
            + [(rng.standard_normal(200).astype(np.float32),
                {"op": "spectrum"})] * 2
            + [(rng.standard_normal(64).astype(np.float32), {"ft": True})])
    keys = ("submitted", "completed", "failed", "rejected", "timeouts",
            "batches", "batch_occupancy", "pad_waste", "injected",
            "detected", "corrected", "uncorrectable")

    def counters(serve, **extra):
        with serve.ServeRuntime(serve.RuntimeConfig(
                max_batch=4, deadline_ms=10_000.0, workers=1,
                **extra)) as rt:
            hs = [rt.submit(x, **kw) for x, kw in reqs]
            hs.append(rt.submit(reqs[-1][0], ft=True,
                                faults=serve.Fault(col=3, eps_re=250.0)))
            rt.drain()
            for h in hs:
                h.result(timeout=60.0)
            snap = rt.stats()["buckets"]
        return {b: {k: s[k] for k in keys if k in s} for b, s in snap.items()}

    import repro_torch.serve as port_serve
    assert counters(port_serve, device=CPU) == counters(ref_serve)


def test_serving_imports_no_jax_and_no_reference():
    """Every repro_torch module imports with JAX blocked, and none of them
    loads a module of the reference package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.serve.runtime' in names\n"
        "assert 'repro_torch.launch.serve' in names\n"
        "for mod in ('models.attention', 'models.transformer', "
        "'models.model', 'models.ssm', 'train.loop', 'configs.gemma3_1b', "
        "'configs.recurrentgemma_2b', 'configs.xlstm_350m'):\n"
        "    assert 'repro_torch.' + mod in names, mod\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) > 30


# -- serve_plan: the single-batch executor ----------------------------------

def _inputs(rng, shape, real):
    if real:
        return rng.standard_normal(shape).astype(np.float32)
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


# (label, build_fft_spec kwargs, batch shape, real input, kernel shape)
PLAN_CASES = [
    ("fft", {}, (4, 64), False, None),
    ("spectrum", {"op": "spectrum"}, (4, 64), False, None),
    ("real", {"real": True}, (4, 64), True, None),
    ("real spectrum", {"op": "spectrum", "real": True}, (4, 64), True, None),
    ("rank-2", {"dims": 2}, (2, 8, 16), False, None),
    ("real rank-2", {"dims": 2, "real": True}, (2, 8, 16), True, None),
    ("convolve", {"op": "convolve"}, (4, 60), True, (7,)),
    ("correlate", {"op": "correlate"}, (4, 60), True, (7,)),
    ("convolve rank-2", {"op": "convolve", "dims": 2}, (2, 8, 8), True,
     (3, 3)),
    ("ft", {"ft": True}, (4, 64), False, None),
]


@pytest.mark.parametrize("label,kw,shape,real,kshape", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_serve_plan_info_and_output_match_reference(label, kw, shape, real,
                                                    kshape, rng,
                                                    assert_spectrum_close):
    x = _inputs(rng, shape, real)
    k = None if kshape is None else rng.standard_normal(kshape).astype(
        np.float32)
    op = kw.get("op", "fft")
    ref_spec = ref_serve.build_fft_spec(shape, kernel_shape=kshape, **kw)
    spec = build_fft_spec(shape, kernel_shape=kshape, device=CPU, **kw)
    assert spec.shape == ref_spec.shape and spec.rank == ref_spec.rank
    assert spec.dtype == ref_spec.dtype and spec.real == ref_spec.real
    want, want_info = ref_serve.serve_plan(ref_api.plan(ref_spec), x, op=op,
                                           kernel=k)
    got, info = serve_plan(api.plan(spec), torch.from_numpy(x), op=op,
                           kernel=None if k is None else torch.from_numpy(k))
    assert got.device.type == "cpu"
    if "score" in info:      # two clean roundoffs, each far below 1e-4
        assert info.pop("score") < 1e-4 and want_info.pop("score") < 1e-4
    assert info == want_info
    assert_spectrum_close(got.numpy(), np.asarray(want))


def test_serve_plan_kernel_ops_require_kernel(crand):
    p = api.plan(build_fft_spec((4, 128), op="convolve", kernel_shape=(31,),
                                device=CPU))
    x = np.asarray(crand(4, 128)).real.astype(np.float32)
    with pytest.raises(ValueError, match="needs a kernel"):
        serve_plan(p, x, op="convolve")
    with pytest.raises(ValueError, match="needs a kernel"):
        serve_plan(p, x, op="correlate")


def test_serve_plan_rejects_unknown_op(crand):
    p = api.plan(build_fft_spec((4, 128), device=CPU))
    with pytest.raises(ValueError, match="op must be"):
        serve_plan(p, crand(4, 128), op="dct")


def test_serve_plan_local_ft_inject_telemetry(crand, assert_spectrum_close):
    """The inject= passthrough: one SEU -> flagged verdict at the same
    location as the reference's, corrected output, complete telemetry."""
    x = crand(4, 256)
    spec = build_fft_spec((4, 256), ft=True, threshold=1e-4, device=CPU)
    p = api.plan(spec)
    y_clean, info_clean = serve_plan(p, x)
    assert info_clean["ft"] is True and info_clean["flagged"] is False
    assert info_clean["corrected"] == 0 and info_clean["location"] == -1
    assert_spectrum_close(y_clean.numpy(), np.fft.fft(x))
    inj = np.asarray([0, 1, 3, 1, 250.0, 0.0], np.float32)
    # the descriptor addresses (tile, row): the reference's plan takes the
    # whole batch as one tile here, the port's Hopper plan a tile a signal
    y_f, info_f = serve_plan(p, x, inject=inj, bs=4)
    rp = ref_api.plan(ref_serve.build_fft_spec((4, 256), ft=True,
                                               threshold=1e-4))
    y_r, info_r = ref_serve.serve_plan(rp, x, inject=inj)
    assert info_f["flagged"] is True and info_f["corrected"] == 1
    assert info_f["location"] == info_r["location"] >= 0
    assert info_f["score"] == pytest.approx(info_r["score"], rel=1e-3)
    assert_spectrum_close(y_f.numpy(), np.fft.fft(x))
    assert_spectrum_close(y_f.numpy(), np.asarray(y_r))


# -- the mesh knobs off a mesh, and on a one-rank mesh -----------------------

class _Mesh:
    """A mesh-like of 4 fft ranks: the bucketer reads its ``shape``, as the
    reference's does (``axis_names``)."""

    shape = {"fft": 4}
    axis_names = ("fft",)


class _OneRankMesh:
    """A one-rank ``fft`` mesh as a ``DeviceMesh`` presents itself to the
    plans (named dimensions, ``size``, ``device_type``)."""

    mesh_dim_names = ("fft",)
    device_type = "cpu"

    def size(self, dim=None):
        return 1


def _reference_one_device_mesh():
    import jax
    from jax.sharding import AxisType

    return jax.make_mesh((1,), ("fft",), axis_types=(AxisType.Auto,))


_SPEC_FIELDS = ("shape", "dtype", "rank", "axis", "decomp", "natural_order",
                "real", "chunks")


@pytest.mark.parametrize("kw", [{"chunks": 2}, {"decomp": "slab"},
                                {"natural_order": False},
                                {"mesh": "one rank"}],
                         ids=["chunks", "decomp", "transposed", "mesh"])
def test_build_fft_spec_mesh_paths_name_item_10(kw, crand,
                                                assert_spectrum_close):
    """The mesh knobs off a mesh (``chunks``, ``decomp``, the transposed
    order) and a one-rank mesh resolve the reference's spec and serve the
    reference's output and telemetry: the plan is the local one."""
    ours, theirs = dict(kw), dict(kw)
    if "mesh" in kw:
        ours["mesh"] = _OneRankMesh()
        theirs["mesh"] = _reference_one_device_mesh()
    shape, dims = ((2, 8, 16), 2) if "decomp" in kw else ((4, 64), 1)
    spec = build_fft_spec(shape, dims=dims, device=CPU, **ours)
    ref_spec = ref_serve.build_fft_spec(shape, dims=dims, **theirs)
    assert {f: getattr(spec, f) for f in _SPEC_FIELDS} == \
        {f: getattr(ref_spec, f) for f in _SPEC_FIELDS}
    x = crand(shape[0], int(np.prod(shape[1:]))).reshape(shape)
    got, info = serve_plan(api.plan(spec), torch.from_numpy(x))
    want, want_info = ref_serve.serve_plan(ref_api.plan(ref_spec), x)
    assert info == want_info
    assert (info["shards"], info["data"]) == (1, 1)
    assert_spectrum_close(got.numpy(), np.asarray(want))


def test_runtime_over_a_mesh_names_item_10(assert_spectrum_close):
    """The bucketer pads for the mesh's fft ranks as the reference's does;
    a runtime over a one-rank mesh is the local runtime, and ``chunks``
    serves the reference's results locally."""
    ours, theirs = SpecBucketer(mesh=_Mesh()), ref_serve.SpecBucketer(
        mesh=_Mesh())
    assert ours.shards == theirs.shards == 4
    for shape, kw in (((60, 100), {}), ((8,), {}), ((8,), {"real": True}),
                      ((2, 8), {}), ((700000,), {"ft": True})):
        dt = np.float32 if kw.get("real") else np.complex64
        got, want = ours.key_for(shape, dt, **kw), theirs.key_for(shape, dt,
                                                                   **kw)
        assert got.label == want.label and got.tshape == want.tshape
    assert ours.key_for((60, 100), np.complex64).tshape == (64, 128)
    rng = np.random.default_rng(7)
    xs = [(rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64) for n in (48, 64, 40)]
    want = _served_by_reference(dict(max_batch=4, workers=1, chunks=2),
                                [(x, {}) for x in xs])
    for mesh, chunks in ((_OneRankMesh(), 1), (None, 2)):
        with ServeRuntime(_cfg(workers=1, max_batch=4, chunks=chunks),
                          mesh=mesh) as rt:
            assert rt.channel is None and rt.bucketer.shards == 1
            got = [rt.submit(x).result(timeout=60.0) for x in xs]
        for g, w in zip(got, want):
            assert_spectrum_close(_np(g), w)


# -- the consolidated spec string -------------------------------------------

def test_spec_keys_are_the_reference_keys():
    """The CLI's ``--fft-spec`` keys and their argparse destinations are the
    reference's, and the parser shares them with the runtime package."""
    from repro_torch.launch import serve as launch
    from repro_torch.serve import SPEC_KEYS

    assert launch.SPEC_KEYS is SPEC_KEYS
    assert {k: v[0] for k, v in SPEC_KEYS.items()} == {
        k: v[0] for k, v in ref_serve.SPEC_KEYS.items()}
