"""The port's checked-GEMM path against the reference on the same numpy
inputs: the fused kernel's plain version against ``ft_matmul_pallas``
(interpret mode) on all five outputs, ``decode_columns``, the eager
``ft_matmul``, the ``core.gemm`` plan (mirrors of the in-process tests of
``tests/test_ft_gemm.py``, each on both backends and compared with the
reference's ``y`` and stats), the FT policy and fault descriptors, and the
one-sided FFT baseline. Everything runs on the CPU, where
``backend="fused"`` runs the kernel's plain version.

Tolerances: integer-valued float32 operands make every sum exact in any
order, so those comparisons are bitwise. Random float32 operands: each
output to 1e-5 * its max (two float32 accumulations of K <= 256 terms in
different orders, about sqrt(K) * 2^-24 relative). bfloat16 ``c``: one bf16
rounding step, 2^-7 * max|c| (the float32 sums can fall on either side of
a rounding boundary).
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import abft as ref_abft
from repro.core import gemm as ref_gemm
from repro.core.ft import FTPolicy as RefFTPolicy
from repro.core.ft import injection as ref_injection
from repro.core.plan import FTConfig as RefFTConfig
from repro.kernels import ref as ref_ref
from repro.kernels.ft_matmul import ft_matmul_pallas

from repro_torch.core import abft, gemm
from repro_torch.core import plan as planbase
from repro_torch.core.ft import FTPolicy, FTStats, injection
from repro_torch.core.plan import FTConfig
from repro_torch.kernels import ref
from repro_torch.kernels import ft_matmul as ftk

CPU = "cpu"
FT = FTConfig(threshold=1e-3)
REF_FT = RefFTConfig(threshold=1e-3)
REF_BACKEND = {"eager": "xla", "fused": "pallas"}
TILES = [(128, 128, 128), (64, 64, 64), (128, 64, 128), (64, 128, 64)]
PARTS = ("c", "out2", "pred2", "out3", "pred3")
STATS = ("flagged", "corrected", "uncorrectable", "score")


def _int_mats(rng, m, k, n):
    """Integer-valued float32 operands: every sum is exact in float32."""
    x = rng.integers(-4, 5, (m, k)).astype(np.float32)
    w = rng.integers(-4, 5, (k, n)).astype(np.float32)
    return x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    """Tensor or JAX array -> numpy (bf16 widened to float32 exactly)."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _bits_equal(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _stats_equal(got, want, score_rtol=0.0):
    """Counts exactly; the score to ``score_rtol``. Its normalizer
    sqrt(mean(out2^2)) sums squares past 2^24, which is not exact even on
    integer operands, so two libraries' reduction orders differ by ulps:
    1e-6 relative against the reference, exact between the port's two
    backends (one torch reduction)."""
    for key in STATS[:3]:
        assert float(got[key]) == float(want[key]), key
    np.testing.assert_allclose(float(got["score"]), float(want["score"]),
                               rtol=score_rtol, atol=0)


def _ref_stats_equal(got, want):
    _stats_equal(got, want, score_rtol=1e-6)


def _port_plan(x, w, backend, **kw):
    return gemm.plan(gemm.spec_for(x, w, ft=FT, backend=backend, **kw))


def _ref_plan(x, w, backend, **kw):
    return ref_gemm.plan(ref_gemm.spec_for(x, w, ft=REF_FT,
                                           backend=REF_BACKEND[backend],
                                           **kw))


def _both(x, w, backend, inject=None, **kw):
    """(port y, stats), (reference y, stats) of one checked product."""
    got = _port_plan(_t(x), _t(w), backend, **kw).ft_matmul(
        _t(x), _t(w), inject=None if inject is None else torch.tensor(inject))
    want = _ref_plan(jnp.asarray(x), jnp.asarray(w), backend, **kw).ft_matmul(
        jnp.asarray(x), jnp.asarray(w),
        inject=None if inject is None else jnp.asarray(inject, jnp.float32))
    return got, want


# ---------------------------------------------------------------------------
# the fused kernel's plain version vs the reference kernel
# ---------------------------------------------------------------------------

_INJECTS = {
    "none": None,
    "one": [171.0, 40.0, 1.0, 333.0],
    "three": [[3.0, 7.0, 1.0, 500.0], [200.0, 90.0, 1.0, -450.0],
              [128.0, 127.0, 0.0, 600.0]],          # the last one disabled
}


@pytest.mark.parametrize("inject", list(_INJECTS))
@pytest.mark.parametrize("tiles", TILES)
def test_plain_matches_reference_kernel_bitwise(rng, tiles, inject):
    bm, bk, bn = tiles
    x, w = _int_mats(rng, 256, 128, 128)
    inj = _INJECTS[inject]
    want = ft_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), bm=bm, bk=bk, bn=bn, interpret=True,
        inject=None if inj is None else jnp.asarray(inj, jnp.float32))
    got = ftk.ft_matmul(_t(x), _t(w), bm=bm, bk=bk, bn=bn,
                        inject=None if inj is None else torch.tensor(inj))
    plain = ftk.ft_matmul_plain(
        _t(x), _t(w), inject=None if inj is None else torch.tensor(inj))
    for part in PARTS:
        _bits_equal(getattr(got, part), getattr(want, part))
        _bits_equal(getattr(plain, part), getattr(want, part))
    assert got.c.dtype == torch.float32
    assert all(getattr(got, p).shape == (128,) for p in PARTS[1:])


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_random(rng, xdtype):
    """Random operands at tolerance; bf16 activations against f32 weights,
    the model path's mix."""
    x = rng.standard_normal((256, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    inj = [[17.0, 5.0, 1.0, 40.0]]
    want = ft_matmul_pallas(jnp.asarray(x, xdtype), jnp.asarray(w),
                            interpret=True, inject=jnp.asarray(inj))
    got = ftk.ft_matmul(_t(x).to(getattr(torch, xdtype)), _t(w),
                        inject=torch.tensor(inj))
    assert got.c.dtype == getattr(torch, xdtype)
    for part in PARTS:
        g, r = _np(getattr(got, part)), _np(getattr(want, part))
        step = 2.0 ** -7 if (part == "c" and xdtype == "bfloat16") else 1e-5
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=step * np.abs(r).max(), err_msg=part)


def test_kernel_wrapper_argument_checks():
    x, w = torch.zeros(128, 64), torch.zeros(64, 128)
    with pytest.raises(ValueError, match="contraction mismatch"):
        ftk.ft_matmul(x, torch.zeros(32, 128))
    with pytest.raises(ValueError, match="tile-aligned"):
        ftk.ft_matmul(torch.zeros(100, 128), torch.zeros(128, 128))
    with pytest.raises(ValueError, match="tile-aligned"):
        ftk.ft_matmul(x, w)                      # K = 64 vs bk = 128
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        ftk.ft_matmul(x.to("meta"), w.to("meta"), bk=64)
    before = ftk.ft_matmul.launches
    ftk.ft_matmul(x, w, bk=64)                   # CPU: the plain version
    assert ftk.ft_matmul.launches == before
    with pytest.raises(ValueError, match="bm, bn in"):
        ftk.check_kernel_tiles(32, 128, 128)
    with pytest.raises(ValueError, match="multiple of 32"):
        ftk.check_kernel_tiles(128, 128, 48)
    ftk.check_kernel_tiles(64, 128, 96)


def test_checks_fields_match_reference():
    from repro.kernels.ft_matmul import FTMatmulChecks as RefChecks
    assert ftk.FTMatmulChecks._fields == RefChecks._fields


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_oracles_match_reference(rng, dtype):
    a = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96, 32)).astype(np.float32)
    ta, tb = _t(a).to(getattr(torch, dtype)), _t(b).to(getattr(torch, dtype))
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    got, want = ref.matmul_ref(ta, tb), ref_ref.matmul_ref(ja, jb)
    assert got.dtype == ta.dtype
    step = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=step * np.abs(_np(want)).max())
    for g, r in zip(ref.abft_matmul_ref(ta, tb),
                    ref_ref.abft_matmul_ref(ja, jb)):
        np.testing.assert_allclose(_np(g), _np(r), rtol=0,
                                   atol=1e-5 * np.abs(_np(r)).max())


# ---------------------------------------------------------------------------
# decode_columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_correction", [True, False])
def test_decode_columns_matches_reference(rng, with_correction):
    """Equal d2/d3 in, equal y and stats out: clean columns at roundoff,
    three single faults, one non-integer (two-fault) ratio, one decode out
    of range, one column exactly at zero."""
    t, n = 64, 32
    y = rng.standard_normal((t, n)).astype(np.float32)
    d2 = (rng.standard_normal(n) * 1e-4).astype(np.float32)
    d3 = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    for col, row, eps in ((3, 0, 40.0), (9, 63, -25.0), (20, 17, 7.5)):
        d2[col], d3[col] = -eps, -eps * (row + 1)
    d2[11], d3[11] = 30.0, 30.0 * 5.5            # non-integer location
    d2[14], d3[14] = 30.0, 30.0 * (t + 3)        # location past the rows
    d2[27], d3[27] = 0.0, 0.0
    kw = dict(t=t, threshold=1e-2, with_correction=with_correction)
    scale = np.float32(2.0)
    yg, sg = abft.decode_columns(_t(y.copy()), _t(d2), _t(d3),
                                 torch.tensor(scale), **kw)
    yr, sr = ref_abft.decode_columns(jnp.asarray(y), jnp.asarray(d2),
                                     jnp.asarray(d3), jnp.asarray(scale),
                                     **kw)
    _bits_equal(yg, yr)
    _stats_equal(sg, sr)
    assert float(sg["flagged"]) == 5.0
    assert float(sg["corrected"]) == (3.0 if with_correction else 0.0)
    assert float(sg["uncorrectable"]) == 2.0


# ---------------------------------------------------------------------------
# the eager ft_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inject", [None, [70.0, 9.0, 700.0],
                                    [[5.0, 3.0, 40.0], [200.0, 100.0, -9.0]]])
@pytest.mark.parametrize("batched", [False, True])
def test_eager_ft_matmul_matches_reference_bitwise(rng, batched, inject):
    x, w = _int_mats(rng, 256, 64, 128)
    if batched:
        x = x.reshape(4, 64, 64)
    kw = dict(threshold=1e-3)
    yg, sg = abft.ft_matmul(
        _t(x), _t(w), inject=None if inject is None else torch.tensor(inject),
        **kw)
    yr, sr = ref_abft.ft_matmul(
        jnp.asarray(x), jnp.asarray(w),
        inject=None if inject is None else jnp.asarray(inject), **kw)
    _bits_equal(yg, yr)
    _ref_stats_equal(sg, sr)
    np.testing.assert_array_equal(_np(yg), x @ w)   # corrected exactly


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_eager_ft_matmul_random_matches_reference(rng, xdtype):
    x = rng.standard_normal((128, 256)).astype(np.float32)
    w = rng.standard_normal((256, 64)).astype(np.float32)
    inj = [[33.0, 12.0, 90.0]]
    yg, sg = abft.ft_matmul(_t(x).to(getattr(torch, xdtype)), _t(w),
                            inject=torch.tensor(inj))
    yr, sr = ref_abft.ft_matmul(jnp.asarray(x, xdtype), jnp.asarray(w),
                                inject=jnp.asarray(inj))
    assert yg.dtype == getattr(torch, xdtype)
    step = 2.0 ** -7 if xdtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(_np(yg), _np(yr), rtol=0,
                               atol=step * np.abs(_np(yr)).max())
    for key in ("flagged", "corrected", "uncorrectable"):
        assert float(sg[key]) == float(sr[key]) == (
            0.0 if key == "uncorrectable" else 1.0), key
    # the score is the injected column's |eps| / scale: roundoff apart
    np.testing.assert_allclose(float(sg["score"]), float(sr["score"]),
                               rtol=1e-4)


def test_rank_errors():
    with pytest.raises(ValueError, match="batch dim"):
        abft.ft_matmul(torch.zeros(2, 2, 4, 8), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="2-D"):
        abft.ft_matmul(torch.zeros(4, 8), torch.zeros(2, 8, 8))


# ---------------------------------------------------------------------------
# the plan layer (mirrors of tests/test_ft_gemm.py)
# ---------------------------------------------------------------------------

def test_plan_registry_shared_cache():
    spec = gemm.GEMMSpec(shape=(128, 128, 128), ft=FT, device=CPU)
    p1 = gemm.plan(spec)
    p2 = gemm.plan(gemm.GEMMSpec(shape=(128, 128, 128), ft=FT, device=CPU))
    assert p1 is p2                      # equal specs hash to one plan
    assert gemm.plan(gemm.GEMMSpec(shape=(128, 128, 256), ft=FT,
                                   device=CPU)) is not p1
    d = p1.describe()
    assert d["plan"] == "GEMMPlan" and d["ft"] and d["volume"]["flops"] > 0
    with pytest.raises(TypeError, match="GEMMSpec"):
        planbase.plan(object())


def test_plan_base_has_no_operator_imports():
    """The shared base is op-agnostic: operator families register
    themselves; core/plan.py imports none of them."""
    src = inspect.getsource(planbase)
    for line in src.splitlines():
        ls = line.strip()
        if ls.startswith(("import ", "from ")):
            assert "fft" not in ls and "gemm" not in ls, ls


def test_one_policy_configures_both_families():
    """The SAME FTPolicy-derived config attaches to FFT and GEMM specs."""
    from repro_torch.core.fft.api import FFTSpec
    from repro_torch.core.fft.api import plan as fft_plan

    pol = FTPolicy(protect_linears=True, threshold=2e-3)
    cfg = pol.to_ft_config()
    assert isinstance(cfg, FTConfig)
    fp = fft_plan(FFTSpec(shape=(8, 64), ft=cfg, device=CPU))
    gp = gemm.plan(gemm.GEMMSpec(shape=(128, 64, 64), ft=cfg, device=CPU))
    assert fp.spec.ft is cfg and gp.spec.ft is cfg


@pytest.mark.parametrize("shape", [(100, 100, 128), (128, 128, 100),
                                   (32, 128, 48), (4, 72, 40)],
                         ids=["K", "N", "N48", "MKN"])
def test_fused_plan_requires_tile_alignment(rng, shape):
    """The kernel takes K and N in multiples of its tiles: the fused plan
    zero-pads a K or N that no tile divides (and M), so a product of any
    shape runs on the kernel. Its plain version gives the eager path's y
    and stats bit for bit on integer operands, a fault in the last row
    and column corrected; on the CPU auto stays eager, aligned or not."""
    m, k, n = shape
    x, w = _int_mats(rng, m, k, n)
    p = gemm.plan(gemm.spec_for(_t(x), _t(w), ft=FT, backend="fused"))
    assert p.backend == "fused"
    inj = torch.tensor([m - 1.0, n - 1.0, 1.0, 300.0])
    y, s = p.ft_matmul(_t(x), _t(w), inject=inj)
    ye, se = _port_plan(_t(x), _t(w), "eager").ft_matmul(_t(x), _t(w),
                                                         inject=inj)
    _bits_equal(y, ye)
    _stats_equal(s, se)
    assert (float(s["flagged"]), float(s["corrected"])) == (1.0, 1.0)
    np.testing.assert_array_equal(_np(y), x @ w)
    assert gemm.plan(gemm.GEMMSpec(shape=shape, ft=FT,
                                   device=CPU)).backend == "eager"


@pytest.mark.parametrize("shape,tiles", [
    ((64, 1024, 1344), (128, 128, 64)),     # the sLSTM FFN's gate and up
    ((64, 1344, 1024), (128, 64, 128)),     # and its down product
    ((4, 3072, 8192), (128, 128, 128)),     # aligned: unchanged
    ((8, 96, 192), (128, 32, 64)),
], ids=["gate", "down", "aligned", "k96"])
def test_spec_for_fits_the_tiles_to_k_and_n(rng, shape, tiles):
    """``spec_for`` takes the largest bk of 128, 64, 32 that divides K and
    the largest bn of the kernel's tiles that divides N, so the fused plan
    takes xLSTM-350M's 1344-wide FFN products; its plain version there
    gives the eager path's y and stats bit for bit (integer operands), with
    a fault corrected."""
    m, k, n = shape
    x, w = _int_mats(rng, m, k, n)
    spec = gemm.spec_for(_t(x), _t(w), ft=FT, backend="fused")
    assert spec.tiles == tiles
    inj = torch.tensor([m - 1.0, n - 3.0, 1.0, 300.0])
    y, s = gemm.plan(spec).ft_matmul(_t(x), _t(w), inject=inj)
    ye, se = _port_plan(_t(x), _t(w), "eager").ft_matmul(_t(x), _t(w),
                                                         inject=inj)
    _bits_equal(y, ye)
    _stats_equal(s, se)
    assert (float(s["flagged"]), float(s["corrected"])) == (1.0, 1.0)
    np.testing.assert_array_equal(_np(y), x @ w)


def test_spec_for_leaves_what_no_tile_divides_to_raise():
    """A K or N that no kernel tile divides gets the smallest tile (bk 32,
    bn 64), to which the fused path pads it; the plan builds. ``tiles``
    given by the caller are kept."""
    for k, n, tiles in ((100, 128, (128, 32, 128)),
                        (128, 100, (128, 128, 64)),
                        (48, 1344, (128, 32, 64))):
        x, w = torch.zeros(4, k), torch.zeros(k, n)
        spec = gemm.spec_for(x, w, ft=FT, backend="fused")
        assert spec.tiles == tiles
        assert gemm.plan(spec).backend == "fused"
    x, w = torch.zeros(4, 1344), torch.zeros(1344, 1344)
    assert gemm.spec_for(x, w, tiles=(64, 64, 64)).tiles == (64, 64, 64)


@pytest.mark.parametrize("m", [1, 4, 100])
def test_padded_fused_matches_eager_bitwise(rng, m):
    """An M that is no multiple of the tile runs the fused path on zero
    rows padded to a multiple of 64: y and every stat equal the eager
    path's (and the reference's torch-free path) bit for bit on integer
    operands, clean and with a fault."""
    x, w = _int_mats(rng, m, 256, 128)
    for inject in (None, [m // 2, 77.0, 1.0, 300.0]):
        (y1, s1), (yr, sr) = _both(x, w, "eager", inject)
        y2, s2 = _port_plan(_t(x), _t(w), "fused").ft_matmul(
            _t(x), _t(w),
            inject=None if inject is None else torch.tensor(inject))
        assert y2.shape == (m, 128)
        for y in (y2, yr):
            _bits_equal(y1, y)
        _stats_equal(s1, s2)
        _ref_stats_equal(s1, sr)
        np.testing.assert_array_equal(_np(y2), x @ w)
        assert float(s2["flagged"]) == float(inject is not None)


@pytest.mark.parametrize("m", [1, 4, 100])
def test_padded_fused_corrects_a_fault_on_the_last_row(rng, m):
    """A fault on row M - 1, the last real row before the padding, is
    located there and corrected; a descriptor aimed at a padded row
    addresses a zero row the decode never reports (a row past M is not a
    valid location)."""
    x, w = _int_mats(rng, m, 128, 256)
    p = _port_plan(_t(x), _t(w), "fused")
    y, s = p.ft_matmul(_t(x), _t(w),
                       inject=torch.tensor([m - 1.0, 200.0, 1.0, -250.0]))
    assert (float(s["flagged"]), float(s["corrected"]),
            float(s["uncorrectable"])) == (1.0, 1.0, 0.0)
    np.testing.assert_array_equal(_np(y), x @ w)
    y, s = p.ft_matmul(_t(x), _t(w),
                       inject=torch.tensor([m + 1.0, 5.0, 1.0, 250.0]))
    assert float(s["corrected"]) == 0.0
    np.testing.assert_array_equal(_np(y), x @ w)


@pytest.mark.parametrize("tiles", TILES)
def test_fused_matches_eager_bitwise(rng, tiles):
    x, w = _int_mats(rng, 256, 128, 128)
    inj = [171.0, 40.0, 1.0, 333.0]
    for inject in (None, inj):
        (y1, s1), (yr, sr) = _both(x, w, "eager", inject)
        (y2, s2), (yr2, sr2) = _both(x, w, "fused", inject, tiles=tiles)
        for y in (y2, yr, yr2):
            _bits_equal(y1, y)
        _stats_equal(s1, s2)
        for s in (sr, sr2):
            _ref_stats_equal(s1, s)


_CORNERS = [(0, 0), (0, 255), (255, 0), (255, 255),     # output corners
            (127, 127), (128, 128), (127, 128), (128, 127)]  # tile seams


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("row,col", _CORNERS)
def test_detect_and_correct_at_tile_corners(rng, backend, row, col):
    x, w = _int_mats(rng, 256, 128, 256)
    (y, s), (yr, sr) = _both(x, w, backend, [row, col, 1.0, 400.0])
    assert float(s["flagged"]) == 1.0
    assert float(s["corrected"]) == 1.0
    assert float(s["uncorrectable"]) == 0.0
    # integer operands: the decoded correction restores the product exactly
    np.testing.assert_array_equal(_np(y), x @ w)
    _bits_equal(y, yr)
    _ref_stats_equal(s, sr)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_corrects_concurrent_seus_in_distinct_columns(rng, backend):
    x, w = _int_mats(rng, 256, 128, 128)
    inj = [[3.0, 7.0, 1.0, 500.0], [200.0, 90.0, 1.0, -450.0],
           [128.0, 127.0, 1.0, 600.0]]
    (y, s), (yr, sr) = _both(x, w, backend, inj)
    assert float(s["flagged"]) == 3.0
    assert float(s["corrected"]) == 3.0
    np.testing.assert_array_equal(_np(y), x @ w)
    _bits_equal(y, yr)
    _ref_stats_equal(s, sr)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_flags_multi_seu_in_same_column_uncorrectable(rng, backend):
    x, w = _int_mats(rng, 256, 128, 128)
    inj = [[3.0, 7.0, 1.0, 500.0], [200.0, 7.0, 1.0, -450.0]]
    (y, s), (yr, sr) = _both(x, w, backend, inj)
    assert float(s["flagged"]) == 1.0         # one corrupted column
    assert float(s["uncorrectable"]) == 1.0   # non-integer location ratio
    assert float(s["corrected"]) == 0.0
    _bits_equal(y, yr)
    _ref_stats_equal(s, sr)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_disabled_descriptor_is_a_noop(rng, backend):
    x, w = _int_mats(rng, 128, 128, 128)
    (y, s), (yr, sr) = _both(x, w, backend, [3.0, 7.0, 0.0, 500.0])
    assert float(s["flagged"]) == 0.0
    np.testing.assert_array_equal(_np(y), x @ w)
    _bits_equal(y, yr)
    _ref_stats_equal(s, sr)


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_batched_3d_activations_roundtrip(rng, backend):
    b, t, k, n = 4, 64, 128, 128
    x = rng.integers(-4, 5, (b, t, k)).astype(np.float32)
    w = rng.integers(-4, 5, (k, n)).astype(np.float32)
    # rows of the descriptor index the flattened B*T token axis
    (y, s), (yr, sr) = _both(x, w, backend, [t + 5.0, 9.0, 1.0, 700.0])
    assert y.shape == (b, t, n)
    assert float(s["flagged"]) == 1.0 and float(s["corrected"]) == 1.0
    np.testing.assert_array_equal(_np(y), x @ w)
    _bits_equal(y, yr)
    _ref_stats_equal(s, sr)


def test_ft_dot_stats_traverses_by_key():
    """Aggregation keys off the dict KEY, not leaf position, through nested
    dicts, and agrees with the reference's."""
    def tree(lib, ones):
        s1 = {"flagged": lib(2.0), "corrected": lib(1.0),
              "uncorrectable": lib(1.0), "score": lib(0.5)}
        s2 = {"flagged": ones(3), "corrected": 0 * ones(3),
              "uncorrectable": 0 * ones(3), "score": 0.25 * ones(3)}
        return {"attn": s1, "moe": {"experts": s2}}

    agg = abft.ft_dot_stats(tree(torch.tensor, torch.ones))
    want = ref_abft.ft_dot_stats(tree(jnp.float32, jnp.ones))
    assert float(agg["ft_flagged"]) == 5.0       # 2 + sum(ones(3))
    assert float(agg["ft_corrected"]) == 1.0
    assert float(agg["ft_max_score"]) == 0.5
    for key in want:
        assert float(agg[key]) == float(want[key]), key
    empty = abft.ft_dot_stats({})
    assert float(empty["ft_flagged"]) == 0.0


# ---------------------------------------------------------------------------
# spec validation, devices, volume
# ---------------------------------------------------------------------------

def test_gemm_spec_validation():
    with pytest.raises(ValueError, match="shape"):
        gemm.GEMMSpec(shape=(128, 128), device=CPU)
    with pytest.raises(ValueError, match="floating"):
        gemm.GEMMSpec(shape=(1, 1, 1), dtype="int32", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        gemm.GEMMSpec(shape=(1, 1, 1), backend="pallas", device=CPU)
    with pytest.raises(ValueError, match="tiles"):
        gemm.GEMMSpec(shape=(1, 1, 1), tiles=(0, 1, 1), device=CPU)
    with pytest.raises(TypeError, match="FTConfig"):
        gemm.GEMMSpec(shape=(1, 1, 1), ft=FTPolicy(), device=CPU)
    spec = gemm.GEMMSpec(shape=(2, 3, 4), dtype=torch.bfloat16, device=CPU)
    assert spec.dtype == "bfloat16" and spec.device == "cpu"
    assert gemm.GEMMSpec(shape=(2, 3, 4)).device == "cuda"
    with pytest.raises(TypeError, match="GEMMSpec"):
        gemm.plan(FT)


def test_cuda_gemm_spec_without_a_card_raises(monkeypatch):
    """The default device is cuda; without a card plan() raises instead of
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GEMMSpec.device.*no CUDA"):
        gemm.plan(gemm.GEMMSpec(shape=(128, 128, 128), ft=FT))
    with pytest.raises(ValueError, match="cuda or cpu"):
        gemm.plan(gemm.GEMMSpec(shape=(128, 128, 128), device="meta"))


def test_plan_matmul_and_operand_checks(rng):
    x = _t(rng.standard_normal((4, 32, 64)).astype(np.float32))
    w = _t(rng.standard_normal((64, 16)).astype(np.float32))
    p = gemm.plan(gemm.spec_for(x.to(torch.bfloat16), w))
    assert p.spec.shape == (128, 64, 16) and p.spec.device == "cpu"
    y = p.matmul(x.to(torch.bfloat16), w)          # bf16 x f32 promotes
    assert y.dtype == torch.float32 and y.shape == (4, 32, 16)
    assert p(x.to(torch.bfloat16), w).shape == (4, 32, 16)
    with pytest.raises(ValueError, match="do not match GEMMSpec.shape"):
        p.matmul(x[:2], w)
    with pytest.raises(ValueError, match="without an FTConfig"):
        p.ft_matmul(x, w)
    with pytest.raises(ValueError, match="runs on cpu"):
        gemm.plan(gemm.spec_for(x, w, ft=FT)).ft_matmul(x, w.to("meta"))


def test_volume_and_describe_match_reference():
    for ft, rft in ((FT, REF_FT), (None, None)):
        p = gemm.plan(gemm.GEMMSpec(shape=(256, 128, 384), ft=ft,
                                    device=CPU))
        r = ref_gemm.plan(ref_gemm.GEMMSpec(shape=(256, 128, 384), ft=rft))
        assert p.volume == r.volume
        got, want = p.describe(), r.describe()
        for key in ("plan", "spec", "ft", "m", "k", "n", "dtype", "tiles"):
            assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# the FT policy and the GEMM fault descriptors
# ---------------------------------------------------------------------------

def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


def test_ftpolicy_fields_and_defaults_match_reference():
    assert _fields(FTPolicy) == _fields(RefFTPolicy)
    pol = FTPolicy(mesh_groups=8, recompute_uncorrectable=False,
                   threshold=2e-3, gemm_backend="eager")
    ref_pol = RefFTPolicy(mesh_groups=8, recompute_uncorrectable=False,
                          threshold=2e-3, gemm_backend="xla")
    assert pol.kernel_kwargs() == ref_pol.kernel_kwargs()
    got = dataclasses.asdict(pol.to_ft_config())
    assert got == dataclasses.asdict(ref_pol.to_ft_config())
    assert isinstance(pol.to_ft_config(), FTConfig)
    with pytest.raises(dataclasses.FrozenInstanceError):
        pol.threshold = 1.0


def test_ftstats_zeros_and_merge():
    assert [f.name for f in dataclasses.fields(FTStats)] == [
        "detected", "corrected", "max_score", "skipped_updates"]
    z = FTStats.zeros(device=CPU)
    assert all(getattr(z, f).shape == () and getattr(z, f).dtype
               == torch.float32 for f in ("detected", "max_score"))
    one = FTStats(detected=torch.tensor(2.0), corrected=torch.tensor(1.0),
                  max_score=torch.tensor(0.5),
                  skipped_updates=torch.tensor(0.0))
    two = z.merge(one).merge(dataclasses.replace(
        one, max_score=torch.tensor(0.25)))
    assert float(two.detected) == 4.0 and float(two.corrected) == 2.0
    assert float(two.max_score) == 0.5 and float(two.skipped_updates) == 0.0
    assert float(z.detected) == 0.0                  # merge is pure


def test_for_step_gemm_matches_reference():
    entries = ((3, 1, 5, 200, 60.0, -25.0), (7, 2, 0, 17, -8.0, 4.0))
    got = injection.FaultSchedule(entries=entries)
    want = ref_injection.FaultSchedule(entries=entries)
    for step in range(9):
        g, r = got.for_step_gemm(step), want.for_step_gemm(step)
        assert g.dtype == torch.float32 and g.shape == (1, 5)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got.for_step_gemm(3).numpy(),
                                  [[1, 5, 200, 1, 60.0]])


# ---------------------------------------------------------------------------
# the one-sided (offline) FFT baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("corrupt", [False, True])
def test_oneside_fft_matches_reference(crand, dtype, corrupt):
    """Tolerance: y to 4e-5 / 1e-11 * max|ref| (the suite's ATOL); the
    flags exactly (a corrupted signal scores ~1e2 over the threshold, a
    clean one ~1e-6 under it)."""
    x = crand(8, 256, dtype)

    def hit(y, row=5, col=17, eps=40.0):
        return y.at[row, col].add(eps) if hasattr(y, "at") else \
            y.index_put((torch.tensor(row), torch.tensor(col)),
                        torch.tensor(eps, dtype=y.dtype), accumulate=True)

    kw = dict(corrupt=hit if corrupt else None)
    y, flags, count = abft.oneside_fft(_t(x), **kw)
    yr, fr, cr = ref_abft.oneside_fft(jnp.asarray(x), **kw)
    atol = (4e-5 if dtype == np.complex64 else 1e-11) * np.abs(yr).max()
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=0, atol=atol)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(fr))
    assert int(count) == int(cr) == (1 if corrupt else 0)
    np.testing.assert_allclose(y.numpy(), np.fft.fft(x), rtol=0, atol=atol)
