"""The port's sharded two-side ABFT (``repro_torch.core.fft.distributed``:
``_grouped_verdict``, ``_ft_dist_fft``, ``ft_distributed_fft``) without a
process group.

* ``_grouped_verdict`` against the reference's on hand-built divergences
  for one rank (the reference's ``psum`` over a single member, the port's
  ``all_reduce`` a no-op): clean, a single fault, a cs2-row and a cs3-row
  fault, two faults in one group; stats equal up to rounding, verdicts
  exactly, the corrected outputs to rounding.
* The left check of pass 1: the twiddled spectrum times the conjugate
  twiddle, summed over k1, equals the sum of the untwiddled FFT
  (``block_fft_plain``), at both dtypes.
* An ft plan's groups, transactions and ``volume`` against the
  reference's arithmetic on the meshes the spec validates.
* The scenario catalogue (``torch_shards.FT_SCENARIOS``) on D = 1, 2 and 4
  in-process shards (``torch_shards.ft_on_shards``: the mesh's own loop on
  threads), a two-pass N2 tail among them; chunks bitwise; the threshold
  edge.

Tolerance: ``ATOL[dtype] * max|ref|`` (4e-5 complex64, 1e-11 complex128).
"""
import numpy as np
import pytest
import torch

from conftest import ATOL

from repro_torch.core.fft import distributed as tdist
from repro_torch.core.fft.api import FFTSpec, FTConfig, plan
from repro_torch.core.fft.plan import make_plan
from repro_torch.kernels.stockham import block_fft_plain
from torch_shards import (CHUNKED, FT_GROUPS, FT_N, FT_SCENARIOS,
                          expected_verdicts, ft_on_shards, inject_rows,
                          pencil, telemetry)

CPU = "cpu"
DTYPES = ("complex64", "complex128")


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


# ---------------------------------------------------------------------------
# the verdict against the reference's
# ---------------------------------------------------------------------------


def _divergences(case, dtype, seed=0):
    """(ylg, d2, d3, cs2_out) for G = 4 groups of s = 4 signals of
    (4, 16) local points: noise at 1e-7 of the data, plus the case's
    fault(s) in group 1 (and 3)."""
    g, s, shape = 4, 4, (4, 16)
    rng = np.random.default_rng(seed)

    def draw(*sh):
        return (rng.standard_normal(sh)
                + 1j * rng.standard_normal(sh)).astype(dtype)

    ylg = draw(g, s, *shape)
    cs2_out = ylg.sum(axis=1)
    d2 = 1e-7 * draw(g, *shape)
    d3 = 1e-7 * draw(g, *shape)
    e = draw(*shape)
    if case == "single":        # signal id 3 of group 1 hit by e
        d2[1] -= e
        d3[1] -= 3 * e
    elif case == "cs2":         # group 1's transported cs2 row hit
        d2[1] += e
    elif case == "cs3":         # group 1's transported cs3 row hit
        d3[1] += e
    elif case == "double":      # ids 1 and 4 of group 3
        e2 = draw(*shape)
        d2[3] -= e + e2
        d3[3] -= e + 4 * e2
    return ylg, d2, d3, cs2_out


@pytest.mark.parametrize("correct", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["clean", "single", "cs2", "cs3",
                                  "double"])
def test_grouped_verdict_matches_reference(case, dtype, correct):
    import jax
    import jax.numpy as jnp

    from repro.core.fft import distributed as rdist

    ylg, d2, d3, cs2_out = _divergences(case, dtype)
    g, s = ylg.shape[:2]
    kw = dict(threshold=1e-4, s=s, n=4 * 16 * 4, md=1, bl=g * s, gl=g,
              correct=correct, row_offset=2)
    with jax.enable_x64(dtype == "complex128"):
        fn = jax.vmap(lambda *a: rdist._grouped_verdict(*a, axis="fft",
                                                        **kw),
                      axis_name="fft")
        want_y, want = (np.asarray(t[0]) for t in fn(
            *(jnp.asarray(t)[None] for t in (ylg, d2, d3, cs2_out))))
    yt = torch.from_numpy(ylg.copy())
    stats = tdist._grouped_verdict(
        yt, torch.from_numpy(d2), torch.from_numpy(d3),
        torch.from_numpy(cs2_out), all_reduce=lambda t: None, **kw).numpy()
    assert stats.dtype == want.dtype
    rtol = 1e-5 if dtype == "complex64" else 1e-12
    np.testing.assert_allclose(stats[:, 0], want[:, 0], rtol=rtol)
    np.testing.assert_array_equal(stats[:, 1:], want[:, 1:])
    _close(yt.numpy(), want_y, dtype)
    flagged, loc, fixable, csf = (stats[:, i] for i in range(1, 5))
    if case == "clean":
        assert not flagged.any()
    elif case == "single":
        assert fixable[1] and loc[1] == 1 * g * s + 2 + 1 * s + 2
    elif case in ("cs2", "cs3"):
        assert csf[1] and flagged[1] and not fixable.any()
    else:
        assert flagged[3] and not fixable[3] and not csf[3]


# ---------------------------------------------------------------------------
# pass 1's left check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_pass1_left_check_undoes_the_twiddle(dtype):
    """Summed over k1, pass 1's twiddled output times
    ``Pencil.left_twiddle`` equals the untwiddled FFT over n1 of the same
    columns (``block_fft_plain``), which the left check predicts from
    point 0: n1 * x[0]."""
    n, shards, rank, rows = 1 << 14, 4, 3, 3
    p = pencil(n, shards, dtype, CPU)
    x = torch.from_numpy(_rand((rows, n), str(dtype).split(".")[1], 1))
    src = tdist.Source(x.view(-1), rank * p.n2l, n, p.n2)
    send = torch.empty((shards, p.n1l, rows, p.n2l), dtype=dtype)
    p.pass1(src, rows, rank, inverse=False, send=send)
    got = torch.sum(send.view(p.n1, rows, p.n2l)
                    * p.left_twiddle(rank)[:, None, :], dim=0)
    cols = torch.as_strided(x, (rows, p.n2l, p.n1), (n, 1, p.n2),
                            rank * p.n2l)
    plain = block_fft_plain(cols.contiguous(), make_plan(p.n1).stages[0])
    want = plain.sum(dim=-1)
    _close(got.numpy(), want.numpy(), str(dtype).split(".")[1])
    _close(want.numpy(), p.n1 * cols[..., 0].numpy(),
           str(dtype).split(".")[1])


# ---------------------------------------------------------------------------
# an ft plan's resolution
# ---------------------------------------------------------------------------


class _Mesh:
    """A mesh as the spec validates one: names, sizes and device type."""

    def __init__(self, **sizes):
        self.sizes = sizes
        self.mesh_dim_names = tuple(sizes)
        self.device_type = "cpu"

    def size(self, dim=None):
        return list(self.sizes.values())[dim]


@pytest.mark.parametrize("sizes", [dict(fft=4), dict(data=2, fft=2)],
                         ids=["fft4", "data2xfft2"])
@pytest.mark.parametrize("b,n,dtype,ftkw,chunks,natural", [
    (8, 1 << 12, "complex64", dict(groups=4), 1, True),
    (8, 1 << 12, "complex128", dict(groups=4), 2, False),
    (16, 1 << 14, "complex64", dict(group_size=2), 0, True),
    (256, 1 << 20, "complex64", dict(groups=4, transactions=2), 0, True),
    (12, 1 << 12, "complex64", dict(), 4, True)],
    ids=["G4", "c128-2", "size2-auto", "2^20-transactions", "auto-groups"])
def test_ft_plan_resolves_as_the_reference(sizes, b, n, dtype, ftkw, chunks,
                                           natural):
    """The groups (``resolve_abft_groups`` over the data dimension), the
    transaction count (whole groups; ``chunks=0`` takes
    ``ft.transactions``) and ``volume`` (``collective_volume(ft=True)``)
    of a sharded ft plan are the reference plan's arithmetic."""
    from repro.core.fft import distributed as rd

    mesh = _Mesh(**sizes)
    shards, dsize = sizes["fft"], sizes.get("data", 1)
    ft = FTConfig(**ftkw)
    p = plan(FFTSpec((b, n), dtype=dtype, mesh=mesh, ft=ft, chunks=chunks,
                     natural_order=natural, device=CPU))
    g = rd.resolve_abft_groups(b, groups=ft.groups, group_size=ft.group_size,
                               data_shards=dsize)
    dsz = dsize if b % dsize == 0 and g % dsize == 0 else 1
    ce = rd.resolve_chunks(g // dsz, max(1, chunks or ft.transactions))
    assert (p.decomp, p.groups, p.chunks) == ("pencil", g, ce)
    assert p.volume == rd.collective_volume(
        n, b, shards, itemsize=np.dtype(dtype).itemsize, ft=True,
        natural_order=natural, groups=g, data_shards=dsz, chunks=ce)


def test_ft_spec_validation_on_a_mesh():
    """The ft spec on a mesh keeps the reference's refusals: groups that
    do not divide the batch or the data dimension, and a real rank-1 ft
    spec."""
    with pytest.raises(ValueError, match="must divide batch"):
        plan(FFTSpec((8, 1 << 12), mesh=_Mesh(fft=4), ft=FTConfig(groups=3),
                     device=CPU))
    with pytest.raises(ValueError, match="multiple of the data-axis size"):
        plan(FFTSpec((8, 1 << 12), mesh=_Mesh(data=4, fft=2),
                     ft=FTConfig(groups=2), device=CPU))
    with pytest.raises(ValueError, match="no ft pipeline"):
        FFTSpec((8, 1 << 12), mesh=_Mesh(fft=4), ft=FTConfig(), real=True,
                device=CPU)
    with pytest.raises(ValueError, match=r"expects \(B, N\)"):
        tdist.ft_distributed_fft(torch.zeros(4), _Mesh(fft=4))
    with pytest.raises(ValueError, match="requires a mesh"):
        tdist.ft_distributed_fft(torch.zeros(2, 64), None)


# ---------------------------------------------------------------------------
# the scenario catalogue on D in-process shards
# ---------------------------------------------------------------------------


def _close(got, want, dtype, factor=1.0):
    got, want = np.asarray(got), np.asarray(want)
    tol = factor * ATOL[np.dtype(dtype)] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _natural_of(y, p, transposed):
    if not transposed:
        return y
    return y.reshape(-1, p.n1, p.n2).transpose(0, 2, 1).reshape(-1, p.n)


_SHARD_CASES = [(1, None), (2, None), (4, None), (4, (8, 8))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shards,tail", _SHARD_CASES,
                         ids=["D1", "D2", "D4", "D4-two-pass"])
def test_ft_catalogue_on_shards(dtype, shards, tail):
    """The catalogue's cases without chunks on D threads, an SEU's fft
    rank taken mod D: verdicts, y after correction, the same telemetry on
    every shard (``ft_on_shards`` checks it), one residual a shard under
    the reference's bound; chunks 2 and 4 bitwise chunks 1 on the
    chunked cases."""
    n = FT_N
    x = torch.from_numpy(_rand((8, n), dtype, 3))
    ref = np.fft.fft(x.numpy())
    thr = FT_SCENARIOS["threshold"][dtype]
    mag = FT_SCENARIOS["mag"][dtype]
    p = pencil(n, shards, x.dtype, CPU, tail)
    bulk = {}
    for sc in FT_SCENARIOS["cases"]:
        kw = dict(sc["kw"])
        chunks = kw.pop("chunks", 1)
        if chunks > 1 and sc["name"].split("_c")[0] not in CHUNKED:
            continue
        recompute = kw.pop("recompute_uncorrectable", False)
        res = ft_on_shards(x, shards, groups=FT_GROUPS, threshold=thr,
                           chunks=chunks, p=p, recompute=recompute,
                           inject=inject_rows(sc["inject"], mag, shards),
                           **kw)
        tele = telemetry(res)
        assert len(tele["shard_delta"]) == shards
        assert max(tele["shard_delta"]) < (1e-4 if dtype == "complex64"
                                           else 1e-12)
        y = _natural_of(res.y.numpy(), p,
                        not kw.get("natural_order", True))
        expected_verdicts(sc["name"], tele, y, ref, ATOL[np.dtype(dtype)])
        if chunks == 1:
            bulk[sc["name"]] = (res.y, tele)
        else:
            by, bt = bulk[sc["name"].split("_c")[0]]
            assert torch.equal(res.y, by), sc["name"]
            for f in ("flagged", "location", "correctable",
                      "checksum_fault", "corrected"):
                assert tele[f] == bt[f], (sc["name"], f)
            np.testing.assert_allclose(tele["group_score"],
                                       bt["group_score"], rtol=0.05)


@pytest.mark.parametrize("shards", [1, 4])
def test_ft_threshold_edge_on_shards(shards):
    """tests/test_ft_injection_policy.py:171-190: a threshold of exactly
    the SEU's score unflags (the test is strict), 0.99 of it flags."""
    x = torch.from_numpy(_rand((8, 256), "complex64", 8))
    inj = [[0, 5, 3, 7 if shards == 1 else 3, 1, 60.0, -25.0]]
    res = ft_on_shards(x, shards, groups=4, inject=inj)
    score = float(res.group_score.max())
    assert bool(res.flagged[2])
    at = ft_on_shards(x, shards, groups=4, inject=inj, threshold=score)
    assert not bool(at.flagged.any())
    under = ft_on_shards(x, shards, groups=4, inject=inj,
                         threshold=score * 0.99)
    assert bool(under.flagged[2])


def test_seu_outside_this_shard_adds_nothing():
    """An inject row whose fft rank, signal or position lies off the mesh
    changes nothing: the result is bitwise the clean one."""
    x = torch.from_numpy(_rand((8, FT_N), "complex64", 9))
    clean = ft_on_shards(x, 4, groups=4)
    for row in ([7, 1, 3, 1, 1, 60.0, 0.0],      # no such rank
                [0, 99, 3, 1, 1, 60.0, 0.0],     # no such signal
                [0, 1, 999, 1, 1, 60.0, 0.0],    # no such point
                [0, 1, 3, 1, 0, 60.0, 0.0]):     # not enabled
        res = ft_on_shards(x, 4, groups=4, inject=[row])
        assert torch.equal(res.y, clean.y), row
        assert not bool(res.flagged.any()), row
