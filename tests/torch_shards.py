"""Shards of the sharded FFTs in one process, for the tests.

Each shard is a thread that runs the mesh pipelines of
``repro_torch.core.fft.distributed`` (``_dist_fft``, ``_dist_ifft_t``,
the ABFT's ``_ft_dist_fft``) and of ``repro_torch.core.fft.multidim``
(the slab, pencil, real slab, 2-D ABFT and convolution ``*_local``
steps) on the global input as a plain tensor, as a rank of a mesh does;
their exchange (:class:`PermuteExchange`) copies the shards' tensors into
each other in place of ``dist.all_to_all_single`` (uneven splits
included) and ``dist.all_gather_into_tensor``, and sums them in place of
``dist.all_reduce``. :func:`run_shards` runs a ``data x fft`` grid of
threads, one exchange a row and one a column, as a 2-D mesh's groups.
So the loops under test are the ones a mesh runs, on the tensors' own
device: plain versions on the CPU, the kernels on the card. ``tail``
splits the N2 tail into other local passes than ``make_plan``'s, which
reaches the two-pass tail at small sizes.

It also holds the grouped ABFT's scenario catalogue (``FT_SCENARIOS``,
``expected_verdicts``), which the thread runs, the four-process spawn and
the card tests share. Imported by ``test_torch_distributed_fft.py``,
``test_torch_distributed_abft.py`` and the card tests of
``test_torch_gpu.py``; it imports neither JAX nor ``repro``.
"""
import dataclasses
import itertools
import threading

import torch

from repro_torch.core.fft import distributed as sd
from repro_torch.core.fft.plan import block_radices, plan_from_reference
from repro_torch.kernels.ops import axis_fft
from repro_torch.kernels.stockham import device_key


class _Handle:
    def __init__(self, finish):
        self._finish = finish

    def wait(self):
        self._finish()


class PermuteExchange:
    """The all-to-all, all-gather and all-reduce of ``shards`` threads.
    Every thread
    makes the same calls in the same order; call k of a thread posts its
    buffer, and waiting on it meets the other threads twice: once all have
    posted call k, each copies its slices, and once all have copied, a
    buffer may change again."""

    def __init__(self, shards: int):
        self.shards = shards
        self.barrier = threading.Barrier(shards, timeout=300)
        self.posted = {}

    def member(self, rank: int):
        """(all_to_all, all_gather, all_reduce) of the thread of shard
        ``rank``."""
        calls = itertools.count()
        d = self.shards

        def all_to_all(recv, send, async_op=False, out_splits=None,
                       in_splits=None):
            k = next(calls)
            self.posted[k, rank] = (send, in_splits)

            def finish():
                self.barrier.wait()
                if in_splits is None and out_splits is None:
                    for e in range(d):
                        recv.view(d, -1)[e].copy_(
                            self.posted[k, e][0].view(d, -1)[rank])
                else:
                    at = 0
                    for e in range(d):
                        src, sp = self.posted[k, e]
                        lo = sum(sp[:rank])
                        n = out_splits[e]
                        assert sp[rank] == n, (sp, out_splits)
                        recv.view(-1)[at:at + n].copy_(
                            src.reshape(-1)[lo:lo + n])
                        at += n
                self.barrier.wait()

            handle = _Handle(finish)
            if async_op:
                return handle
            handle.wait()
            return None

        def all_gather(out, inp):
            k = next(calls)
            self.posted[k, rank] = inp
            self.barrier.wait()
            for e in range(d):
                out.view(d, -1)[e].copy_(self.posted[k, e].view(-1))
            self.barrier.wait()

        def all_reduce(t):
            k = next(calls)
            self.posted[k, rank] = t.clone()
            self.barrier.wait()
            t.copy_(sum(self.posted[k, e] for e in range(d)))
            self.barrier.wait()

        return all_to_all, all_gather, all_reduce


def pencil(n: int, shards: int, dtype: torch.dtype, device,
           tail: tuple[int, ...] | None = None) -> sd.Pencil:
    """A :class:`~repro_torch.core.fft.distributed.Pencil`, its N2 tail
    split into the passes ``tail`` when given."""
    key = device_key(device)
    p = sd.Pencil(n, shards, dtype, key)
    if tail is not None:
        p.ax2 = axis_fft(p.n2, dtype, key, plan=plan_from_reference(
            p.n2, tail, [block_radices(f) for f in tail], 1))
    return p


def run_shards(fn, shards: int, data: int = 1):
    """``fn(rank, mesh)`` on a ``data x shards`` grid of threads, one a
    shard, ``mesh`` the shard's ``_Mesh`` over its row's exchange (the
    ``fft`` group) and its column's (the ``data`` group), as a
    ``("data", "fft")`` mesh numbers its ranks: rank = md * shards + d.
    Their results in rank order (the first error raised)."""
    rows = [PermuteExchange(shards) for _ in range(data)]
    cols = [PermuteExchange(data) for _ in range(shards)]
    results, errors = [None] * (shards * data), []

    def body(rank):
        md, d = divmod(rank, shards)
        try:
            a2a, gather, reduce_ = rows[md].member(d)
            da2a, dgather, _ = cols[d].member(md)
            m = sd._Mesh(None, sd.FFT_AXIS, sd.DATA_AXIS if data > 1
                         else None, shards, data, d, md, a2a, gather,
                         reduce_, dgather if data > 1 else None,
                         da2a if data > 1 else None)
            results[rank] = fn(rank, m)
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errors.append(e)
            for ex in rows + cols:
                ex.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(shards * data)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def assemble(outs, shards: int, data: int = 1) -> torch.Tensor:
    """The global tensor of the ranks' ``(local, spec, shape)`` results
    (rank order as :func:`run_shards`): each local block written where
    its spec puts it — ``Shard(dim)`` over ``fft`` (``data``) the rank's
    ``torch.chunk`` block of ``dim`` by its fft (data) coordinate — and
    every copy of a replicated block checked equal to the first."""
    local0, _, shape = outs[0]
    full = torch.zeros(shape, dtype=local0.dtype, device=local0.device)
    seen = torch.zeros(shape, dtype=torch.bool)
    for rank, (local, spec, shp) in enumerate(outs):
        assert tuple(shp) == tuple(shape), (shp, shape)
        md, d = divmod(rank, shards)
        idx = [slice(None)] * len(shape)
        for name, pl in spec.items():
            coord, count = (d, shards) if name == sd.FFT_AXIS else (md, data)
            per = -(-shape[pl.dim] // count)
            lo = min(coord * per, shape[pl.dim])
            idx[pl.dim] = slice(lo, min(lo + per, shape[pl.dim]))
        idx = tuple(idx)
        if seen[idx].any():
            assert torch.equal(full[idx], local), f"rank {rank} disagrees"
        full[idx] = local
        seen[idx] = True
    assert bool(seen.all()), "a block of the result is missing"
    return full


def grid_on_shards(fn, shards: int, data: int = 1) -> torch.Tensor:
    """The global result of ``fn(rank, mesh)`` -> ``(local, spec, shape)``
    on a ``data x shards`` grid of threads (:func:`assemble`)."""
    return assemble(run_shards(fn, shards, data), shards, data)


def fft_on_shards(x: torch.Tensor, shards: int, *, inverse: bool = False,
                  natural_order: bool = True, chunks: int = 1,
                  tail: tuple[int, ...] | None = None,
                  p: sd.Pencil | None = None) -> torch.Tensor:
    """The global result of the sharded transform of ``x`` (B, N) over
    ``shards`` in-process shards: natural order (every shard's copy must
    be the same), the transposed order (``natural_order=False``: shard d's
    block of columns) or, for ``inverse=True, natural_order=False``, the
    TRANSPOSED_IN inverse of a transposed-order ``x`` (shard d's rows)."""
    b, n = x.shape
    if p is None:
        p = pencil(n, shards, x.dtype, x.device, tail)

    def one(rank, m):
        if inverse and not natural_order:
            return sd._dist_ifft_t(x, p, m, chunks=chunks)[0]
        return sd._dist_fft(x, p, m, inverse=inverse,
                            natural_order=natural_order, chunks=chunks)[0]

    outs = run_shards(one, shards)
    if natural_order:
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        return outs[0]
    return torch.cat(outs, dim=0 if inverse else 1)


def ft_on_shards(x: torch.Tensor, shards: int, *, groups: int,
                 threshold: float = 1e-4, correct: bool = True,
                 natural_order: bool = True, chunks: int = 1, inject=None,
                 recompute: bool = False,
                 tail: tuple[int, ...] | None = None,
                 p: sd.Pencil | None = None):
    """The sharded ABFT of ``x`` (B, N) over ``shards`` in-process shards:
    the :class:`~repro_torch.core.fft.distributed.DistFFTResult` of shard
    0 (every shard's telemetry must be the same) with ``y`` the global
    result, in natural or transposed order."""
    b, n = x.shape
    if p is None:
        p = pencil(n, shards, x.dtype, x.device, tail)
    inj = sd._inject_rows(inject, x.dtype, x.device)

    def one(rank, m):
        return sd._ft_dist_fft(x, p, m, groups=groups, threshold=threshold,
                               correct=correct, natural_order=natural_order,
                               chunks=chunks, inject=inj,
                               recompute=recompute)[0]

    outs = run_shards(one, shards)
    for o in outs[1:]:
        for f in ("shard_delta", "group_score", "flagged", "location",
                  "correctable", "checksum_fault", "corrected",
                  "recomputed"):
            assert torch.equal(getattr(o, f), getattr(outs[0], f)), f
    if natural_order:
        assert all(torch.equal(o.y, outs[0].y) for o in outs[1:])
        y = outs[0].y
    else:
        y = torch.cat([o.y for o in outs], dim=1)
    return dataclasses.replace(outs[0], y=y)


# The grouped ABFT's scenario catalogue (tests/test_abft_groups.py:113-182,
# with the chunked matrix of tests/test_fft_overlap.py:219-262): b = 8
# signals of 2^12 points in G = 4 groups of 2; each inject row's eps in
# units of ``mag``. ``ref``: the reference runs the case too (on its 1-D
# mesh of 4).
FT_N, FT_GROUPS = 1 << 12, 4
INJ4 = [[0, 1, 3, 1, 1, 1.0, 0.25], [1, 2, 5, 2, 1, -0.5, 1.0],
        [1, 5, 7, 3, 1, 1.0, -1 / 3], [0, 6, 2, 0, 1, 0.5, 0.5]]
INJ2 = [[0, 4, 3, 1, 1, 1.0, 0.25], [1, 5, 5, 2, 1, -0.5, 1.0]]
_FT_BASE = [
    ("clean", None, {}, True),
    ("four", INJ4, {}, True),
    ("four_t", INJ4, {"natural_order": False}, True),
    ("clean_t", None, {"natural_order": False}, False),
    ("nocorrect", INJ4, {"correct": False}, True),
    ("double", INJ2, {}, True),
    ("recompute", INJ2, {"recompute_uncorrectable": True}, True),
    ("recompute_t", INJ2, {"recompute_uncorrectable": True,
                           "natural_order": False}, False),
    ("cs2", [[1, 9, 4, 2, 1, 1.0, -1.0]], {}, True),
    ("cs3", [[1, 14, 4, 2, 1, 1.0, -1.0]], {}, True),
    ("last", [[1, 6, 5, 2, 1, -0.5, 1.0]], {}, False)]
CHUNKED = ("clean", "four", "four_t", "double", "cs2", "last")
FT_SCENARIOS = {
    "threshold": {"complex64": 1e-4, "complex128": 1e-10},
    "mag": {"complex64": 60.0, "complex128": 1e-6},
    "cases": [dict(name=nm, inject=inj, kw=kw, ref=ref)
              for nm, inj, kw, ref in _FT_BASE]
    + [dict(name=f"{nm}_c{c}", inject=inj, kw=dict(kw, chunks=c), ref=False)
       for nm, inj, kw, _ in _FT_BASE if nm in CHUNKED for c in (2, 4)]}


def inject_rows(inject, mag: float, shards: int = 0):
    """A catalogue case's inject rows with eps times ``mag`` (and, given
    ``shards``, its fft rank taken mod ``shards``, so that every SEU lands
    on a mesh of fewer ranks)."""
    if inject is None:
        return None
    return [[r[0] % shards if shards else r[0]] + r[1:5]
            + [r[5] * mag, r[6] * mag] for r in inject]


def expected_verdicts(name: str, tele: dict, y, ref, tol: float) -> None:
    """Assert the catalogue's verdicts of case ``name`` on its telemetry
    (lists) and its natural-order output ``y`` against the FFT ``ref``:
    the error relative to max|ref| under ``tol`` where the data ends clean
    and over 50 * ``tol`` where it does not."""
    import numpy as np

    base = name.split("_c")[0] if "_c" in name else name
    base = base[:-2] if base.endswith("_t") else base
    err = float(np.abs(np.asarray(y) - np.asarray(ref)).max()
                / np.abs(np.asarray(ref)).max())
    if base == "clean":
        assert not any(tele["flagged"]), tele["group_score"]
        assert err < tol, err
    elif base == "four":
        assert all(tele["flagged"]) and all(tele["correctable"])
        assert tele["location"] == [1, 2, 5, 6], tele["location"]
        assert tele["corrected"] == 4 and err < tol, err
    elif base == "nocorrect":
        assert all(tele["flagged"]) and tele["corrected"] == 0
        assert err > 50 * tol, err
    elif base == "double":
        assert tele["uncorrectable"] == [False, False, True, False]
        assert not any(tele["correctable"])
        assert tele["corrected"] == 0 and err > 50 * tol, err
    elif base == "recompute":
        assert tele["recomputed"] == 1 and err < tol, err
    elif base in ("cs2", "cs3"):
        want = [False, True, False, False] if base == "cs2" \
            else [False, False, True, False]
        assert tele["checksum_fault"] == want, tele["checksum_fault"]
        assert tele["flagged"] == want
        assert not any(tele["correctable"]) and err < tol, err
    elif base == "last":
        assert tele["flagged"] == [False, False, False, True]
        assert tele["location"][3] == 6 and err < tol, err
    else:
        raise AssertionError(f"no verdicts for {name!r}")


def telemetry(res) -> dict:
    """A result's telemetry as lists, ``uncorrectable`` included."""
    out = {f: getattr(res, f).tolist() for f in (
        "shard_delta", "group_score", "flagged", "location", "correctable",
        "checksum_fault", "corrected", "recomputed")}
    out["uncorrectable"] = res.uncorrectable.tolist()
    return out


# The 2-D grouped ABFT's scenario catalogue (tests/test_fft_multidim.py:270-
# 350): b, R, C, G = 8, 32, 64, 4; eps in units of ``mag``; rows [fft
# device, signal, local_r, col, enable, eps_re, eps_im]. The real ABFT runs
# the same rows on its padded half spectrum (col < C/2 + D).
FT2_SHAPE, FT2_GROUPS = (8, 32, 64), 4
FT2_SCENARIOS = {
    "threshold": FT_SCENARIOS["threshold"], "mag": FT_SCENARIOS["mag"],
    "cases": [dict(name="clean", inject=None, kw={}),
              dict(name="four", inject=INJ4, kw={}),
              dict(name="nocorrect", inject=INJ4, kw={"correct": False}),
              dict(name="double", inject=INJ2, kw={}),
              dict(name="recompute", inject=INJ2,
                   kw={"recompute_uncorrectable": True}),
              dict(name="cs2", inject=[[1, 9, 4, 2, 1, 1.0, -1.0]], kw={}),
              dict(name="cs3", inject=[[1, 14, 4, 2, 1, 1.0, -1.0]],
                   kw={})]}
VERDICTS = ("flagged", "location", "correctable", "checksum_fault",
            "corrected", "recomputed", "uncorrectable")


def ft2_on_shards(x: torch.Tensor, shards: int, data: int = 1, *,
                  groups: int, threshold: float, real: bool,
                  correct: bool = True, inject=None, recompute: bool = False):
    """The 2-D sharded ABFT (``multidim.ft_slab2_local``) of ``x`` (B, R,
    C) on a ``data x shards`` grid of threads: shard 0's
    :class:`~repro_torch.core.fft.distributed.DistFFTResult` (every
    shard's telemetry must be the same) with ``y`` the global result."""
    from repro_torch.core.fft import multidim

    b, rr, cc = x.shape
    cdt = x.dtype if x.is_complex() else (
        torch.complex128 if x.dtype == torch.float64 else torch.complex64)
    key = device_key(x.device)
    axes = (axis_fft(rr, cdt, key), axis_fft(cc // 2 if real else cc, cdt,
                                             key))
    inj = sd._inject_rows(inject, cdt, x.device)
    outs = run_shards(lambda r, m: multidim.ft_slab2_local(
        x, axes, m, groups=groups, threshold=threshold, correct=correct,
        inject=inj, recompute=recompute, real=real), shards, data)
    res0 = outs[0][0]
    for res, _, _ in outs[1:]:
        for f in VERDICTS + ("shard_delta", "group_score"):
            assert torch.equal(getattr(res, f), getattr(res0, f)), f
    y = assemble([(res.y, spec, shape) for res, spec, shape in outs],
                 shards, data)
    return dataclasses.replace(res0, y=y)
