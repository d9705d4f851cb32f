"""D shards of the sharded 1-D FFT in one process, for the tests.

Each shard is a thread that runs the mesh pipelines of
``repro_torch.core.fft.distributed`` (``_dist_fft``, ``_dist_ifft_t``) on
the global input as a plain tensor, as a rank of a mesh does; their
exchange (:class:`PermuteExchange`) copies the shards' tensors into each
other in place of ``dist.all_to_all_single`` and
``dist.all_gather_into_tensor``. So the loops under test are the ones a
mesh runs, on the tensors' own device: plain versions on the CPU, the
kernels on the card. ``tail`` splits the N2 tail into other local passes
than ``make_plan``'s, which reaches the two-pass tail at small sizes.

Imported by ``test_torch_distributed_fft.py`` and the card tests of
``test_torch_gpu.py``; it imports neither JAX nor ``repro``.
"""
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
    """The all-to-all and all-gather of ``shards`` threads. Every thread
    makes the same calls in the same order; call k of a thread posts its
    buffer, and waiting on it meets the other threads twice: once all have
    posted call k, each copies its slices, and once all have copied, a
    buffer may change again."""

    def __init__(self, shards: int):
        self.shards = shards
        self.barrier = threading.Barrier(shards, timeout=300)
        self.posted = {}

    def member(self, rank: int):
        """(all_to_all, all_gather) of the thread of shard ``rank``."""
        calls = itertools.count()
        d = self.shards

        def all_to_all(recv, send, async_op=False):
            k = next(calls)
            self.posted[k, rank] = send

            def finish():
                self.barrier.wait()
                for e in range(d):
                    recv.view(d, -1)[e].copy_(
                        self.posted[k, e].view(d, -1)[rank])
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

        return all_to_all, all_gather


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


def run_shards(fn, shards: int):
    """``fn(rank, all_to_all, all_gather)`` on ``shards`` threads, one a
    shard; their results in rank order (the first error raised)."""
    ex = PermuteExchange(shards)
    results, errors = [None] * shards, []

    def body(rank):
        try:
            results[rank] = fn(rank, *ex.member(rank))
        except BaseException as e:        # noqa: BLE001 - re-raised below
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


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

    def one(rank, all_to_all, all_gather):
        m = sd._Mesh(None, sd.FFT_AXIS, None, shards, 1, rank, 0,
                     all_to_all, all_gather)
        if inverse and not natural_order:
            return sd._dist_ifft_t(x, p, m, chunks=chunks)[0]
        return sd._dist_fft(x, p, m, inverse=inverse,
                            natural_order=natural_order, chunks=chunks)[0]

    outs = run_shards(one, shards)
    if natural_order:
        assert all(torch.equal(o, outs[0]) for o in outs[1:])
        return outs[0]
    return torch.cat(outs, dim=0 if inverse else 1)
