"""Serving over a mesh: the leader's command channel to the other ranks of a
``torch.distributed`` mesh, and the assembly of a sharded result on the
leader.

The reference drives every device from one process. In
``torch.distributed`` every rank is a process, and every rank must issue
the same collectives in the same order, so the runtime over a mesh
(:class:`~repro_torch.serve.runtime.ServeRuntime` with ``mesh=``) has a
leader and followers. The leader is the mesh's first rank (coordinate 0
on every dimension); it alone admits requests, batches them and holds
their handles. It sends every command to all ranks of the mesh before
anyone acts on it, and each follower replays the commands in order:

* ``ADMIT`` a bucket: every rank builds the bucket's plan and warms it up
  together (the warm-up runs the plan's collectives);
* ``RUN`` a batch: the bucket, the batch's fill, its SEU rows, then the
  padded batch itself;
* ``STOP``.

The runtime uses two groups of the mesh's ranks (:class:`Channel`). The
commands and the flags travel on a gloo group on the CPU, the control
group; the batch payload and the result travel on the data group, a group
with the process group's own backend, so under NCCL they stay on the
device and the same code serves a gloo world as well. Each rank runs the
commands on one thread, in order (the reference's mesh lock, made
structural).

The batch payload is BROADCAST: the leader pads the batch into its host
buffer of the bucket, copies it to its device once (a card request is
copied there on the device) and broadcasts the whole ``(max_batch,
*tshape)`` batch on the data group. A sharded plan takes it as a plain
tensor whose rows and columns each rank reads in place
(``core.fft.distributed._local_input``), so no collective beyond the
plan's modelled ones runs inside the plan. A batch of a bucket moves:

* control (control group): one 96-byte command header (12 int64) and,
  with ``F`` SEUs, one ``F x 7`` float64 row block (``56 F`` bytes);
* payload (data group): ``max_batch * prod(tshape) * itemsize`` bytes
  broadcast from the leader (the payload dtype: complex for C2C buckets,
  real for ``real`` ones), 128 MiB for a c64 2^20 bucket of 16;
* flags (control group): two ``all_reduce`` s of one int64 (8 bytes
  each): after each rank has its batch buffer and after the plan, so a
  batch that fails on one rank fails on every rank, and no rank enters a
  collective that another skipped;
* result (data group): the blocks of the plan's ``DTensor`` result that
  the leader does not hold, each sent point to point by the first rank
  that holds it (:meth:`Channel.assemble`): nothing in natural order on a
  mesh of one ``fft`` dimension (the result is replicated there), the
  other data shards' rows on a ``data x fft`` mesh, the other ranks' ``1 -
  1/D`` of a result sharded over ``fft`` (the spectrum's transposed order,
  the 2-D slab). Gloo's point to point takes host tensors, so over a gloo
  data group the blocks are staged through the host; over NCCL they stay
  on the device.

An admission moves one header and two flags; STOP one header and one
flag, after which every rank destroys both groups. :attr:`Channel.traffic`
counts every kind (calls and bytes). The control group's timeout is the
data groups' longest plus a minute, so a rank stuck in a collective of
the data groups times out first and its flag still reaches the others.
"""
from __future__ import annotations

import datetime
import itertools

import torch
import torch.distributed as dist

__all__ = ["Channel", "ADMIT", "RUN", "STOP", "HEADER", "block_slices"]

ADMIT, RUN, STOP = 1, 2, 3
HEADER = 12                      # int64 fields of a command
TRAFFIC = ("control", "payload", "flag", "result")
# the control group outlives a hang of the data group: a rank stuck in a
# plan's collective times out first, and its flag still reaches the others
_SLACK = datetime.timedelta(seconds=60)


def block_slices(shape, mesh, placements) -> list:
    """``[(global rank, slices)]``: each rank of ``mesh`` that holds a
    distinct block of a ``DTensor`` of global ``shape`` in ``placements``
    (its coordinate is 0 on every replicated dimension), with the block's
    slices of the global value (``torch.chunk`` 's split on each sharded
    dimension, in mesh-dimension order). Empty blocks are left out."""
    dims = tuple(mesh.mesh.shape)
    out = []
    for coord in itertools.product(*(range(s) for s in dims)):
        if any(c and not pl.is_shard() for c, pl in zip(coord, placements)):
            continue
        span = [[0, int(n)] for n in shape]
        for c, s, pl in zip(coord, dims, placements):
            if pl.is_shard():
                d = pl.dim % len(shape)
                start, length = span[d]
                chunk = -(-length // s)
                lo = min(length, c * chunk)
                span[d] = [start + lo, min(chunk, length - lo)]
        if all(n > 0 for _, n in span):
            out.append((int(mesh.mesh[coord]),
                        tuple(slice(a, a + n) for a, n in span)))
    return out


def _timeout(group, device) -> datetime.timedelta:
    """A process group's collective timeout on ``device``."""
    try:
        return group._get_backend(device).options._timeout
    except (AttributeError, RuntimeError):
        return dist.default_pg_timeout


class Channel:
    """The channel of one mesh: a gloo control group of its ranks on the
    CPU and a data group of them with the process group's backend. Every
    rank of the process group must build it (``new_group`` is collective
    over the world); a rank off the mesh gets one that is not a
    :attr:`member`. :attr:`traffic` counts ``[calls, bytes]`` of each kind
    this rank moved (sent or received). :meth:`close` destroys both
    groups."""

    def __init__(self, mesh):
        self.ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        self.device = torch.device(mesh.device_type)
        self.rank = dist.get_rank()
        self.leader = self.ranks[0]
        self.member = self.rank in self.ranks
        data_timeout = max(_timeout(mesh.get_group(d), self.device)
                           for d in range(mesh.ndim)) if self.member \
            else dist.default_pg_timeout
        self.group = dist.new_group(ranks=self.ranks, backend="gloo",
                                    timeout=data_timeout + _SLACK)
        self.data = dist.new_group(ranks=self.ranks, timeout=data_timeout)
        # where the result's blocks travel: gloo's point to point takes
        # host tensors only
        self.p2p_device = torch.device("cpu") if not self.member or \
            dist.get_backend(self.data) == "gloo" else self.device
        self.traffic = {k: [0, 0] for k in TRAFFIC}
        self.closed = False

    @property
    def leads(self) -> bool:
        return self.rank == self.leader

    def _count(self, kind: str, nbytes: int) -> None:
        self.traffic[kind][0] += 1
        self.traffic[kind][1] += int(nbytes)

    def broadcast(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """The leader's ``t`` into every rank's ``t``: the payload on the
        data group, anything else (a CPU tensor) on the control group."""
        group = self.data if kind == "payload" else self.group
        dist.broadcast(t, src=self.leader, group=group)
        self._count(kind, t.numel() * t.element_size())
        return t

    def command(self, header=None) -> list[int]:
        """Send (on the leader: ``header``, up to :data:`HEADER` ints) or
        receive (elsewhere) one command header."""
        t = torch.zeros(HEADER, dtype=torch.int64)
        if self.leads:
            t[:len(header)] = torch.tensor(header, dtype=torch.int64)
        return self.broadcast(t, "control").tolist()

    def failed_rank(self, failed: bool) -> int:
        """Every rank's verdict on one step: the highest rank that failed
        it, or -1 when none did (one ``all_reduce`` of one int64)."""
        t = torch.tensor([self.rank + 1 if failed else 0], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        self._count("flag", t.element_size())
        return int(t) - 1

    def assemble(self, y):
        """The global value of a sharded result ``y`` (a ``DTensor``) on
        the leader: each block the leader does not hold comes from the
        first rank that holds it, point to point on the data group (on
        :attr:`p2p_device`, where the value is assembled). Returns the
        tensor on the leader, None elsewhere. A plain tensor is already
        the global value on every rank."""
        from torch.distributed.tensor import DTensor

        if not isinstance(y, DTensor):
            return y if self.leads else None
        local = y.to_local()
        dev = self.p2p_device
        blocks = block_slices(tuple(y.shape), y.device_mesh, y.placements)
        if not self.leads:
            if any(r == self.rank for r, _ in blocks):
                buf = local.contiguous().to(dev)
                dist.send(buf, dst=self.leader, group=self.data)
                self._count("result", buf.numel() * buf.element_size())
            return None
        full = torch.empty(tuple(y.shape), dtype=local.dtype, device=dev)
        for r, sl in blocks:
            if r == self.leader:
                full[sl] = local
                continue
            buf = torch.empty(tuple(s.stop - s.start for s in sl),
                              dtype=local.dtype, device=dev)
            dist.recv(buf, src=r, group=self.data)
            self._count("result", buf.numel() * buf.element_size())
            full[sl] = buf
        return full

    def close(self) -> None:
        """Destroy both groups (on this rank: no collective)."""
        if self.member and not self.closed:
            dist.destroy_process_group(self.group)
            dist.destroy_process_group(self.data)
        self.closed = True
