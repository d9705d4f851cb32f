"""Multi-tenant FFT serving runtime: bucketed admission, deadline batching,
and a worker pool over the cached plan executors, on one device or over a
mesh.

Architecture (the layer ``launch.serve --mode serve`` is a thin CLI over)::

    client threads          scheduler                worker pool
    ─────────────          ──────────               ───────────
    submit(x, op=..) ──> SpecBucketer.key_for
                         admission: one FFTPlan per bucket (warmup once)
                         DeadlineBatcher.submit ──> per-bucket pending
                               │ close on max_batch or deadline_ms
                               ▼
                         ready batches ──────────> N worker threads, each
                                                   on its own CUDA stream:
                                                   pad + stack payloads,
                                                   serve_plan(plan, xb),
                                                   wait for the stream,
                                                   scatter rows to handles,
                                                   telemetry per bucket

Requests are SINGLE signals (``(n,)`` or ``(r, c)``): a numpy array, a CPU
tensor or a tensor on the runtime's card. The runtime pads each to its
bucket's canonical transform shape (zero extension — the
``np.fft.fft(x, n)`` contract, see ``bucketing``) and zero-fills empty
batch slots. On the card a batch is assembled on the device: the host
requests through the worker's pinned staging buffer of the bucket, in one
host-to-device copy; a card request by a copy on the device. Its result
goes back where it came from: a card request gets its own copy of its
row of the batch's output on the card (a view would keep the whole batch
there), a host request a copy of its row of one device-to-host copy of the
batch into the worker's pinned output buffer (a numpy array for a numpy
request). A request is done when
the device is: the worker waits for its stream before it publishes any
result, so latencies measure service time, not launch time. One plan per
bucket is built and warmed at admission, which also pins each worker's
host buffers for the bucket and then waits for the device, so the steady
state never builds tables or pins memory and every worker's stream sees
the tables uploaded.

``ft=True`` buckets run the fused-kernel ABFT pipeline online: per-request
SEU descriptors (tests / fault-injection campaigns) ride
:class:`~repro_torch.serve.scheduler.ServeRequest.inject` with signal
indices relative to the request, and the runtime offsets them to batch
rows; the per-bucket verdict telemetry (injected/detected/corrected)
aggregates over every batch the bucket executed.

Over a mesh whose ``fft`` dimension has more than one rank (``mesh=`` a
``DeviceMesh`` from ``launch.mesh.make_fft_mesh``; with one ``fft`` rank
the runtime is the local one above) every rank of the process group
builds the runtime with the same config and mesh, and the mesh's first
rank leads (``serve.mesh``)::

    leader (rank 0)                              followers
    ───────────────                              ─────────
    submit -> key_for, plan (geometry errors)
           -> ADMIT ──── every rank: plan + warm-up together ────
    DeadlineBatcher -> one dispatch thread:
       pad the batch on the host
       RUN ─────────── header, SEU rows ───────────> follow loop
       the batch on the device; flag                 a batch buffer; flag
       payload ─────────── data group ─────────────> broadcast
       serve_plan on the global batch  <── collectives ──> serve_plan
       flag; assemble the result  <────── blocks ─────── send blocks
       complete handles, telemetry
    close -> STOP, flag ───────────────────────────> loop ends

Sharded batches run on one thread a rank, on its default CUDA stream,
the plan's launches and its collectives alike. A sharded ft bucket takes
any number of SEUs a batch (the grouped ABFT's 7-field rows); its
telemetry is the grouped verdict (``serve_plan``'s ``flagged`` a count of
groups). A card request's result is a copy on the card, kept from reuse
until its client's stream is done with it, as on one device. ``submit``
on a follower raises; a follower's ``close`` (or
:meth:`ServeRuntime.follow`) waits for the leader's STOP and raises what
ended its loop early. Each rank destroys the channel's groups when its
dispatch or follow thread ends.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading

import numpy as np
import torch

from repro_torch.core.plan import FTConfig, plan_cache_info, resolve_device
from repro_torch.serve import mesh as meshrun
from repro_torch.serve.bucketing import BucketKey, SpecBucketer
from repro_torch.serve.scheduler import (Batch, DeadlineBatcher,
                                         QueueFullError, RequestHandle,
                                         RuntimeClosedError, ServeRequest)
from repro_torch.serve.specs import serve_plan
from repro_torch.serve.telemetry import Telemetry

__all__ = ["RuntimeConfig", "ServeRuntime", "Fault"]


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected SEU, addressed relative to the carrying request:
    perturb the request's signal at transform coordinate (``row``,
    ``col``) by ``eps_re + i*eps_im`` inside the protected region. The
    runtime translates it to the executing pipeline's descriptor format
    (fused local kernel or sharded grouped ABFT) and to the request's batch
    row."""

    col: int = 1
    row: int = 1
    eps_re: float = 200.0
    eps_im: float = 0.0


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Scheduler + pool policy for one :class:`ServeRuntime`.

    ``max_batch`` is both the coalescing limit and every bucket plan's
    batch dimension; ``deadline_ms`` bounds how long a lone request waits
    for companions; ``queue_depth`` is the backpressure bound over ALL
    pending requests; ``timeout_ms`` (None = never) fails requests that
    age out unbatched. ``workers`` sizes the local pool (over a mesh each
    rank runs one dispatch thread). ``ft`` is the FTConfig attached to
    ``ft=True`` buckets at admission. ``device`` is where every bucket
    runs: the card (``"cuda"``, the kernels) unless the caller asks for
    ``"cpu"`` (the kernels' plain versions); without a card ``"cuda"``
    raises when the runtime is built."""

    max_batch: int = 8
    deadline_ms: float = 2.0
    queue_depth: int = 64
    workers: int = 2
    timeout_ms: float | None = None
    chunks: int = 1
    ft: FTConfig = FTConfig(threshold=1e-4, correct=True,
                            recompute_uncorrectable=True)
    device: str = "cuda"

    def __post_init__(self):
        if self.workers < 1:
            raise ValueError(f"workers must be >= 1, got {self.workers}")


@dataclasses.dataclass
class _Signal:
    """A request's payload as submitted. A card tensor carries ``ready``,
    an event on the client's stream after the work that made it, and that
    ``stream``, which will read the result."""

    data: object                          # np.ndarray or torch.Tensor
    ready: torch.cuda.Event | None = None
    stream: torch.cuda.Stream | None = None


@dataclasses.dataclass
class _Worker:
    """One worker thread's device state: its stream (on the card) and, per
    bucket, its pinned host buffers ``(staging, out)`` for a batch's input
    and output. Admission warms the stream and allocates the buffers;
    every batch reuses them."""

    stream: torch.cuda.Stream | None
    pinned: dict = dataclasses.field(default_factory=dict)


COMMAND_LOG = 1 << 16        # commands a rank over a mesh keeps in its log
_DTYPES = ("complex64", "complex128")
_OPS = ("fft", "spectrum")


class MeshBatchError(RuntimeError):
    """A batch (or admission) over a mesh that failed on some rank, raised
    on every rank."""


@dataclasses.dataclass
class _Admission:
    """A bucket the leader admits over a mesh: its plan (built on the
    leader), and the dispatch thread's outcome."""

    key: BucketKey
    plan: object
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    error: BaseException | None = None


def _key_fields(key: BucketKey) -> list[int]:
    """A bucket key as the ints of an ADMIT command."""
    t = tuple(key.tshape) + (0,)
    return [key.rank, t[0], t[1], _DTYPES.index(key.dtype),
            _OPS.index(key.op), int(key.real), int(key.ft)]


def _key_of(fields) -> BucketKey:
    rank, t0, t1, dt, op, real, ft = (int(v) for v in fields[:7])
    return BucketKey(tshape=(t0,) if rank == 1 else (t0, t1), rank=rank,
                     dtype=_DTYPES[dt], op=_OPS[op], real=bool(real),
                     ft=bool(ft))


def _block(shape) -> tuple[slice, ...]:
    return tuple(slice(0, int(s)) for s in shape)


def _pad_into(row, x) -> None:
    """Write ``x`` into the leading block of ``row`` and zero the rest
    (numpy arrays or tensors alike)."""
    row[_block(x.shape)] = x
    for d in range(x.ndim):
        row[_block(x.shape[:d]) + (slice(int(x.shape[d]), None),)] = 0


def _host_array(data) -> np.ndarray:
    return data.detach().numpy() if torch.is_tensor(data) else data


class ServeRuntime:
    """The serving runtime: ``submit`` returns a
    :class:`~repro_torch.serve.scheduler.RequestHandle`; ``close`` drains."""

    def __init__(self, config: RuntimeConfig | None = None, *, mesh=None):
        self.config = config or RuntimeConfig()
        cfg = self.config
        self.device = resolve_device(cfg.device, "RuntimeConfig")
        self.mesh = mesh
        self.bucketer = SpecBucketer(mesh=mesh, max_batch=cfg.max_batch,
                                     chunks=cfg.chunks,
                                     device=str(self.device))
        self.telemetry = Telemetry()
        self.batcher = DeadlineBatcher(
            max_batch=cfg.max_batch, deadline_ms=cfg.deadline_ms,
            queue_depth=cfg.queue_depth, timeout_ms=cfg.timeout_ms,
            on_timeout=self.telemetry.record_timeout)
        self._plans: dict[BucketKey, object] = {}
        self._admission = threading.Lock()
        self._closed = False
        self.channel = None
        if self.bucketer.shards > 1:
            self._start_mesh(mesh)
            return
        self._worker_state = [_Worker(torch.cuda.Stream(self.device)
                               if self._on_card else None)
                       for _ in range(cfg.workers)]
        self._workers = [
            threading.Thread(target=self._worker_loop, args=(w,),
                             name=f"serve-worker-{i}", daemon=True)
            for i, w in enumerate(self._worker_state)]
        for t in self._workers:
            t.start()

    @property
    def _on_card(self) -> bool:
        return self.device.type == "cuda"

    # -- admission ---------------------------------------------------------

    def admit(self, key: BucketKey):
        """Resolve (once) the bucket's plan: build the padded batched
        FFTSpec, plan it through the shared cache and warm the executor
        with a zero batch; on the card, run the warm-up again on every
        worker's stream (so its memory pool holds the batch's buffers),
        give every worker its pinned host buffers for the bucket, and wait
        for the device. No worker then builds tables, allocates device
        memory for a batch's shape or pins memory, and every worker's
        stream sees the tables uploaded. Raises with the spec's validation
        error when the bucket is infeasible — admission is where bad
        geometry surfaces. Over a mesh the leader builds the plan (bad
        geometry raises here), then every rank builds and warms it on the
        leader's ADMIT, and this returns when all have."""
        p = self._plans.get(key)
        if p is not None:
            return p
        if self.channel is not None:
            return self._admit_on_mesh(key)
        with self._admission:
            p = self._plans.get(key)
            if p is not None:
                return p
            from repro_torch.core.fft import api
            spec = self.bucketer.spec_for(
                key, ft_config=self.config.ft if key.ft else None)
            p = api.plan(spec)
            xb = torch.zeros((self.config.max_batch,) + key.tshape,
                             dtype=self._payload_dtype(p),
                             device=self.device)
            y, _ = serve_plan(p, xb, op=key.op)
            if self._on_card:
                torch.cuda.synchronize(self.device)
                for w in self._worker_state:
                    with torch.cuda.stream(w.stream):
                        serve_plan(p, torch.zeros_like(xb), op=key.op)
                    w.pinned[key] = tuple(
                        torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in (xb, y))
                torch.cuda.synchronize(self.device)
            self._plans[key] = p
            return p

    @staticmethod
    def _payload_dtype(plan) -> torch.dtype:
        return plan._rdtype if plan.spec.real else plan.spec.torch_dtype

    # -- client API --------------------------------------------------------

    def _signal(self, x) -> _Signal:
        if not torch.is_tensor(x):
            return _Signal(np.asarray(x))
        if x.device.type == "cpu":
            return _Signal(x)
        if x.device != self.device:
            raise ValueError(f"a {x.device} request to a runtime on "
                             f"{self.device}: send it from the host or "
                             f"from {self.device}")
        stream = torch.cuda.current_stream(x.device)
        ready = torch.cuda.Event()
        ready.record(stream)
        return _Signal(x, ready, stream)

    def submit(self, x, *, op: str = "fft", real: bool = False,
               ft: bool = False, faults=None,
               timeout_ms: float | None = None) -> RequestHandle:
        """Admit one single-signal request; returns its handle.

        ``x`` is a numpy array, a CPU tensor or a tensor on the runtime's
        card; the result comes back in the same kind. ``faults`` (ft
        buckets only): a :class:`Fault` or sequence of them to inject into
        THIS request's rows — the fault-injection campaign interface.
        """
        if self._closed:
            raise RuntimeClosedError("serve runtime is closed")
        self._check_leader("submit")
        sig = self._signal(x)
        key = self.bucketer.key_for(tuple(sig.data.shape), sig.data.dtype,
                                    op=op, real=real, ft=ft)
        if faults is not None and not ft:
            raise ValueError("faults= requires an ft=True bucket")
        faults = ((faults,) if isinstance(faults, Fault)
                  else tuple(faults or ()))
        self.admit(key)
        handle = RequestHandle()
        req = ServeRequest(key=key, x=sig, handle=handle, inject=faults,
                           timeout_ms=timeout_ms)
        self.telemetry.record_submit(key, injected=len(faults))
        try:
            self.batcher.submit(req)
        except (QueueFullError, RuntimeClosedError):
            self.telemetry.record_reject(key)
            raise
        return handle

    # -- worker pool -------------------------------------------------------

    def _worker_loop(self, w: _Worker):
        ctx = (torch.cuda.stream(w.stream) if w.stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                batch = self.batcher.next_batch()
                if batch is None:
                    return
                try:
                    self._execute(batch, w)
                except Exception as e:
                    for r in batch.requests:
                        if not r.handle.done():
                            r.handle.set_error(e)
                    self.telemetry.record_failed(batch.key,
                                                 len(batch.requests))

    def _execute(self, batch: Batch, w: _Worker):
        key, reqs, cfg = batch.key, batch.requests, self.config
        plan = self._plans[key]
        xb, host, idx, start = self._assemble(w, key, reqs,
                                              self._payload_dtype(plan))
        inject, bs = self._build_inject(batch)
        y, info = serve_plan(plan, xb, op=key.op, inject=inject, bs=bs)
        del xb
        card, out = self._copy_out(w, key, reqs, y, host, idx)
        if self._on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()          # a request is done when the device is
            info["device_ms"] = start.elapsed_time(end)
        results = self._results(reqs, card, out, host)
        fill = len(reqs)
        pad = sum(self.bucketer.pad_elems(key, r.x.data.shape) for r in reqs)
        pad += (cfg.max_batch - fill) * int(np.prod(key.tshape,
                                                    dtype=np.int64))
        self.telemetry.record_batch(
            key, fill=fill, slots=cfg.max_batch, pad_elems=pad,
            payload_elems=sum(int(np.prod(r.x.data.shape)) for r in reqs))
        if key.ft:
            self._record_ft(key, info)
        base = {"bucket": key.label, "nfft": key.tshape,
                "batch_fill": fill}
        for r, res in zip(reqs, results):
            r.handle.set_result(res, {**base, **info})
            self.telemetry.record_done(key, latency_s=r.handle.latency_s,
                                       queue_s=r.handle.queue_s)

    def _assemble(self, w: _Worker, key: BucketKey, reqs, dtype):
        """The zero-padded batch on the device, the batch rows of the host
        requests, (on the card, when those rows are not the batch's first
        ones) their index there, and (on the card) an event recorded on the
        worker's stream before the batch's first operation: the batch's
        ``device_ms`` runs from it to the last copy of its results."""
        dev = self.device
        host = [i for i, r in enumerate(reqs) if r.x.ready is None]
        idx = start = None
        if self._on_card:
            stage = w.pinned[key][0][:len(host)]
            rows = stage.numpy()
            for k, i in enumerate(host):
                _pad_into(rows[k], _host_array(reqs[i].x.data))
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        xb = torch.zeros((self.config.max_batch,) + key.tshape, dtype=dtype,
                         device=dev)
        if host and self._on_card:      # staged above, ONE copy to the card
            if host == list(range(len(host))):
                xb[:len(host)].copy_(stage, non_blocking=True)
            else:
                idx = torch.tensor(host).pin_memory().to(dev,
                                                          non_blocking=True)
                xb.index_copy_(0, idx, stage.to(dev, non_blocking=True))
        elif host:
            rows = xb.numpy()
            for i in host:
                _pad_into(rows[i], _host_array(reqs[i].x.data))
        for i, r in enumerate(reqs):   # after the client's work that made them
            if r.x.ready is not None:
                torch.cuda.current_stream(dev).wait_event(r.x.ready)
                xb[i][_block(r.x.data.shape)].copy_(r.x.data)
        return xb, host, idx, start

    def _copy_out(self, w: _Worker, key: BucketKey, reqs, y, host, idx):
        """Queue each result's way back: a card request gets its own copy
        of its row (a view would keep the whole batch on the card), read
        later on its client's stream; the host rows go to the worker's
        pinned ``out`` buffer in ONE device-to-host copy. Returns ``({row:
        card result}, host rows' source)``."""
        card = {i: y[i].clone() for i, r in enumerate(reqs)
                if r.x.ready is not None}
        for i, res in card.items():
            res.record_stream(reqs[i].x.stream)
        if not (host and self._on_card):
            return card, y
        out = w.pinned[key][1][:len(host)]
        out.copy_(y[:len(host)] if idx is None else y.index_select(0, idx),
                  non_blocking=True)
        return card, out

    def _results(self, reqs, card, out, host) -> list:
        """Each request's result, once the worker's stream is done: its card
        copy, or a copy of its host row (numpy for a numpy request), never
        a view of a buffer the worker reuses."""
        slot = {i: k for k, i in enumerate(host)} if self._on_card \
            else {i: i for i in host}
        results = []
        for i, r in enumerate(reqs):
            if i in card:
                results.append(card[i])
            elif isinstance(r.x.data, np.ndarray):
                results.append(out[slot[i]].numpy().copy())
            else:
                results.append(out[slot[i]].clone())
        return results

    def _build_inject(self, batch: Batch):
        """Translate per-request :class:`Fault` descriptors into the fused
        kernel's ONE (6,) descriptor ``[tile, row, col, enable, eps_re,
        eps_im]`` with the batch-row offset applied, on the runtime's
        device. Returns ``(inject, bs)``; ``bs`` pins the tile size to the
        whole batch so ``tile = row // bs`` is always 0."""
        key = batch.key
        if not key.ft:
            return None, None
        rows = [(i, f) for i, r in enumerate(batch.requests)
                for f in r.inject]
        if not rows:
            return None, None
        if len(rows) > 1:
            raise ValueError(
                "the local fused kernel injects at most one SEU per batch "
                "(single in-kernel descriptor) — space the campaign so "
                "batches carry one fault")
        brow, f = rows[0]
        n = key.tshape[0]
        inj = torch.tensor([0, brow, f.col % n, 1, f.eps_re, f.eps_im],
                           dtype=torch.float32)
        if self._on_card:
            inj = inj.pin_memory().to(self.device, non_blocking=True)
        return inj, self.config.max_batch

    def _record_ft(self, key, info: dict):
        detected = info.get("flagged", 0)
        self.telemetry.record_ft(
            key,
            detected=int(detected if not isinstance(detected, bool)
                         else detected),
            corrected=int(info.get("corrected", 0)),
            uncorrectable=int(info.get("uncorrectable", 0)),
            checksum_faults=int(info.get("checksum_faults", 0)),
            recomputed=int(info.get("recomputed", 0)))

    # -- serving over a mesh ----------------------------------------------

    def _start_mesh(self, mesh) -> None:
        """Build the command channel on this rank and start its thread:
        on the leader a pump from the batcher and the dispatch thread, on
        a follower the follow loop; a rank off the mesh starts nothing."""
        mesh_dev = getattr(mesh, "device_type", None)
        if mesh_dev is not None and mesh_dev != self.device.type:
            raise ValueError(f"the mesh's device type {mesh_dev!r} is not "
                             f"the runtime's device {self.device}")
        self.channel = meshrun.Channel(mesh)
        self._keys: list[BucketKey] = []        # the same on every rank
        self._key_ids: dict[BucketKey, int] = {}
        # each bucket's payload dtype; the leader's host buffer for it
        self._payloads: dict[BucketKey, torch.dtype] = {}
        self._buffers: dict[BucketKey, torch.Tensor] = {}
        # (command, bucket label, fill) in the order this rank ran them
        self.commands = collections.deque(maxlen=COMMAND_LOG)
        # batches and admissions every rank failed, as this rank saw them
        self.failures = collections.deque(maxlen=COMMAND_LOG)
        self._stop_error: BaseException | None = None
        self._workers = []
        if not self.channel.member:
            return
        if self.channel.leads:
            self._work: queue.Queue = queue.Queue()
            self._workers = [
                threading.Thread(target=self._pump, name="serve-pump",
                                 daemon=True),
                threading.Thread(target=self._lead, name="serve-dispatch",
                                 daemon=True)]
        else:
            self._workers = [threading.Thread(
                target=self._follow_loop, name="serve-follower",
                daemon=True)]
        for t in self._workers:
            t.start()

    def _check_leader(self, what: str) -> None:
        if self.channel is not None and not self.channel.leads:
            raise RuntimeError(
                f"{what} on rank {self.channel.rank}: only the mesh's leader "
                f"(rank {self.channel.leader}) admits requests; the other "
                f"ranks follow its commands")

    def _admit_on_mesh(self, key: BucketKey):
        self._check_leader("admit")
        with self._admission:
            p = self._plans.get(key)
            if p is not None:
                return p
            if self._closed:
                raise RuntimeClosedError("serve runtime is closed")
            from repro_torch.core.fft import api
            p = api.plan(self.bucketer.spec_for(
                key, ft_config=self.config.ft if key.ft else None))
            adm = _Admission(key, p)
            self._work.put(adm)
            while not adm.done.wait(0.05):
                if not self._workers[1].is_alive():
                    raise RuntimeClosedError(
                        "the mesh's dispatch thread ended") \
                        from self._stop_error
            if adm.error is not None:
                raise adm.error
            return p

    def _pump(self) -> None:
        """Closed batches into the dispatch queue; None when the batcher is
        closed and drained."""
        while True:
            batch = self.batcher.next_batch()
            self._work.put(batch)
            if batch is None:
                return

    def _lead(self) -> None:
        """The leader's dispatch thread: every admission and batch in the
        order they came, each sent to all ranks before any runs it; STOP
        once the batcher is closed and drained. A failure of the channel
        itself fails every batch and admission after it."""
        while True:
            item = self._work.get()
            if item is None:
                break
            if self._stop_error is not None:
                self._refuse(item, self._stop_error)
                continue
            try:
                if isinstance(item, _Admission):
                    self._lead_admit(item)
                else:
                    self._lead_batch(item)
            except Exception as e:   # the channel broke: no rank follows
                self._stop_error = e
                self._refuse(item, e)
        try:
            if self._stop_error is None:
                self.channel.command([meshrun.STOP])
                self.channel.failed_rank(False)
                self.commands.append(("stop", None, 0))
        except Exception as e:
            self._stop_error = e
        self.channel.close()
        closed = RuntimeClosedError("serve runtime is closed")
        while not self._work.empty():
            self._refuse(self._work.get_nowait(), closed)

    def _refuse(self, item, err: BaseException) -> None:
        if item is None:
            return
        if isinstance(item, _Admission):
            item.error = err
            item.done.set()
        else:
            self._fail(item, err)

    def _fail(self, batch: Batch, err: BaseException) -> None:
        for r in batch.requests:
            if not r.handle.done():
                r.handle.set_error(err)
        self.telemetry.record_failed(batch.key, len(batch.requests))

    def _lead_admit(self, adm: "_Admission") -> None:
        try:
            self.channel.command([meshrun.ADMIT, len(self._keys)]
                                 + _key_fields(adm.key))
            self._admit_all(adm.key, adm.plan)
        except MeshBatchError as e:
            adm.error = e
        finally:
            adm.done.set()

    def _admit_all(self, key: BucketKey, p=None) -> None:
        """One admission on every rank together: build the plan (the
        leader's is built) and, on the leader, its host buffer for the
        bucket's payload, agree, warm the plan up on a zero batch (its
        collectives run), agree. Raises :class:`MeshBatchError` on every
        rank when any failed."""
        from repro_torch.core.fft import api

        cfg = self.config
        shape = (cfg.max_batch,) + key.tshape
        err = None
        try:
            if p is None:
                p = api.plan(self.bucketer.spec_for(
                    key, ft_config=cfg.ft if key.ft else None))
            self._payloads[key] = self._payload_dtype(p)
            if self.channel.leads:
                self._buffers[key] = torch.zeros(
                    shape, dtype=self._payloads[key],
                    pin_memory=self._on_card)
        except Exception as e:
            err = e
        self._agree(err, f"admitting bucket {key.label}")
        try:
            serve_plan(p, torch.zeros(shape, dtype=self._payloads[key],
                                      device=self.device), op=key.op)
            if self._on_card:
                torch.cuda.synchronize(self.device)
        except Exception as e:
            err = e
        self._agree(err, f"warming bucket {key.label} up")
        self._plans[key] = p
        self._key_ids[key] = len(self._keys)
        self._keys.append(key)
        self.commands.append(("admit", key.label, 0))

    def _agree(self, err: BaseException | None, what: str) -> None:
        """Every rank's verdict on one step (one flag all-reduce): raise
        :class:`MeshBatchError` on every rank when any failed, naming the
        last rank that did (and on that rank, its own error)."""
        r = self.channel.failed_rank(err is not None)
        if r >= 0:
            mine = f": {err!r}" if err is not None else ""
            raise MeshBatchError(f"{what} failed on rank {r}{mine}") from err

    def _lead_batch(self, batch: Batch) -> None:
        """Pad the batch's host requests into the bucket's host buffer,
        send RUN to every rank, run it with them, complete the handles
        from the assembled result."""
        key, reqs, cfg = batch.key, batch.requests, self.config
        plan = self._plans[key]
        try:
            buf = self._buffers[key]
            for i, r in enumerate(reqs):
                if r.x.ready is None:
                    _pad_into(buf[i], torch.as_tensor(r.x.data))
                else:
                    buf[i] = 0
            buf[len(reqs):] = 0
            inject = self._mesh_inject(plan, batch)
        except Exception as e:
            self._fail(batch, e)
            return
        fill = len(reqs)
        nf = 0 if inject is None else int(inject.shape[0])
        self.channel.command([meshrun.RUN, self._key_ids[key], fill, nf])
        try:
            full, info = self._run_all(key, fill, inject, reqs)
            results = self._mesh_results(reqs, full)
        except MeshBatchError as e:
            self._fail(batch, e)
            return
        pad = sum(self.bucketer.pad_elems(key, r.x.data.shape) for r in reqs)
        pad += (cfg.max_batch - fill) * int(np.prod(key.tshape,
                                                    dtype=np.int64))
        self.telemetry.record_batch(
            key, fill=fill, slots=cfg.max_batch, pad_elems=pad,
            payload_elems=sum(int(np.prod(r.x.data.shape)) for r in reqs))
        if key.ft:
            self._record_ft(key, info)
        base = {"bucket": key.label, "nfft": key.tshape,
                "batch_fill": fill}
        for r, res in zip(reqs, results):
            r.handle.set_result(res, {**base, **info})
            self.telemetry.record_done(key, latency_s=r.handle.latency_s,
                                       queue_s=r.handle.queue_s)

    def _run_all(self, key: BucketKey, fill: int, inject, reqs=None):
        """One batch on every rank together: the SEU rows from the leader,
        the batch buffer on the device (the leader's batch ``reqs``),
        agree, the payload from the leader, ``serve_plan`` on the global
        batch, agree, the result's blocks to the leader. Returns ``(global
        result, info)`` on the leader (:meth:`Channel.assemble`)."""
        ch = self.channel
        if inject is not None:
            ch.broadcast(inject, "control")
        self.commands.append(("run", key.label, fill))
        err = xb = None
        try:
            xb = self._stage(key, reqs)
        except Exception as e:
            err = e
        self._agree(err, f"staging a batch of {key.label}")
        ch.broadcast(xb, "payload")
        try:
            y, info = serve_plan(self._plans[key], xb, op=key.op,
                                 inject=inject)
            if self._on_card:
                torch.cuda.synchronize(self.device)
        except Exception as e:
            err = e
        del xb
        self._agree(err, f"a batch of {key.label}")
        return ch.assemble(y), info

    def _stage(self, key: BucketKey, reqs) -> torch.Tensor:
        """This rank's batch buffer on its device: on the leader the padded
        batch (the host buffer in one copy, the host buffer itself on the
        CPU, as the plan's results never alias it; each card request
        copied on the device after the client's work that made it), an
        empty buffer for the broadcast elsewhere."""
        shape = (self.config.max_batch,) + key.tshape
        if reqs is None:
            return torch.empty(shape, dtype=self._payloads[key],
                               device=self.device)
        xb = self._buffers[key].to(self.device)
        for i, r in enumerate(reqs):
            if r.x.ready is not None:
                torch.cuda.current_stream(self.device).wait_event(r.x.ready)
                xb[i][_block(r.x.data.shape)].copy_(r.x.data)
        return xb

    def _follow_loop(self) -> None:
        """A follower: replay the leader's commands in order until STOP.
        A batch or admission every rank failed is logged in
        :attr:`failures` and the loop goes on; anything else (the channel
        broke) ends it, and :meth:`follow` raises it."""
        try:
            while True:
                cmd = self.channel.command()
                if cmd[0] == meshrun.STOP:
                    self.channel.failed_rank(False)
                    self.commands.append(("stop", None, 0))
                    return
                try:
                    if cmd[0] == meshrun.ADMIT:
                        self._admit_all(_key_of(cmd[2:]))
                    elif cmd[0] == meshrun.RUN:
                        key, fill, nf = self._keys[cmd[1]], cmd[2], cmd[3]
                        inject = torch.empty((nf, 7), dtype=torch.float64) \
                            if nf else None
                        self._run_all(key, fill, inject)
                    else:
                        raise RuntimeError(f"unknown command {cmd}")
                except MeshBatchError as e:
                    self.failures.append(str(e))
        except Exception as e:
            self._stop_error = e
        finally:
            self.channel.close()

    def _mesh_results(self, reqs, full: torch.Tensor) -> list:
        """Each request's row of the assembled result, in the kind it came
        in: a numpy copy or a CPU tensor's own copy of one host copy of
        the batch, or a copy on the card that its client's stream reads
        (``record_stream``, as on one device), ready when this returns."""
        host = full.cpu() if any(r.x.ready is None for r in reqs) else None
        out = []
        for i, r in enumerate(reqs):
            if r.x.ready is None:
                row = host[i]
                out.append(row.numpy().copy()
                           if isinstance(r.x.data, np.ndarray)
                           else row.clone())
                continue
            res = full[i].to(self.device, copy=True)
            res.record_stream(r.x.stream)
            out.append(res)
        if self._on_card:
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _mesh_inject(self, plan, batch: Batch):
        """Every :class:`Fault` of a sharded ft batch as the grouped ABFT's
        ``(F, 7)`` rows ``[rank, batch row, row % n1, col % n2l, 1, eps_re,
        eps_im]`` (float64 on the host; the plan casts them), the
        request's column taken as a global pass-1 output column n2. Any
        number of SEUs a batch."""
        key = batch.key
        if not key.ft:
            return None
        rows = [(i, f) for i, r in enumerate(batch.requests)
                for f in r.inject]
        if not rows:
            return None
        if key.rank != 1:
            raise ValueError("runtime fault injection targets rank-1 ft "
                             "buckets (the serving campaign surface)")
        dp = plan.dist_plan
        n2l = dp.n2 // plan.shards
        out = []
        for brow, f in rows:
            c = f.col % dp.n2
            out.append([c // n2l, brow, f.row % dp.n1, c % n2l, 1.0,
                        f.eps_re, f.eps_im])
        return torch.tensor(out, dtype=torch.float64)

    def follow(self) -> None:
        """On a follower: wait until the leader's STOP ends the follow
        loop, and raise what ended it otherwise (the channel broke)."""
        if self.channel is None or self.channel.leads:
            raise RuntimeError("follow() is for the followers of a runtime "
                               "over a mesh")
        for t in self._workers:
            t.join()
        self._closed = True
        self.channel.close()
        if self._stop_error is not None:
            raise RuntimeError("the follow loop ended before the leader's "
                               "STOP") from self._stop_error

    # -- introspection / lifecycle ----------------------------------------

    def stats(self) -> dict:
        """Telemetry snapshot + plan-cache stats + resolved bucket plans;
        over a mesh also this rank's ``mesh`` record: its rank, the
        leader, the commands it ran and the control group's traffic
        (``[calls, bytes]`` of control, payload, flag and result)."""
        info = plan_cache_info()
        out = {
            "buckets": self.telemetry.snapshot(),
            "plan_cache": {"hits": info.hits, "misses": info.misses,
                           "currsize": info.currsize},
            "plans": {k.label: repr(p) for k, p in self._plans.items()},
        }
        if self.channel is not None:
            out["mesh"] = {"rank": self.channel.rank,
                           "leader": self.channel.leader,
                           "commands": len(self.commands),
                           "traffic": {k: list(v) for k, v in
                                       self.channel.traffic.items()}}
        return out

    def drain(self):
        """Block until every pending request is batched and executed."""
        if self.channel is not None and not self.channel.leads:
            return
        self.batcher.flush()
        while self.batcher.pending or self.batcher.ready:
            threading.Event().wait(0.002)
        while self.channel is not None and any(
                st["submitted"] > st["completed"] + st["failed"]
                + st["rejected"] + st["timeouts"]
                for st in self.telemetry.snapshot().values()):
            threading.Event().wait(0.002)     # batches the dispatch holds

    def close(self, *, drain: bool = True):
        """Stop admissions; drain (or fail) pending work; join workers.
        Over a mesh the leader's close sends STOP after the last batch and
        a follower's waits for it (:meth:`follow`); either raises when the
        channel broke."""
        if self._closed:
            return
        if self.channel is not None and not self.channel.leads:
            self.follow()
            return
        self._closed = True
        self.batcher.close(drain=drain)
        mesh = self.channel is not None
        for t in self._workers:
            t.join(timeout=None if mesh else 30)
        if mesh and self._stop_error is not None:
            raise RuntimeError("the mesh's dispatch thread failed") \
                from self._stop_error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False
