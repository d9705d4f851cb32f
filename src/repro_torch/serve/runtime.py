"""Multi-tenant FFT serving runtime: bucketed admission, deadline batching,
and a worker pool over the cached plan executors, on one device.

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
aggregates over every batch the bucket executed. Sharded buckets (a mesh)
are ROADMAP queue 1 item 10.4.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.plan import FTConfig, plan_cache_info, resolve_device
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
    runtime translates it to the fused kernel's descriptor and to the
    request's batch row."""

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
    age out unbatched. ``ft`` is the FTConfig attached to ``ft=True``
    buckets at admission. ``device`` is where every bucket runs: the card
    (``"cuda"``, the kernels) unless the caller asks for ``"cpu"`` (the
    kernels' plain versions); without a card ``"cuda"`` raises when the
    runtime is built."""

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
        self._worker_state = [_Worker(torch.cuda.Stream(self.device)
                               if self._on_card else None)
                       for _ in range(cfg.workers)]
        self._admission = threading.Lock()
        self._closed = False
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
        geometry surfaces."""
        p = self._plans.get(key)
        if p is not None:
            return p
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

    # -- introspection / lifecycle ----------------------------------------

    def stats(self) -> dict:
        """Telemetry snapshot + plan-cache stats + resolved bucket plans."""
        info = plan_cache_info()
        return {
            "buckets": self.telemetry.snapshot(),
            "plan_cache": {"hits": info.hits, "misses": info.misses,
                           "currsize": info.currsize},
            "plans": {k.label: repr(p) for k, p in self._plans.items()},
        }

    def drain(self):
        """Block until every pending request is batched and executed."""
        self.batcher.flush()
        while self.batcher.pending or self.batcher.ready:
            threading.Event().wait(0.002)

    def close(self, *, drain: bool = True):
        """Stop admissions; drain (or fail) pending work; join workers."""
        if self._closed:
            return
        self._closed = True
        self.batcher.close(drain=drain)
        for t in self._workers:
            t.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False
