"""Deadline batcher: coalesce same-bucket requests into planned batches
under a latency deadline, with bounded-queue backpressure.

The contract (documented in README "Serving runtime"):

* a batch CLOSES when its bucket holds ``max_batch`` requests or when its
  oldest request has waited ``deadline_ms`` — whichever comes first. A
  full batch closes inline on the submitting thread (no deadline-thread
  hop on the hot path); deadlines are enforced by one background timer
  thread;
* backpressure is a bounded queue over ALL pending (not-yet-closed)
  requests: ``submit`` on a full queue raises :class:`QueueFullError`
  immediately — open-loop clients must see rejection, not unbounded
  buffering;
* a request older than ``timeout_ms`` (when set) that still has not been
  batched is failed with :class:`RequestTimeoutError` and dropped by the
  timer thread — its slot returns to the queue budget;
* ``close(drain=True)`` stops admissions, flushes every partial batch to
  the workers, and wakes all waiters — graceful drain; ``drain=False``
  fails whatever is still pending with :class:`RuntimeClosedError`.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable

__all__ = ["QueueFullError", "RequestTimeoutError", "RuntimeClosedError",
           "RequestHandle", "ServeRequest", "Batch", "DeadlineBatcher"]


class QueueFullError(RuntimeError):
    """Bounded pending queue is full — backpressure; resubmit later."""


class RequestTimeoutError(TimeoutError):
    """The request exceeded its timeout before (or while) being served."""


class RuntimeClosedError(RuntimeError):
    """The runtime is shutting down and no longer accepts requests."""


class RequestHandle:
    """Client-side future for one submitted request.

    ``result(timeout=None)`` blocks until the worker pool publishes the
    request's output (or failure) and returns it / raises. Timing fields
    are filled in by the scheduler and workers for telemetry.
    """

    __slots__ = ("_event", "_result", "_error", "t_submit", "t_batched",
                 "t_done", "info")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._error: BaseException | None = None
        self.t_submit = 0.0
        self.t_batched = 0.0
        self.t_done = 0.0
        self.info: dict = {}

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"request not served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def set_result(self, value, info: dict | None = None):
        self._result = value
        if info:
            self.info = info
        self.t_done = time.monotonic()
        self._event.set()

    def set_error(self, err: BaseException):
        self._error = err
        self.t_done = time.monotonic()
        self._event.set()

    @property
    def latency_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)

    @property
    def queue_s(self) -> float:
        return max(0.0, self.t_batched - self.t_submit)


@dataclasses.dataclass
class ServeRequest:
    """One admitted request: payload + bucket + client handle."""

    key: Any                       # BucketKey
    x: Any                         # the (unpadded) signal, numpy-convertible
    handle: RequestHandle
    inject: Any = None             # per-request SEU descriptor (ft buckets)
    timeout_ms: float | None = None


@dataclasses.dataclass
class Batch:
    """A closed batch, ready for a worker: same-bucket requests in
    submission order (at most ``max_batch`` of them)."""

    key: Any
    requests: list
    t_close: float


class DeadlineBatcher:
    """Per-bucket request coalescing under ``(max_batch, deadline_ms)``."""

    def __init__(self, *, max_batch: int, deadline_ms: float,
                 queue_depth: int, timeout_ms: float | None = None,
                 on_timeout: Callable | None = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if deadline_ms < 0:
            raise ValueError(f"deadline_ms must be >= 0, got {deadline_ms}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_ms) / 1e3
        self.queue_depth = int(queue_depth)
        self.timeout_ms = timeout_ms
        self._on_timeout = on_timeout
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # bucket key -> deque[(t_submit, ServeRequest)] of pending requests
        self._pending: dict = collections.defaultdict(collections.deque)
        self._npending = 0
        self._ready: collections.deque[Batch] = collections.deque()
        self._closed = False
        self._timer = threading.Thread(target=self._deadline_loop,
                                       name="serve-deadline", daemon=True)
        self._timer.start()

    # -- producer side -----------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        """Admit one request; raises :class:`QueueFullError` on
        backpressure and :class:`RuntimeClosedError` after close()."""
        now = time.monotonic()
        req.handle.t_submit = now
        with self._cond:
            if self._closed:
                raise RuntimeClosedError("serve runtime is closed")
            if self._npending >= self.queue_depth:
                raise QueueFullError(
                    f"pending queue full ({self.queue_depth} requests) — "
                    f"backpressure; retry after the pool drains")
            q = self._pending[req.key]
            q.append(req)
            self._npending += 1
            if len(q) >= self.max_batch:
                self._close_bucket(req.key, now)
            self._cond.notify_all()

    def _close_bucket(self, key, now: float) -> None:
        # callers hold the lock
        q = self._pending.get(key)
        if not q:
            return
        take = [q.popleft() for _ in range(min(len(q), self.max_batch))]
        self._npending -= len(take)
        for r in take:
            r.handle.t_batched = now
        self._ready.append(Batch(key=key, requests=take, t_close=now))

    # -- consumer side -----------------------------------------------------

    def next_batch(self, timeout: float | None = None) -> Batch | None:
        """Blocking take for worker threads. Returns ``None`` when the
        batcher is closed and fully drained (worker exit signal), or on
        ``timeout`` (idle poll)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            while True:
                if self._ready:
                    return self._ready.popleft()
                if self._closed and self._npending == 0:
                    return None
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return None
                self._cond.wait(wait if wait is not None else 0.1)

    # -- deadline / timeout enforcement ------------------------------------

    def _deadline_loop(self):
        while True:
            with self._cond:
                if self._closed and self._npending == 0:
                    return
                now = time.monotonic()
                flushed = False
                for key in list(self._pending):
                    q = self._pending[key]
                    if not q:
                        continue
                    # per-request timeout: fail requests that aged out
                    # before a batch formed (their queue slot frees up)
                    while q and self._timed_out(q[0], now):
                        r = q.popleft()
                        self._npending -= 1
                        if self._on_timeout is not None:
                            self._on_timeout(key)
                        tmo = r.timeout_ms if r.timeout_ms is not None \
                            else self.timeout_ms
                        r.handle.set_error(RequestTimeoutError(
                            f"request waited > {tmo}ms unbatched in "
                            f"bucket {getattr(key, 'label', key)}"))
                        flushed = True
                    if q and now - q[0].handle.t_submit >= self.deadline_s:
                        self._close_bucket(key, now)
                        flushed = True
                if flushed:
                    self._cond.notify_all()
                # sleep until the earliest pending wake point — a batch
                # deadline OR a per-request timeout, whichever is sooner
                # (or a coarse tick when idle, to notice close())
                def _wake(r):
                    t = r.handle.t_submit + self.deadline_s
                    tmo = r.timeout_ms if r.timeout_ms is not None \
                        else self.timeout_ms
                    if tmo is not None:
                        t = min(t, r.handle.t_submit + tmo / 1e3)
                    return t
                nxt = min((_wake(r) for q in self._pending.values()
                           for r in q), default=now + 0.05)
                self._cond.wait(max(1e-4, nxt - time.monotonic()))

    def _timed_out(self, req: ServeRequest, now: float) -> bool:
        tmo = req.timeout_ms if req.timeout_ms is not None \
            else self.timeout_ms
        return tmo is not None and (now - req.handle.t_submit) > tmo / 1e3

    # -- lifecycle ---------------------------------------------------------

    def flush(self) -> None:
        """Close every partial batch now (tests / drain)."""
        with self._cond:
            now = time.monotonic()
            for key in list(self._pending):
                while self._pending[key]:
                    self._close_bucket(key, now)
            self._cond.notify_all()

    def close(self, *, drain: bool = True) -> None:
        """Stop admissions. ``drain=True`` flushes partial batches for the
        workers to finish; ``drain=False`` fails all pending requests."""
        with self._cond:
            self._closed = True
            now = time.monotonic()
            if drain:
                for key in list(self._pending):
                    while self._pending[key]:
                        self._close_bucket(key, now)
            else:
                for key, q in self._pending.items():
                    while q:
                        r = q.popleft()
                        self._npending -= 1
                        r.handle.set_error(
                            RuntimeClosedError("runtime closed before "
                                               "the request was served"))
            self._cond.notify_all()
        self._timer.join(timeout=5)

    @property
    def pending(self) -> int:
        with self._lock:
            return self._npending

    @property
    def ready(self) -> int:
        with self._lock:
            return len(self._ready)
