"""Serving telemetry: per-bucket counters, latency percentiles, ABFT
verdict aggregation.

One :class:`Telemetry` instance is shared by the scheduler and the worker
pool, so every mutation takes the internal lock; :meth:`Telemetry.snapshot`
returns plain dicts safe to hand across threads (and to ``json.dumps``).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

__all__ = ["BucketStats", "Telemetry", "percentiles"]

# the latency quantiles every snapshot reports, the serving counterpart of
# the HLO-volume asserts: p50 = typical, p95/p99 = the deadline tail
QUANTILES = (50.0, 95.0, 99.0)


def percentiles(latencies_s) -> dict:
    """``{"p50_ms", "p95_ms", "p99_ms"}`` of a latency sample (seconds in,
    milliseconds out; all-zero when the sample is empty)."""
    if not len(latencies_s):
        return {f"p{int(q)}_ms": 0.0 for q in QUANTILES}
    arr = np.asarray(latencies_s, dtype=np.float64) * 1e3
    vals = np.percentile(arr, QUANTILES)
    return {f"p{int(q)}_ms": float(v) for q, v in zip(QUANTILES, vals)}


@dataclasses.dataclass
class BucketStats:
    """Mutable per-bucket accumulator (guarded by the Telemetry lock).

    ``pad_elems``/``payload_elems`` carry the bucketer's padding waste:
    a request of 1000 points served from a 1024-point bucket adds 24 to
    ``pad_elems`` and 1000 to ``payload_elems``; empty batch slots add the
    whole canonical signal. ``ft_*`` counters aggregate the ABFT verdicts
    of every ft batch the bucket executed (detected = flagged groups).
    """

    submitted: int = 0
    completed: int = 0
    failed: int = 0
    rejected: int = 0
    timeouts: int = 0
    batches: int = 0
    batched_signals: int = 0          # filled slots over all closed batches
    batch_slots: int = 0              # max_batch * batches
    pad_elems: int = 0
    payload_elems: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)
    queue_s: list = dataclasses.field(default_factory=list)
    ft_injected: int = 0
    ft_detected: int = 0
    ft_corrected: int = 0
    ft_uncorrectable: int = 0
    ft_checksum_faults: int = 0
    ft_recomputed: int = 0

    def snapshot(self) -> dict:
        d = {
            "submitted": self.submitted, "completed": self.completed,
            "failed": self.failed, "rejected": self.rejected,
            "timeouts": self.timeouts, "batches": self.batches,
            "batch_occupancy": (self.batched_signals / self.batch_slots
                                if self.batch_slots else 0.0),
            "pad_waste": (self.pad_elems /
                          (self.pad_elems + self.payload_elems)
                          if self.pad_elems + self.payload_elems else 0.0),
            **percentiles(self.latencies_s),
            "queue_p50_ms": percentiles(self.queue_s)["p50_ms"],
        }
        if any((self.ft_injected, self.ft_detected, self.ft_corrected,
                self.ft_uncorrectable, self.ft_checksum_faults,
                self.ft_recomputed)):
            d.update(injected=self.ft_injected, detected=self.ft_detected,
                     corrected=self.ft_corrected,
                     uncorrectable=self.ft_uncorrectable,
                     checksum_faults=self.ft_checksum_faults,
                     recomputed=self.ft_recomputed)
        return d


class Telemetry:
    """Thread-safe per-bucket serving stats."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: dict = {}

    def _stats(self, key) -> BucketStats:
        # callers hold self._lock
        st = self._buckets.get(key)
        if st is None:
            st = self._buckets[key] = BucketStats()
        return st

    def record_submit(self, key, *, injected: int = 0):
        with self._lock:
            st = self._stats(key)
            st.submitted += 1
            st.ft_injected += injected

    def record_reject(self, key):
        with self._lock:
            self._stats(key).rejected += 1

    def record_timeout(self, key, n: int = 1):
        with self._lock:
            self._stats(key).timeouts += n

    def record_batch(self, key, *, fill: int, slots: int,
                     pad_elems: int, payload_elems: int):
        with self._lock:
            st = self._stats(key)
            st.batches += 1
            st.batched_signals += fill
            st.batch_slots += slots
            st.pad_elems += pad_elems
            st.payload_elems += payload_elems

    def record_done(self, key, *, latency_s: float, queue_s: float):
        with self._lock:
            st = self._stats(key)
            st.completed += 1
            st.latencies_s.append(float(latency_s))
            st.queue_s.append(float(queue_s))

    def record_failed(self, key, n: int = 1):
        with self._lock:
            self._stats(key).failed += n

    def record_ft(self, key, *, detected: int = 0, corrected: int = 0,
                  uncorrectable: int = 0, checksum_faults: int = 0,
                  recomputed: int = 0):
        with self._lock:
            st = self._stats(key)
            st.ft_detected += detected
            st.ft_corrected += corrected
            st.ft_uncorrectable += uncorrectable
            st.ft_checksum_faults += checksum_faults
            st.ft_recomputed += recomputed

    def snapshot(self) -> dict:
        """``{bucket label: stats dict}`` — a point-in-time copy."""
        with self._lock:
            return {getattr(k, "label", str(k)): st.snapshot()
                    for k, st in sorted(self._buckets.items(),
                                        key=lambda kv: str(kv[0]))}
