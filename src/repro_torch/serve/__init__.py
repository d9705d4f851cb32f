"""Multi-tenant FFT serving on one card: spec bucketing, deadline batching,
and a worker pool over the shared (thread-safe) plan cache.

Quick start::

    from repro_torch.serve import RuntimeConfig, ServeRuntime

    with ServeRuntime(RuntimeConfig(max_batch=8, deadline_ms=2.0)) as rt:
        h = rt.submit(x, op="fft")          # x: one (n,) or (r, c) signal
        y = h.result(timeout=5.0)           # padded-bucket transform of x

The runtime runs on the card (``RuntimeConfig(device="cuda")``, the
default) unless the caller asks for ``device="cpu"``. ``launch.serve
--mode serve`` is the CLI over this package; the modules split policy from
mechanism: ``bucketing`` (request -> canonical padded spec), ``scheduler``
(deadline batching + backpressure), ``runtime`` (the pool), ``telemetry``
(per-bucket stats), ``specs`` (spec construction and the single-batch
executor shared with the CLI).
"""
from repro_torch.serve.bucketing import (BATCHABLE_OPS, BucketKey,
                                         SpecBucketer, pad_transform_shape)
from repro_torch.serve.runtime import Fault, RuntimeConfig, ServeRuntime
from repro_torch.serve.scheduler import (Batch, DeadlineBatcher,
                                         QueueFullError, RequestHandle,
                                         RequestTimeoutError,
                                         RuntimeClosedError, ServeRequest)
from repro_torch.serve.specs import (SPEC_KEYS, apply_fft_spec_arg,
                                     build_fft_spec, serve_plan)
from repro_torch.serve.telemetry import BucketStats, Telemetry, percentiles

__all__ = [
    "BATCHABLE_OPS", "BucketKey", "SpecBucketer", "pad_transform_shape",
    "Fault", "RuntimeConfig", "ServeRuntime",
    "Batch", "DeadlineBatcher", "QueueFullError", "RequestHandle",
    "RequestTimeoutError", "RuntimeClosedError", "ServeRequest",
    "SPEC_KEYS", "apply_fft_spec_arg", "build_fft_spec", "serve_plan",
    "BucketStats", "Telemetry", "percentiles",
]
