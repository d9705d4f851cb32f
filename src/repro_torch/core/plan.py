"""Op-agnostic plan layer: one frozen spec -> one cached :class:`Plan`
executor bundle, for any checked operator family.

TurboFFT's ABFT is derived from the GEMV view of the DFT (paper §2.2.2) —
the checksum/locate/correct machinery is a property of a *linear operator*,
not of the FFT. This module is the spec->plan->executor skeleton:

* the spec is a frozen, hashable value object describing one workload
  (shape, dtype, device, fault-tolerance knobs). Equal specs hash equal and
  hit the same cached plan;
* :func:`plan` resolves a spec ONCE into the :class:`Plan` subclass
  registered for its type (``core.fft.api.FFTSpec -> FFTPlan``), whose
  constructor does every per-call decision up front (stage plan, device
  tables) so execution is a straight dispatch;
* :class:`FTConfig` is the shared fault-tolerance attachment.

Same contract as ``repro.core.plan``; no operator-family imports here.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading

import torch

__all__ = ["FTConfig", "Plan", "plan", "register_plan_type",
           "plan_cache_info", "plan_cache_clear", "plan_cache_keys",
           "dtype_name", "resolve_device"]


def dtype_name(dtype) -> str:
    """The name of a torch, numpy or string dtype (``"float32"``,
    ``"complex64"``, ...), the form a frozen spec stores."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    name = getattr(dtype, "name", None)        # numpy dtypes and scalar types
    if name is None and isinstance(dtype, type):
        name = dtype.__name__
    return str(name if name is not None else dtype)


def resolve_device(device, owner: str) -> torch.device:
    """A spec's device, checked: a CUDA request without a card raises (it
    never runs on the CPU instead); ``"cuda"`` resolves to the current
    card. ``owner`` names the spec class in the messages."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner}.device={str(device)!r} but no CUDA device is "
                f"available — pass device='cpu' to run the kernels' plain "
                f"versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"{owner}.device must be cuda or cpu, "
                         f"got {str(device)!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class FTConfig:
    """Fault-tolerance configuration folded into a plan spec.

    Shared knobs: ``threshold`` (detection delta) and ``correct`` (online
    correction vs detect-only). Mesh-path knobs (grouped two-side FFT ABFT):
    ``groups`` / ``group_size`` / ``recompute_uncorrectable``. Local
    fused-kernel knobs: ``transactions`` / ``per_signal`` / ``encoding``.
    A plan uses whichever subset its dispatch path needs; the port's local
    rank-1 FFT path reads ``threshold``, ``correct``, ``transactions``,
    ``per_signal`` and ``encoding``. Fields and defaults match
    ``repro.core.plan.FTConfig``.
    """

    threshold: float = 1e-4
    correct: bool = True
    groups: int | None = None
    group_size: int | None = None
    recompute_uncorrectable: bool = False
    transactions: int = 4
    per_signal: bool = False
    encoding: str = "wang"


class Plan:
    """Base class for pre-resolved executor bundles.

    Subclasses resolve everything in ``__init__(spec)`` — stage plan, device
    tables, checksum geometry — and bind executors as bound methods, so
    execution is a straight dispatch. Two hooks are part of the shared
    contract:

    * ``volume`` — an analytic cost/traffic model of one execution
      (``None`` when the family has no model for the resolved path);
    * :meth:`describe` — a flat dict of the resolved plan parameters, for
      telemetry and benchmark tables.

    Construct via :func:`plan` (LRU-cached on the spec), not directly.
    """

    volume = None

    def __init__(self, spec):
        self.spec = spec

    def describe(self) -> dict:
        d = {"plan": type(self).__name__,
             "spec": type(self.spec).__name__,
             "ft": getattr(self.spec, "ft", None) is not None}
        if self.volume is not None:
            d["volume"] = self.volume
        return d


_PLAN_TYPES: dict[type, type[Plan]] = {}


def register_plan_type(spec_cls: type, plan_cls: type[Plan] | None = None):
    """Register ``plan_cls`` as the :class:`Plan` for ``spec_cls``.

    Usable as a decorator on the plan class::

        @register_plan_type(FFTSpec)
        class FFTPlan(Plan): ...
    """
    if plan_cls is None:
        def deco(cls):
            register_plan_type(spec_cls, cls)
            return cls
        return deco
    if not (isinstance(plan_cls, type) and issubclass(plan_cls, Plan)):
        raise TypeError(f"register_plan_type needs a Plan subclass, "
                        f"got {plan_cls!r}")
    _PLAN_TYPES[spec_cls] = plan_cls
    return plan_cls


# The shared plan cache is thread-safe: the miss path is guarded by
# per-spec in-flight events — when N threads race on the SAME new spec,
# exactly one constructs the plan (one plan object, one upload of its
# device tables) and the rest block until it lands in the cache; threads
# building DISTINCT specs construct concurrently. ``functools.lru_cache``
# only serializes its bookkeeping, not the miss-path construction.
_CACHE_MAXSIZE = 512
_cache: "collections.OrderedDict[object, Plan]" = collections.OrderedDict()
_inflight: dict[object, threading.Event] = {}
_cache_lock = threading.Lock()
_hits = 0
_misses = 0


def _plan_cached(spec) -> Plan:
    global _hits, _misses
    while True:
        with _cache_lock:
            if spec in _cache:
                _cache.move_to_end(spec)
                _hits += 1
                return _cache[spec]
            ev = _inflight.get(spec)
            if ev is None:
                _inflight[spec] = threading.Event()
                _misses += 1
                break
        # another thread is constructing this exact spec: wait for it to
        # publish (or fail), then retry the lookup
        ev.wait()
    try:
        built = _PLAN_TYPES[type(spec)](spec)
    except BaseException:
        with _cache_lock:
            ev = _inflight.pop(spec)
        ev.set()        # waiters retry; the next one constructs the plan
        raise
    with _cache_lock:
        _cache[spec] = built
        while len(_cache) > _CACHE_MAXSIZE:
            _cache.popitem(last=False)
        ev = _inflight.pop(spec)
    ev.set()
    return built


def plan(spec) -> Plan:
    """Build (or fetch from the shared LRU cache) the :class:`Plan` for
    ``spec``. Equal specs return the SAME plan object — the cuFFT ``plan
    once, exec hot`` contract, for every registered operator family.
    Thread-safe: concurrent misses on one spec construct exactly one
    plan."""
    if type(spec) not in _PLAN_TYPES:
        known = ", ".join(c.__name__ for c in _PLAN_TYPES) or "none imported"
        raise TypeError(
            f"plan() takes a registered plan spec ({known}), got "
            f"{type(spec).__name__}")
    return _plan_cached(spec)


def plan_cache_info():
    """``functools``-style cache stats ``(hits, misses, maxsize, currsize)``
    of the shared plan cache."""
    with _cache_lock:
        return functools._CacheInfo(_hits, _misses, _CACHE_MAXSIZE,
                                    len(_cache))


def plan_cache_keys() -> list:
    """The cached specs, least- to most-recently used."""
    with _cache_lock:
        return list(_cache)


def plan_cache_clear():
    global _hits, _misses
    with _cache_lock:
        _cache.clear()
        _hits = 0
        _misses = 0
