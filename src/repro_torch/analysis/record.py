"""Collective recorder: each ``torch.distributed`` collective a program
issues, in program order, as a structured record.

The counterpart of the reference's ``repro/analysis/hlo.py``. The reference
lowers a jitted program and parses its post-partitioning HLO; the port has
no compiler to ask, so it runs the program under :class:`record`, which
wraps ``dist.all_to_all_single``, ``dist.all_gather_into_tensor``,
``dist.all_reduce``, ``dist.broadcast``, ``dist.send`` and ``dist.recv``
for the body of a ``with`` block. Every collective of the port bottoms out
in one of these: the sharded FFT's mesh view (``core.fft.distributed.
_Mesh``: its ``all_to_all``, ``all_gather``, ``all_reduce``,
``data_gather`` and ``data_all_to_all``) calls them by attribute at call
time, as do the LM's sharding helpers, the EP combine, the pipeline hop and
the serving mesh.

The byte conventions are the reference's (``hlo.py``), so that
``plan.volume``'s ``all_to_all_bytes``, ``gather_hlo``, ``psum_hlo`` and
``hlo_bytes`` compare one to one: an all-to-all's payload is its send
buffer, an all-gather's its output, an all-reduce's the reduced tensor
with wire bytes twice its payload (the ring's reduce-scatter and
all-gather phases); a broadcast, a send and a recv move their tensor once.
Byte counts are a rank's own.

On a ``fake`` process group (``torch.testing._internal.distributed.
fake_pg``, which the audit and the dry run set up) the recorder does not
call the collective: it sets the output itself, so the result does not
rest on what one torch version's fake backend does. An all-to-all's output
is its input (flat, as far as the shorter buffer goes), an all-gather tiles
its input over the output, and an all-reduce, a broadcast and a recv leave
the tensor as it is. On any other backend the collective runs and is
recorded.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist

__all__ = ["CollectiveOp", "DTYPE_TOKENS", "DTYPE_BYTES",
           "WIRE_FACTOR", "record", "summarize", "root_signature",
           "dtype_token", "fake_process_group", "tensors"]

DTYPE_TOKENS = {torch.float64: "f64", torch.float32: "f32",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int64: "s64", torch.int32: "s32", torch.int8: "s8",
                torch.uint8: "u8", torch.bool: "pred",
                torch.complex64: "c64", torch.complex128: "c128"}
DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
               "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}
# wire-bytes multiplier per collective kind (ring algorithms)
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "all-to-all": 1.0,
               "broadcast": 1.0, "send": 1.0, "recv": 1.0}

# kind, the ``dist`` function, where its payload tensor sits (argument
# index and keyword) and the index of its ``group`` argument
_WRAPPED = (("all-to-all", "all_to_all_single", 1, "input", 4),
            ("all-gather", "all_gather_into_tensor", 0, "output_tensor", 2),
            ("all-reduce", "all_reduce", 0, "tensor", 2),
            ("broadcast", "broadcast", 0, "tensor", 2),
            ("send", "send", 0, "tensor", 2),
            ("recv", "recv", 0, "tensor", 2))


def dtype_token(dtype: torch.dtype) -> str:
    """The reference's HLO spelling of ``dtype`` (``c64``, ``f32``, ...)."""
    return DTYPE_TOKENS[dtype]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective in program order.

    ``shapes`` is the payload buffer as ``(dtype, elems)`` pairs (one
    pair: a ``dist`` collective moves one tensor), ``payload_bytes`` their
    byte total, ``wire_bytes`` the rank's wire traffic (payload x ring
    factor), ``group_size`` the ranks of the group it ran over and
    ``group`` that group.
    """

    kind: str
    is_async: bool
    shapes: tuple[tuple[str, int], ...]
    payload_bytes: int
    wire_bytes: float
    group_size: int = 1
    # the process group it ran over (None: the default group)
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    @property
    def dtypes(self) -> tuple[str, ...]:
        return tuple(dt for dt, _ in self.shapes)

    @property
    def elems(self) -> int:
        return sum(n for _, n in self.shapes)


def _op(kind: str, t: torch.Tensor, *, is_async: bool, group_size: int,
        group=None) -> CollectiveOp:
    token = dtype_token(t.dtype)
    n = t.numel()
    payload = n * DTYPE_BYTES[token]
    return CollectiveOp(kind=kind, is_async=is_async, shapes=((token, n),),
                        payload_bytes=payload,
                        wire_bytes=payload * WIRE_FACTOR[kind],
                        group_size=group_size, group=group)


class _Done:
    """The handle of an emulated asynchronous collective."""

    def wait(self, timeout=None) -> bool:
        return True

    def is_completed(self) -> bool:
        return True


def _emulate(kind: str, args: tuple, kwargs: dict):
    """Set the output of one collective on a fake group (module docstring)."""
    if kind == "all-to-all":
        out = args[0] if args else kwargs["output"]
        inp = args[1] if len(args) > 1 else kwargs["input"]
        k = min(out.numel(), inp.numel())
        flat = out.view(-1)
        flat[:k].copy_(inp.reshape(-1)[:k])
        if k < out.numel():
            flat[k:].zero_()
    elif kind == "all-gather":
        out = args[0] if args else kwargs["output_tensor"]
        inp = args[1] if len(args) > 1 else kwargs["input_tensor"]
        reps = out.numel() // max(inp.numel(), 1)
        out.view(-1).copy_(inp.reshape(-1).repeat(reps))
    return _Done() if kwargs.get("async_op") else None


class record:
    """Record every ``dist`` collective issued in the body::

        with record() as ops:
            plan.fft(x)
        summarize(ops)

    ``ops`` is a list of :class:`CollectiveOp`, appended in program order.
    ``emulate`` (module docstring) defaults to whether the collective's
    group runs the ``fake`` backend; pass True or False to force it (with
    True no process group is needed: a group of one is recorded). The
    wrappers are module attributes of ``torch.distributed``, so every
    thread's collectives in the body are recorded; contexts nest (every
    enclosing context records a call), each restoring what it replaced."""

    def __init__(self, *, emulate: bool | None = None):
        self.emulate = emulate
        self.ops: list[CollectiveOp] = []
        self._saved: dict = {}

    def _wrap(self, kind: str, pos: int, key: str, gpos: int, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t = args[pos] if len(args) > pos else kwargs[key]
            group = args[gpos] if len(args) > gpos else kwargs.get("group")
            fake = self.emulate
            if fake is None:
                fake = dist.get_backend(group) == "fake"
            size = dist.get_world_size(group) if dist.is_initialized() else 1
            self.ops.append(_op(kind, t, is_async=bool(kwargs.get("async_op")),
                                group_size=size, group=group))
            if fake and not hasattr(fn, "recorder"):
                return _emulate(kind, args, kwargs)
            return fn(*args, **kwargs)     # the collective, or an outer
                                           # context's wrapper
        wrapped.recorder = self
        return wrapped

    def __enter__(self) -> list[CollectiveOp]:
        for kind, name, pos, key, gpos in _WRAPPED:
            fn = getattr(dist, name)
            self._saved[name] = fn
            setattr(dist, name, self._wrap(kind, pos, key, gpos, fn))
        return self.ops

    def __exit__(self, *exc) -> None:
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved.clear()


def summarize(ops) -> dict:
    """The reference's ``collective_bytes`` dict view of records: per-kind
    wire ``bytes`` / ``count``, program-order ``(kind, wire)`` ``ops``
    pairs, and the scalar ``total_bytes``."""
    out = {k: 0.0 for k in WIRE_FACTOR}
    count = {k: 0 for k in WIRE_FACTOR}
    pairs = []
    for op in ops:
        out[op.kind] += op.wire_bytes
        count[op.kind] += 1
        pairs.append((op.kind, op.wire_bytes))
    return {"bytes": out, "count": count, "ops": pairs,
            "total_bytes": float(sum(out.values()))}


def tensors(obj):
    """Every tensor of ``obj`` in order (a DTensor's local shard): a
    tensor, a dataclass's fields, a tuple's, list's or dict's items."""
    if isinstance(obj, torch.Tensor):
        to_local = getattr(obj, "to_local", None)
        yield to_local() if to_local is not None else obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from tensors(v)


def root_signature(outputs) -> tuple[str, ...]:
    """Dtype tokens of an executor's outputs, in order: its tensors (a
    DTensor's local shard), those of a result dataclass's fields, of a
    tuple, list or dict. ``(y, stats)`` of a complex128 transform yields
    ``("c128", "f64")``. The counterpart of the reference's ENTRY result
    signature, read by the audit's downcast check."""
    return tuple(dtype_token(t.dtype) for t in tensors(outputs))


@contextlib.contextmanager
def fake_process_group(world_size: int, *, rank: int = 0):
    """A ``fake`` process group of ``world_size`` ranks, this process rank
    ``rank``, for the body: no peers, no network; every collective on it
    is the recorder's to emulate. When a process group already exists it
    is used as it is (its world must hold ``world_size`` ranks) and left
    standing."""
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"the process group has {dist.get_world_size()} ranks, "
                f"{world_size} are needed")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
