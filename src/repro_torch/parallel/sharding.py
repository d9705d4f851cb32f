"""Logical-axis sharding rules: DP + FSDP + TP + EP + SP over the LM meshes
``(data, model)`` and ``(pod, data, model)``. Port of
``repro.parallel.sharding``.

Params are sharded by *path pattern + shape*: weights put their contraction
feature dim on the FSDP axes (ZeRO-3 over ``(pod, data)``) and their
head/ffn/vocab/expert dim on ``model`` (TP/EP). Scan-stacked leaves carry a
leading layer axis that stays unsharded. Any dim not divisible by its target
axis falls back to replication (e.g. kv_heads=1 for gemma3).

A *spec* is a tuple with one entry per dim: ``None`` (replicated), an axis
name, or a tuple of names (the dim split over those axes, the first the
major one). Entries are spelled as ``jax.sharding.PartitionSpec`` spells
them, so ``tuple(P(...))`` compares equal entry by entry: a one-name tuple
is the name, an empty one ``None``. Paths are the reference's
``_path_str`` strings: the port's tree walker yields its checkpoint keys
(``repro_torch.tree``).

A mesh is a ``DeviceMesh`` with named dims (``launch.mesh.make_host_mesh``)
or anything with ``axis_names`` and a ``shape`` mapping (``launch.mesh.
AbstractMesh``, the production meshes no host builds): the rules read
names and sizes only. :func:`shard_tree` and :func:`gather_tree` place
trees on a ``DeviceMesh``: each rank's slice of each leaf, and the whole
leaf back from the slices by all-gathers over the spec's axes. They do
for the port what XLA's partitioner does for the reference.

The reference's ``constrain_logits``/``constrain_hidden``/
``constrain_moe_buffer`` are hints to XLA's partitioner and have no
counterpart: the port places the batch (the train step takes each rank's
shard by :func:`batch_specs`), the param shards (:func:`shard_tree`) and
the expert buffers (``models.moe.moe_block_ep`` runs a rank's experts
only) itself. :func:`current_mesh` reads the port's own context, set by
:func:`use_mesh`.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import re
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.tree import map_with_path

__all__ = ["dp_axes", "param_specs", "batch_specs", "cache_specs",
           "shard_tree_specs", "logical_rules", "current_mesh", "use_mesh",
           "batch_replicated", "mesh_shape", "shard_tree", "gather_tree",
           "shard_leaf", "gather_leaf", "shard_shape", "spec_axes",
           "all_reduce_over", "flat_specs", "ROUTED_EXPERTS"]

# the routed experts' leaves: EP shards their expert dim over ``model``
ROUTED_EXPERTS = re.compile(r"moe/(wi_gate|wi_up|wo)")

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=(None, False))


def current_mesh():
    """The mesh set by :func:`use_mesh` in this context, or None."""
    return _MESH.get()[0]


def batch_replicated() -> bool:
    """True when :func:`use_mesh` said every rank holds the whole batch
    (the batch did not divide over the dp axes): the reference then
    replicates it over dp and takes no mean over dp."""
    return _MESH.get()[1]


@contextlib.contextmanager
def use_mesh(mesh, *, replicated_batch: bool = False):
    """Run the body under ``mesh``: ``models.moe.moe_block`` takes its
    mesh branch there, as the reference's does under ``with mesh:``. The
    activations a rank passes are its own: its shard of the batch by
    :func:`batch_specs`, or the whole batch when ``replicated_batch``."""
    token = _MESH.set((mesh, bool(replicated_batch)))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` in axis order, of a ``DeviceMesh`` or of a
    mesh with ``axis_names`` and ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def dp_axes(mesh) -> tuple:
    """The data-parallel axes: ('pod', 'data') when multi-pod else ('data',)."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in axes)


def _div(n: int, mesh, axes) -> bool:
    size = _size(mesh, axes)
    return n % size == 0 and n >= size


def _entry(axes):
    """A spec entry as ``PartitionSpec`` spells it."""
    if isinstance(axes, tuple):
        if not axes:
            return None
        if len(axes) == 1:
            return axes[0]
    return axes


def _spec(*entries) -> tuple:
    return tuple(_entry(e) for e in entries)


# ---------------------------------------------------------------------------
# parameter rules: (path regex, rank) -> spec
# ---------------------------------------------------------------------------

def _spec_for_param(path: str, shape: tuple, mesh, fsdp: bool = True):
    f = dp_axes(mesh) if fsdp else None   # FSDP shard target
    t = "model"

    def ok(dim_size, axes):
        return axes is not None and _div(dim_size, mesh, axes)

    nd = len(shape)
    # scan-stacked leaves: leading layer axis unsharded; recurse on the rest
    stacked = bool(re.search(r"scan/slot\d+", path)) and nd >= 2
    if stacked:
        inner = _spec_for_param(path.replace("scan/", "unstacked/"),
                                shape[1:], mesh, fsdp)
        return (None,) + inner

    if "embedding" in path:
        # (vocab, d_model): vocab on model (TP), d_model on fsdp
        return _spec(t if ok(shape[0], t) else None,
                     f if ok(shape[1], f) else None)
    if "lm_head" in path:
        return _spec(f if ok(shape[0], f) else None,
                     t if ok(shape[1], t) else None)
    if ROUTED_EXPERTS.search(path):
        # (E, d, f): EP over model
        return _spec(t if ok(shape[0], t) else None,
                     f if ok(shape[1], f) else None, None)
    if "router" in path:
        return _spec(f if ok(shape[0], f) else None, None)
    if re.search(r"att.*/(wq|wk|wv)$|wq_b|wkv_b|wq$", path) and nd == 2:
        # (d_in, heads*hd): TP on the head dim
        return _spec(f if ok(shape[0], f) else None,
                     t if ok(shape[1], t) else None)
    if re.search(r"att.*/wo$|/wo$", path) and nd == 2 and "mlp" not in path:
        return _spec(t if ok(shape[0], t) else None,
                     f if ok(shape[1], f) else None)
    if re.search(r"(wi_gate|wi_up|wi|w_up|w_in_gate|w_in_rec)$", path) \
            and nd == 2:
        return _spec(f if ok(shape[0], f) else None,
                     t if ok(shape[1], t) else None)
    if re.search(r"(wo|w_down|w_out)$", path) and nd == 2:
        return _spec(t if ok(shape[0], t) else None,
                     f if ok(shape[1], f) else None)
    if re.search(r"(wq_a|wkv_a)$", path) and nd == 2:
        return _spec(f if ok(shape[0], f) else None, None)
    if nd == 2:
        # generic matrices (recurrent gates etc.): fsdp on dim0 if divisible
        return _spec(f if ok(shape[0], f) else None,
                     t if ok(shape[1], t) else None)
    if nd == 3:
        return _spec(None,
                     f if ok(shape[1], f) else None,
                     t if ok(shape[2], t) else None)
    return (None,) * nd


def _path_str(path: tuple) -> str:
    return "/".join(path)


def param_specs(params_shape: Any, mesh, fsdp: bool = True):
    """A spec tree matching a param tree (tensors, ``meta`` tensors or
    anything with a ``shape``)."""
    return map_with_path(
        lambda path, leaf: _spec_for_param(_path_str(path),
                                           tuple(leaf.shape), mesh, fsdp),
        params_shape)


# ---------------------------------------------------------------------------
# activation / batch / cache rules
# ---------------------------------------------------------------------------

def batch_specs(batch_shape: Any, mesh, *, seq_shard: bool = False):
    """Input batch sharding: batch dim over DP axes; optionally seq over
    'data' (SP, for decode shapes with batch < mesh data size)."""
    dp = dp_axes(mesh)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        bspec = dp if _div(shape[0], mesh, dp) else None
        rest = [None] * (nd - 1)
        if seq_shard and nd >= 2 and bspec is None and \
                _div(shape[1], mesh, "data"):
            rest[0] = "data"
        return _spec(bspec, *rest)

    return map_with_path(spec, batch_shape)


def cache_specs(cache_shape: Any, mesh, *, seq_shard: bool = False):
    """KV/state cache sharding.

    Layout conventions (see models/): KV caches are (..., B, S, KH, hd) or
    MLA (..., B, S, r); recurrent states (..., B, W)/(..., B, H, hd, hd).
    Batch goes to DP when divisible; otherwise (long_500k, B=1) the sequence
    axis is sharded over 'data' (sequence parallelism) when possible; head
    axes go to 'model' when divisible.
    """
    dp = dp_axes(mesh)

    def spec(kp, leaf):
        path = _path_str(kp)
        shape = tuple(leaf.shape)
        nd = len(shape)
        out = [None] * nd
        stacked = 1 if re.search(r"scan/slot\d+", path) else 0
        bi = stacked  # batch index
        seq_axes = []
        if nd > bi and _div(shape[bi], mesh, dp):
            out[bi] = dp
        elif seq_shard and nd > bi + 1 and re.search(r"/(k|v|ckv|kr)$",
                                                     path) \
                and _div(shape[bi + 1], mesh, "data"):
            seq_axes.append("data")
        # KV head axis over model where divisible; otherwise shard the
        # *sequence* axis over model (flash-decoding-style split-K)
        if re.search(r"/(k|v)$", path) and nd == bi + 4:
            if _div(shape[bi + 2], mesh, ("model",)):
                out[bi + 2] = "model"
            elif _div(shape[bi + 1], mesh, tuple(seq_axes) + ("model",)):
                seq_axes.append("model")
        if re.search(r"/(ckv|kr)$", path) and nd == bi + 3 and \
                _div(shape[bi + 1], mesh, tuple(seq_axes) + ("model",)):
            seq_axes.append("model")  # MLA latent cache: seq over model
        if seq_axes:
            out[bi + 1] = tuple(seq_axes) if len(seq_axes) > 1 else \
                seq_axes[0]
        if re.search(r"/(c|n)$", path) and nd >= bi + 3 and \
                _div(shape[bi + 1], mesh, ("model",)):
            out[bi + 1] = "model"  # mlstm per-head state over model
        return _spec(*out)

    return map_with_path(spec, cache_shape)


def shard_tree_specs(tree, mesh):
    """Replicated spec tree (optimizer scalars etc.)."""
    return map_with_path(lambda _, leaf: (), tree)


def logical_rules(mesh) -> dict:
    """Documentation-oriented summary of the rule set."""
    return {
        "batch": dp_axes(mesh),
        "fsdp": dp_axes(mesh),
        "tensor": ("model",),
        "expert": ("model",),
        "seq(SP)": ("data",),
    }


# ---------------------------------------------------------------------------
# placement on a DeviceMesh
# ---------------------------------------------------------------------------

def spec_axes(entry) -> tuple:
    """The axis names of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, spec, mesh) -> tuple:
    """A rank's slice's shape of a leaf of ``shape`` placed by ``spec``."""
    return tuple(n // _size(mesh, spec_axes(e)) for n, e in zip(shape, spec))


def _slice_index(mesh, axes) -> int:
    idx = 0
    for a in axes:
        idx = idx * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return idx


def shard_leaf(t: torch.Tensor, spec, mesh, *, keep=()) -> torch.Tensor:
    """This rank's slice of ``t`` by ``spec`` (a view); dims whose entry
    names an axis of ``keep`` stay whole."""
    for dim, e in enumerate(spec):
        axes = spec_axes(e)
        if not axes or set(axes) & set(keep):
            continue
        parts = _size(mesh, axes)
        n = t.shape[dim] // parts
        t = t.narrow(dim, _slice_index(mesh, axes) * n, n)
    return t


def gather_leaf(t: torch.Tensor, spec, mesh, *, keep=()) -> torch.Tensor:
    """The whole leaf from each rank's slice ``t``: one all-gather a
    sharded dim and axis of size > 1 (the minor axis first), over that
    axis's group. Dims whose entry names an axis of ``keep`` stay
    sliced."""
    for dim, e in enumerate(spec):
        axes = spec_axes(e)
        if not axes or set(axes) & set(keep):
            continue
        for a in reversed(axes):
            n = mesh_shape(mesh)[a]
            if n == 1:
                continue
            src = t.movedim(dim, 0).contiguous()
            out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
            dist.all_gather_into_tensor(out, src, group=mesh.get_group(a))
            t = out.movedim(0, dim)
    return t.contiguous()


def shard_tree(tree, specs, mesh):
    """Each leaf's slice on this rank (views of ``tree``'s leaves)."""
    flat = dict(flat_specs(specs))
    return map_with_path(
        lambda path, leaf: shard_leaf(leaf, flat[path], mesh), tree)


def gather_tree(shards, specs, mesh):
    """Each leaf whole on every rank, from the ranks' slices. Every rank of
    the mesh calls it, in the same order."""
    flat = dict(flat_specs(specs))
    return map_with_path(
        lambda path, leaf: gather_leaf(leaf, flat[path], mesh), shards)


def flat_specs(specs, path: tuple = ()) -> list:
    """``(path, spec)`` of a spec tree: nested dicts (the param, batch and
    cache trees) whose leaves are spec tuples."""
    if not isinstance(specs, dict):
        return [(path, specs)]
    return [item for k, v in specs.items()
            for item in flat_specs(v, path + (str(k),))]


def all_reduce_over(t: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM):
    """``t`` reduced in place over the groups of ``axes`` in turn (axes of
    size 1 skipped): over a product of axes, as one group over them."""
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        if mesh_shape(mesh)[a] > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
    return t
