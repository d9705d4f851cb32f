"""The device meshes: the sharded FFT's and the LM's.

``make_fft_mesh`` and ``make_host_mesh`` build a ``torch.distributed``
``DeviceMesh`` over the ranks of the initialised process group
(``torchrun``, or ``dist.init_process_group`` with an address, world size
and rank); every rank calls them, also a rank the mesh leaves out.
``make_production_mesh`` is the reference's 256- or 512-chip LM mesh,
which no single host builds: an :class:`AbstractMesh` of axis names and
sizes, which the sharding rules (``parallel.sharding``) accept as they
accept a ``DeviceMesh``.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["make_fft_mesh", "fft_mesh_shape", "make_host_mesh",
           "make_production_mesh", "AbstractMesh"]


class AbstractMesh:
    """A mesh by its axis names and sizes only, with no ranks or groups:
    ``axis_names`` and ``shape`` (name -> size, in axis order), as a JAX
    mesh gives them."""

    def __init__(self, sizes, names):
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for {len(names)} axes")
        self.axis_names = tuple(names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16 x 16 ``data x model`` (256 chips, one pod) or 2 x 16 x 16 ``pod x
    data x model`` (512 chips, two pods), as names and sizes."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def _device_type(device: str, owner: str) -> str:
    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device='cuda') but no CUDA device is available "
            "— pass device='cpu' for a mesh of CPU ranks")
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"{owner}'s device must be cuda or cpu, got "
                         f"{device!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            f"{owner} needs an initialised process group: start the "
            "ranks with torchrun, or call torch.distributed."
            "init_process_group with an address, world size and rank")
    return dev


def make_host_mesh(data: int = 1, model: int = 1, *, device: str = "cuda"):
    """A ``data x model`` mesh over the first ``data * model`` ranks of the
    process group. A request beyond the world size becomes ``(world, 1)``,
    as the reference's does beyond the host's devices."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = _device_type(device, "make_host_mesh")
    n = dist.get_world_size()
    if data * model > n:
        data, model = n, 1
    ranks = torch.arange(data * model).view(data, model)
    return DeviceMesh(dev, ranks, mesh_dim_names=("data", "model"))


def fft_mesh_shape(devices: int, shards: int | None = None,
                   data: int = 1) -> tuple[int, int]:
    """The ``(data, shards)`` that :func:`make_fft_mesh` builds over
    ``devices`` ranks: ``shards`` defaults to all of them over ``data``;
    a request beyond the ranks shrinks ``data`` first (batch parallelism
    costs throughput, not the pencil split), then ``shards`` rounds down
    to a power of two (spare ranks stay idle)."""
    if data < 1:
        raise ValueError(f"data axis size must be >= 1, got {data}")
    n = devices
    if shards is None:
        shards = max(1, n // data)
    while data > 1 and data * shards > n:
        data //= 2
    if data * shards > n:
        data, shards = 1, n
    # the pencil split needs a power-of-two shard count
    shards = 1 << (shards.bit_length() - 1)
    return data, shards


def make_fft_mesh(shards: int | None = None, data: int = 1, *,
                  device: str = "cuda"):
    """Mesh carrying the ``fft`` signal dimension for the sharded
    transform, over the first ``data * shards`` ranks of the process group.

    ``shards`` ranks along ``fft`` hold pencils of each signal (see
    ``core/fft/distributed.py``); a leading ``data`` dimension shards the
    batch of independent transforms — the 2-D batch x pencil composition
    every entry point auto-detects. Defaults to all ranks on ``fft``.
    Requests beyond the world size shrink as :func:`fft_mesh_shape` says.
    ``device`` is the mesh's device type: ``"cuda"`` (raises without a
    card) or ``"cpu"``.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = _device_type(device, "make_fft_mesh")
    data, shards = fft_mesh_shape(dist.get_world_size(), shards, data)
    ranks = torch.arange(data * shards)
    if data > 1:
        return DeviceMesh(dev, ranks.view(data, shards),
                          mesh_dim_names=("data", "fft"))
    return DeviceMesh(dev, ranks, mesh_dim_names=("fft",))
