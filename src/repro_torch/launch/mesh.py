"""The device mesh of the sharded FFT.

``make_fft_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` over the
ranks of the initialised process group (``torchrun``, or
``dist.init_process_group`` with an address, world size and rank); every
rank calls it. The LM meshes of the reference (``make_production_mesh``,
``make_host_mesh``) go with ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["make_fft_mesh", "fft_mesh_shape"]


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

    dev = torch.device(device).type
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_fft_mesh(device='cuda') but no CUDA device is available "
            "— pass device='cpu' for a mesh of CPU ranks")
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"make_fft_mesh's device must be cuda or cpu, got "
                         f"{device!r}")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_fft_mesh needs an initialised process group: start the "
            "ranks with torchrun, or call torch.distributed."
            "init_process_group with an address, world size and rank")
    data, shards = fft_mesh_shape(dist.get_world_size(), shards, data)
    ranks = torch.arange(data * shards)
    if data > 1:
        return DeviceMesh(dev, ranks.view(data, shards),
                          mesh_dim_names=("data", "fft"))
    return DeviceMesh(dev, ranks, mesh_dim_names=("fft",))
