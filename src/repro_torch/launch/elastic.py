"""Elastic restart: resume a run on a different rank count or mesh shape.
Port of ``repro.launch.elastic``.

Checkpoints are stored unsharded (``checkpoint/ckpt.py``), so elasticity
is a pure re-shard: build the new mesh, recompute the param specs against
it, and give each rank its slice of every restored leaf. A sharded run
saves through :func:`save_sharded`, which gathers every leaf
(``parallel.gather_tree``) and writes on the mesh's first rank. Combined
with the step-addressable data pipeline (``data/synthetic.py``) a job can
lose ranks, restart on fewer, and continue bit-deterministically on the
data stream.

The heartbeat monitor below is the straggler/failure detector: each host
reports its step's wall time; hosts over ``straggle_factor`` x the median
for ``patience`` steps are flagged for exclusion.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.parallel.sharding import (gather_tree, param_specs,
                                           shard_tree)
from repro_torch.tree import tree_map

__all__ = ["elastic_restore", "save_sharded", "HeartbeatMonitor"]


def _own(tree, specs, mesh):
    """This rank's slices of ``tree``, copied out of the whole leaves."""
    return tree_map(lambda t: t.contiguous().clone(),
                    shard_tree(tree, specs, mesh))


def elastic_restore(ckpt_dir: str, template, mesh, *, step=None,
                    fsdp: bool = True):
    """Restore a ``(params, AdamWState)``-shaped ``template`` onto
    ``mesh``: this rank's slice of every param leaf and of the moments
    ``mu``/``nu`` by the new mesh's ``param_specs``, the step counter
    whole. The template gives each leaf's dtype and device; the mesh the
    checkpoint was written under does not matter. Returns ``((params,
    opt_state), meta)``. Every rank of ``mesh`` calls it."""
    restored, meta = restore_checkpoint(ckpt_dir, template, step=step)
    params, opt = restored
    specs = param_specs(params, mesh, fsdp=fsdp)
    params = _own(params, specs, mesh)
    opt = type(opt)(step=opt.step, mu=_own(opt.mu, specs, mesh),
                    nu=_own(opt.nu, specs, mesh))
    return (params, opt), meta


def save_sharded(directory: str, step: int, state, specs, mesh,
                 extra: dict | None = None):
    """Save a sharded ``(params, AdamWState)`` unsharded: every rank of
    ``mesh`` gathers each leaf by ``specs`` (the param spec tree), the
    mesh's first rank writes. Returns the checkpoint's path there, None
    on the other ranks (which should wait on a barrier before reading
    it)."""
    params, opt = state
    whole = (gather_tree(params, specs, mesh),
             type(opt)(step=opt.step, mu=gather_tree(opt.mu, specs, mesh),
                       nu=gather_tree(opt.nu, specs, mesh)))
    first = int(mesh.mesh.reshape(-1)[0])
    if dist.get_rank() != first:
        return None
    return save_checkpoint(directory, step, whole, extra)


class HeartbeatMonitor:
    """Median-based straggler detection over per-host step times."""

    def __init__(self, num_hosts: int, straggle_factor: float = 2.0,
                 patience: int = 3):
        self.num_hosts = num_hosts
        self.factor = straggle_factor
        self.patience = patience
        self._strikes = np.zeros(num_hosts, dtype=int)

    def observe(self, step_times: np.ndarray) -> list[int]:
        """step_times: (num_hosts,) seconds. Returns hosts flagged for
        exclusion (persistent stragglers)."""
        med = float(np.median(step_times))
        slow = step_times > self.factor * max(med, 1e-9)
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return [int(i) for i in np.nonzero(
            self._strikes >= self.patience)[0]]
