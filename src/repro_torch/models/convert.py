"""Carry weights across: nested dicts of numpy arrays -> the port's params.

The reference's params are nested dicts of device arrays; turn each leaf
into a numpy array on the reference's side (``np.asarray``) and hand the
tree to :func:`params_from_numpy`, which keeps the nesting and the keys, so
the port's functional layers take them one to one.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]


def _tensor(a) -> torch.Tensor:
    """A tensor on a fresh copy of ``a`` (reference arrays are read-only)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, *, device, dtype=None):
    """Nested dicts / lists / tuples of numpy arrays -> the same structure
    of tensors on ``device``. ``dtype`` (a torch dtype), when given, is the
    type of every floating-point leaf; integer leaves keep theirs. The
    values are copied, never shared with the numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device=device, dtype=dtype)
                          for v in tree)
    t = _tensor(tree)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device=device)
