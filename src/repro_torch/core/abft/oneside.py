"""One-sided / offline FT-FFT baseline (paper §2.2.3, Fig. 6 red region).

The closest prior work (Pilla et al. offline FT-FFT): a *per-signal* left
checksum computed by separate passes around a library FFT, with
time-redundant recomputation on error. This doubles memory transactions
(the checksum pass re-reads all data) — the paper measures ~30-300% overhead
for the offline scheme vs 7-15% for the fused two-sided scheme. Port of
``repro.core.abft.oneside``; the baseline of the ABFT ladder.
"""
from __future__ import annotations

from typing import Callable

import torch

from .encoding import EPS, left_encoding, left_encoding_image

__all__ = ["oneside_fft"]


def oneside_fft(
    x: torch.Tensor,
    *,
    threshold: float = 1e-4,
    encoding: str = "wang",
    fft_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    corrupt: Callable[[torch.Tensor], torch.Tensor] | None = None,
):
    """Offline one-sided FT-FFT: checksum pass -> FFT -> verify -> recompute.

    ``fft_fn`` defaults to ``repro_torch.core.fft.fft``; ``corrupt``
    optionally injects an error into the FFT output (test hook). Returns
    (y, flags, recomputed_count).
    """
    if fft_fn is None:
        from repro_torch.core.fft import fft as fft_fn
    n = x.shape[-1]
    ew = torch.as_tensor(left_encoding_image(n, encoding)).to(
        dtype=x.dtype, device=x.device)
    e1 = torch.as_tensor(left_encoding(n, encoding)).to(
        dtype=x.dtype, device=x.device)

    # pass 1 (extra memory transaction): per-signal input checksums
    s_in = x @ ew
    # pass 2: the FFT itself
    y = fft_fn(x)
    if corrupt is not None:
        y = corrupt(y)
    # pass 3 (extra memory transaction): per-signal output checksums
    s_out = y @ e1
    score = (s_in - s_out).abs() / (s_in.abs() + EPS)
    flags = score > threshold
    # time-redundant recomputation of flagged signals (one-sided
    # correction): recompute the whole batch masked — the offline scheme's
    # "revert to a saved state and recalculate" cost model.
    y_re = fft_fn(x)
    y = torch.where(flags[..., None], y_re, y)
    return y, flags, flags.sum()
