"""Two-sided ABFT for GEMM — the paper's scheme off the DFT special case.

The paper derives its ABFT from the GEMV view of the DFT (§2.2.2): W is a
*fixed, known* matrix, so the left encoding ``e1^T W`` is free to precompute.
A neural-network linear layer is the same situation — W is the weight matrix,
X the activations. This module protects ``Y = X @ W`` for every dense layer
(threaded via ``models.layers.dense`` and the ``core.gemm`` plan family):

    detect:  per-column   (e2^T X) W  vs  e2^T Y   over the token axis,
    locate:  the location checksum e3 = [1..T]: d3/d2 at a corrupted
             column equals (row + 1) — the two-side scheme,
    correct: add d2 back at the decoded (row, column); k concurrent SEUs in
             k distinct columns are corrected in one pass, two faults in the
             SAME column decode as uncorrectable (non-integer ratio).

The same decode (:func:`decode_columns`) consumes the fused CUDA kernel's
checksum strips (``kernels.ft_matmul``), so the eager path and the fused
path agree on semantics by construction. Port of ``repro.core.abft.gemm``;
its products are ``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from .encoding import EPS

__all__ = ["ft_matmul", "ft_matmul_batched", "ft_dot_stats",
           "decode_columns", "inject_product"]

# |d3/d2 - round(d3/d2)| above this is a non-integer location decode:
# more than one fault landed in the column (or the checksum row itself was
# hit) — classified uncorrectable rather than mis-corrected.
_LOC_TOL = 0.25


def _loc_vec(n: int, device) -> torch.Tensor:
    return torch.arange(1, n + 1, dtype=torch.float32, device=device)


def decode_columns(y, d2, d3, scale, *, t: int, threshold: float,
                   with_correction: bool):
    """Two-side per-column decode shared by the eager and fused paths.

    ``d2 = pred2 - out2`` (== ``-eps`` at a corrupted column) and ``d3 =
    pred3 - out3`` are the (d_out,) checksum divergences; ``scale`` the
    output-checksum magnitude normalizer. Returns ``(y, stats)`` with 0-d
    float32 ``flagged`` (columns over threshold), ``corrected`` (columns
    with a valid single-fault location decode, applied when
    ``with_correction``), ``uncorrectable`` (flagged columns whose decode is
    non-integer or out of range — multi-SEU in one column), and ``score``
    (max per-column divergence, the detection statistic).

    Batched products (:func:`ft_matmul_batched`) decode every product at
    once: ``y`` (E, t, d_out), ``d2``/``d3`` (E, d_out), ``scale`` (E,),
    and each stat an (E,) vector.

    The correction is an indexed add into ``y`` IN PLACE (the reference's
    scatter-add returns a new array): every column gets one update, at its
    decoded row where valid and 0 elsewhere, so the indices are distinct.
    """
    colmag = d2.abs() / scale[..., None]
    score = colmag.amax(-1)
    hit = colmag > threshold
    ratio = d3 / torch.where(d2.abs() > 0, d2, torch.ones_like(d2))
    row_f = torch.round(ratio)
    valid = (hit & ((ratio - row_f).abs() < _LOC_TOL)
             & (row_f >= 1) & (row_f <= t))
    if with_correction:
        row_hat = torch.where(valid, row_f - 1, torch.zeros_like(row_f))
        cols = torch.arange(d2.shape[-1], device=d2.device).expand_as(d2)
        lead = ((torch.arange(d2.shape[0], device=d2.device)[:, None]
                 .expand_as(d2),) if d2.dim() == 2 else ())
        upd = torch.where(valid, d2, torch.zeros_like(d2)).to(y.dtype)
        y.index_put_((*lead, row_hat.long(), cols), upd, accumulate=True)
    f32 = torch.float32
    stats = {
        "flagged": hit.sum(-1, dtype=f32),
        "corrected": (valid.sum(-1, dtype=f32) if with_correction
                      else torch.zeros(d2.shape[:-1], dtype=f32,
                                       device=d2.device)),
        "uncorrectable": (hit & ~valid).sum(-1, dtype=f32),
        "score": score.to(f32),
    }
    return y, stats


def inject_product(y: torch.Tensor, rows, cols, eps) -> None:
    """Add ``eps[f]`` to ``y[rows[f], cols[f]]`` in place, for every
    descriptor whose (row, col) is an integer index inside ``y``, as the
    fused kernel compares them with each element's indices; others address
    no element (they add 0 at [0, 0]). Repeated indices add up."""
    m, n = y.shape
    ok = ((rows == torch.floor(rows)) & (cols == torch.floor(cols))
          & (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n))
    zero = torch.zeros_like(rows)
    y.index_put_((torch.where(ok, rows, zero).long(),
                  torch.where(ok, cols, zero).long()),
                 torch.where(ok, eps, zero).to(y.dtype), accumulate=True)


def _ft_matmul_2d(x, w, *, threshold, with_correction, inject=None):
    t = x.shape[0]
    xf = x.float()
    wf = w.float()
    loc = _loc_vec(t, x.device)

    # left-side input checksums over the token axis (rank-1 GEMVs)
    e2x = xf.sum(0)                        # e2^T X   (d_in,)
    e3x = loc @ xf                         # e3^T X   (d_in,)
    y = xf @ wf                            # float32 product
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        # under autograd the SEU and the correction below write a copy, so
        # the product autograd (or a selective checkpoint) holds stays as
        # computed; the gradient is the product's (the correction's terms
        # cancel: it restores the clean product)
        y = y.clone()
    if inject is not None:
        inj = torch.as_tensor(inject, dtype=torch.float32).to(x.device)
        inj = inj.reshape(-1, 3)           # (F, 3) rows of [row, col, eps]
        inject_product(y, inj[:, 0], inj[:, 1], inj[:, 2])
    # predicted output checksums vs the computed ones
    p2 = e2x @ wf                          # e2^T X W (d_out,)
    p3 = e3x @ wf
    o2 = y.sum(0)
    o3 = loc @ y
    d2 = p2 - o2                           # == -eps at the corrupted column
    d3 = p3 - o3
    scale = torch.sqrt(torch.mean(o2 * o2)) + EPS
    y, stats = decode_columns(y, d2, d3, scale, t=t, threshold=threshold,
                              with_correction=with_correction)
    return y.to(x.dtype), stats


def ft_matmul(x: torch.Tensor, w: torch.Tensor, *, threshold: float = 1e-3,
              with_correction: bool = True, inject=None):
    """Checked ``y = x @ w``: ``(T, d_in)`` or batched ``(B, T, d_in)``
    activations against a 2-D ``(d_in, d_out)`` weight.

    Returns ``(y, stats)`` — see :func:`decode_columns` for the stats
    contract. ``inject`` is an optional ``(3,)`` ``[row, col, eps]`` (or
    ``(F, 3)`` for concurrent SEUs) adding eps to ``y[row, col]`` *after*
    the product — simulating SEUs in the MAC units. On batched input the
    row indexes the flattened ``B * T`` token axis (the layout the checksums
    ride).

    The checksums ride in float32 regardless of the compute dtype (bf16
    accumulation noise would swamp detection otherwise).
    """
    if w.dim() != 2:
        raise ValueError(f"ft_matmul takes a 2-D (d_in, d_out) weight, "
                         f"got w.shape={tuple(w.shape)}")
    if x.dim() == 2:
        return _ft_matmul_2d(x, w, threshold=threshold,
                             with_correction=with_correction, inject=inject)
    if x.dim() == 3:
        b, t, k = x.shape
        y, stats = _ft_matmul_2d(x.reshape(b * t, k), w,
                                 threshold=threshold,
                                 with_correction=with_correction,
                                 inject=inject)
        return y.reshape(b, t, w.shape[-1]), stats
    raise ValueError(
        f"ft_matmul activations must be (T, d_in) or batched (B, T, d_in); "
        f"got rank-{x.dim()} x.shape={tuple(x.shape)} — reshape leading axes "
        f"into one batch dim first")


def ft_matmul_batched(x: torch.Tensor, w: torch.Tensor, *,
                      threshold: float = 1e-3, with_correction: bool = True,
                      inject=None):
    """Checked ``y[e] = x[e] @ w[e]`` for every ``e`` of ``(E, C, d_in)``
    activations against ``(E, d_in, d_out)`` weights, in batched products:
    what ``jax.vmap(ft_matmul)`` computes (the reference's MoE experts),
    each product with its own checksums over its ``C`` rows (the location
    vector ``1..C``), its own ``scale`` and :func:`decode_columns`' rule.

    The two input checksums ``e2ᵀX[e]`` and ``e3ᵀX[e]`` ride as two extra
    rows of each product's float32 X, so one batched product gives ``y``
    and the predicted strips and reads W once. ``inject`` is an optional
    ``(E, F, 3)`` ``[row, col, eps]`` (``(E, 3)`` for one fault an expert)
    adding eps to ``y[e, row, col]`` after the product, where the row and
    column address an element of that expert's ``(C, d_out)`` product.

    Returns ``(y, stats)``: ``y`` in ``x.dtype``, every stat an ``(E,)``
    float32 vector (``FTContext.summary`` reduces them).
    """
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"ft_matmul_batched takes (E, C, d_in) @ (E, d_in, "
                         f"d_out), got {tuple(x.shape)} @ {tuple(w.shape)}")
    e, t, _ = x.shape
    xf = x.float()
    wf = w.float()
    loc = _loc_vec(t, x.device)
    # [X; e2ᵀX; e3ᵀX] @ W: the product and both predicted strips
    ext = torch.cat([xf, xf.sum(1, keepdim=True),
                     torch.einsum("c,ecd->ed", loc, xf)[:, None]], dim=1)
    full = torch.bmm(ext, wf)
    y = full[:, :t]
    if inject is not None:
        inj = torch.as_tensor(inject, dtype=torch.float32).to(x.device)
        inj = inj.reshape(e, -1, 3)
        rows, cols, eps = inj.unbind(-1)
        ok = ((rows == torch.floor(rows)) & (cols == torch.floor(cols))
              & (rows >= 0) & (rows < t) & (cols >= 0) & (cols < w.shape[2]))
        zero = torch.zeros_like(rows)
        experts = torch.arange(e, device=x.device)[:, None].expand_as(rows)
        y.index_put_((experts, torch.where(ok, rows, zero).long(),
                      torch.where(ok, cols, zero).long()),
                     torch.where(ok, eps, zero), accumulate=True)
    o2 = y.sum(1)
    o3 = torch.einsum("c,ecf->ef", loc, y)
    d2 = full[:, t] - o2
    d3 = full[:, t + 1] - o3
    scale = torch.sqrt(torch.mean(o2 * o2, dim=-1)) + EPS
    y, stats = decode_columns(y, d2, d3, scale, t=t, threshold=threshold,
                              with_correction=with_correction)
    return y.to(x.dtype), stats


def ft_dot_stats(stats_tree) -> dict:
    """Aggregate a nested dict (or list/tuple) of per-layer ABFT-GEMM stats
    dicts into run-level counters, traversing by dict KEY (``flagged`` /
    ``corrected`` / ``score``) — robust to arbitrary nesting and to extra
    keys."""
    flagged, corrected, scores = [], [], []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, key)
        elif key == "flagged":
            flagged.append(torch.as_tensor(node).sum())
        elif key == "corrected":
            corrected.append(torch.as_tensor(node).sum())
        elif key == "score":
            scores.append(torch.as_tensor(node).max())

    walk(stats_tree)
    z = torch.zeros((), dtype=torch.float32)
    return {
        "ft_flagged": torch.stack(flagged).sum() if flagged else z,
        "ft_corrected": torch.stack(corrected).sum() if corrected else z,
        "ft_max_score": torch.stack(scores).max() if scores else z,
    }
