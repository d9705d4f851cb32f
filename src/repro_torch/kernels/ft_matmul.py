"""Kernel 3: the fused two-side ABFT GEMM (``csrc/ft_matmul.cu``).

Replaces ``repro.kernels.ft_matmul.ft_matmul_pallas``. While the kernel
computes ``C = X @ W`` tile by tile, it takes the *output* checksum strips
over the float32 accumulator —

    out2 = e2^T C   (column sums)          vs  pred2 = (e2^T X) @ W
    out3 = e3^T C   (e3 = [1..M] location) vs  pred3 = (e3^T X) @ W

— with the predicted strips from the small ``e2^T X`` / ``e3^T X`` vectors
that the wrapper computes with torch, as the reference does outside its
``pallas_call``. The caller decodes ``d2 = pred2 - out2`` / ``d3 = pred3 -
out3`` with :func:`repro_torch.core.abft.gemm.decode_columns`. An optional
``(F, 4)`` ``[row, col, enable, eps]`` SEU descriptor perturbs the product
inside the kernel *before* the strips are taken.

:func:`ft_matmul` runs the CUDA kernel on a CUDA tensor and its plain torch
version :func:`ft_matmul_plain` on a CPU tensor; any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.abft.gemm import inject_product

from . import _build

__all__ = ["FTMatmulChecks", "ft_matmul", "ft_matmul_plain", "KERNEL_TILES",
           "KERNEL_DTYPES", "check_kernel_tiles", "inject_rows"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ft_matmul_launch": (_P, _P, _I, _I, _P, _P, _P, _I, _P, _P,
                                    _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _P)}
# the CUDA kernel's tile rows/columns and its K stage; operand types
KERNEL_TILES = (64, 128)
K_STAGE = 32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class FTMatmulChecks(NamedTuple):
    """Product + the four fused checksum strips (each ``(N,)`` float32)."""

    c: torch.Tensor
    out2: torch.Tensor    # e2^T C   — fused output column sums
    pred2: torch.Tensor   # (e2^T X) @ W
    out3: torch.Tensor    # e3^T C   — fused location checksum, e3 = [1..M]
    pred3: torch.Tensor   # (e3^T X) @ W


def inject_rows(inject, device) -> torch.Tensor:
    """``None`` / ``(4,)`` / ``(F, 4)`` -> contiguous ``(F, 4)`` float32 on
    ``device`` (one disabled all-zeros row when None, so both cases run one
    program)."""
    if inject is None:
        return torch.zeros((1, 4), dtype=torch.float32, device=device)
    inj = torch.as_tensor(inject, dtype=torch.float32)
    return inj.to(device).reshape(-1, 4).contiguous()


def _input_checksums(x: torch.Tensor):
    """``(e3, e2^T X, e3^T X)`` in float32, e3 = [1..M]."""
    xf = x.float()
    loc = torch.arange(1, x.shape[0] + 1, dtype=torch.float32,
                       device=x.device)
    return loc, xf.sum(0), loc @ xf


def ft_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                    inject=None) -> FTMatmulChecks:
    """Plain torch version of the kernel: the same five outputs. The product
    accumulates in float32; ``c`` is stored in ``x.dtype``; the strips are
    taken over the float32 product after the injected SEUs."""
    inj = inject_rows(inject, x.device)
    loc, xsum, xloc = _input_checksums(x)
    wf = w.float()
    acc = x.float() @ wf
    inject_product(acc, inj[:, 0], inj[:, 1], inj[:, 2] * inj[:, 3])
    return FTMatmulChecks(acc.to(x.dtype), acc.sum(0), xsum @ wf, loc @ acc,
                          xloc @ wf)


def check_kernel_tiles(bm: int, bn: int, bk: int) -> None:
    """Raise ``ValueError`` unless the CUDA kernel takes these tiles: bm and
    bn in :data:`KERNEL_TILES`, bk a multiple of its K stage."""
    if bm not in KERNEL_TILES or bn not in KERNEL_TILES or bk % K_STAGE:
        raise ValueError(
            f"the CUDA ft_matmul kernel takes bm, bn in {KERNEL_TILES} and "
            f"bk a multiple of {K_STAGE}, got (bm, bk, bn)=({bm}, {bk}, "
            f"{bn})")


def ft_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
              bn: int = 128, bk: int = 128, inject=None) -> FTMatmulChecks:
    """Fused product + two-side checksum strips (:class:`FTMatmulChecks`).

    x: (M, K), w: (K, N), each float32 or bfloat16 on the kernel's path.
    Dims must be multiples of the tile sizes (the ``core.gemm`` plan layer
    takes the eager path otherwise). ``inject`` is an optional ``(4,)``
    ``[row, col, enable, eps]`` descriptor — or ``(F, 4)`` for concurrent
    SEUs — applied to the computed product inside the kernel. CUDA tensors
    launch the kernel (``ft_matmul.launches`` counts the launches); CPU
    tensors run :func:`ft_matmul_plain`.
    """
    m, k = x.shape
    k2, n = w.shape
    if k2 != k:
        raise ValueError(f"contraction mismatch: x (M={m}, K={k}) vs "
                         f"w (K={k2}, N={n})")
    if m % bm or n % bn or k % bk:
        raise ValueError(
            f"fused ABFT GEMM needs tile-aligned dims: (M, K, N)="
            f"({m}, {k}, {n}) vs tiles (bm, bk, bn)=({bm}, {bk}, {bn}) — "
            f"pad the operands or use the eager path "
            f"(core.abft.gemm.ft_matmul)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ft_matmul_plain(x, w, inject=inject)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"ft_matmul runs on cuda (kernel) or cpu (plain "
                         f"version), with both operands on one device; got "
                         f"x on {x.device}, w on {w.device}")
    check_kernel_tiles(bm, bn, bk)
    if x.dtype not in KERNEL_DTYPES or w.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA ft_matmul kernel takes float32/bfloat16 "
                        f"operands, got x {x.dtype}, w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA ft_matmul kernel takes contiguous "
                         "row-major operands")
    if m // bm > 65535:
        raise ValueError(f"M={m} gives {m // bm} row tiles, more than the "
                         f"65535 a grid column holds")
    inj = inject_rows(inject, x.device)
    _, xsum, xloc = _input_checksums(x)
    c = torch.empty((m, n), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    strips = torch.empty((4, n), **f32)          # out2, pred2, out3, pred3
    parts = torch.empty((2, m // bm, n), **f32)  # per row tile out2, out3
    lib = _build.load("ft_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ft_matmul_launch(
            x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16), xsum.data_ptr(),
            xloc.data_ptr(), inj.data_ptr(), inj.shape[0], c.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), strips[0].data_ptr(),
            strips[1].data_ptr(), strips[2].data_ptr(),
            strips[3].data_ptr(), m, k, n, bm, bn, stream)
    if err != 0:
        raise RuntimeError(f"ft_matmul launch failed: CUDA error {err}")
    ft_matmul.launches += 1
    return FTMatmulChecks(c, strips[0], strips[1], strips[2], strips[3])


ft_matmul.launches = 0
