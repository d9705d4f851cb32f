"""Kernel 3: the fused two-side ABFT GEMM (``csrc/ft_matmul.cu``).

Replaces ``repro.kernels.ft_matmul.ft_matmul_pallas``. While the kernel
computes ``C = X @ W`` tile by tile, it takes the *output* checksum strips
over the float32 accumulator —

    out2 = e2^T C   (column sums)          vs  pred2 = (e2^T X) @ W
    out3 = e3^T C   (e3 = [1..M] location) vs  pred3 = (e3^T X) @ W

— with the predicted strips from the small input checksums ``e2^T X`` /
``e3^T X``, which the kernel's first pass computes (the reference computes
them with jnp outside its ``pallas_call``). The caller decodes ``d2 = pred2
- out2`` / ``d3 = pred3 - out3`` with
:func:`repro_torch.core.abft.gemm.decode_columns`. An optional ``(F, 4)``
``[row, col, enable, eps]`` SEU descriptor perturbs the product
inside the kernel *before* the strips are taken.

:func:`ft_matmul` runs the CUDA kernel on a CUDA tensor and its plain torch
version :func:`ft_matmul_plain` on a CPU tensor; any other device raises.
The kernel picks its CTA tile per launch (:func:`cta_tile`); the caller's
``(bm, bn, bk)`` only constrain alignment, and the outputs are the same, bit
for bit, whichever tile runs (``python -m
repro_torch.kernels.ft_matmul_tiles`` times each tile on the card).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.core.abft.gemm import inject_product

from . import _build

__all__ = ["FTMatmulChecks", "ft_matmul", "ft_matmul_plain", "KERNEL_TILES",
           "KERNEL_DTYPES", "check_kernel_tiles", "inject_rows", "cta_tile",
           "device_cta_tile", "smem_bytes", "blocks_per_sm", "EDGE_COST"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ft_matmul_launch": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "ft_matmul_occupancy": (_I, _I, _I, _I, _I, ctypes.POINTER(_I)),
}
# the CUDA kernel's tile rows/columns (the caller's bm, bn and the CTA tile
# it runs), the multiple bk must be (alignment only), and operand types
KERNEL_TILES = (64, 128)
BK_MULTIPLE = 32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# csrc/ft_matmul.cu's own layout: K stage, ring stages, A-row padding, rows
# of one strip partial
STAGE, STAGES, A_PAD, STRIP_ROWS = 16, 3, 4, 64
# what a CTA's K step costs per row and per column of its tile, in FMAs of
# one output: the fragment reads and stage copies that feed the FMAs, whose
# share grows as the tile shrinks. Fitted to the kernel's per-tile times
# (``ft_matmul_tiles``; H100 80GB HBM3, 700 W): 17 to 23 from 128 x 64 and
# 64 x 128 against 128 x 128, 41 to 46 from 64 x 64
EDGE_COST = 32


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
    bn in :data:`KERNEL_TILES`, bk a multiple of :data:`BK_MULTIPLE`."""
    if bm not in KERNEL_TILES or bn not in KERNEL_TILES or bk % BK_MULTIPLE:
        raise ValueError(
            f"the CUDA ft_matmul kernel takes bm, bn in {KERNEL_TILES} and "
            f"bk a multiple of {BK_MULTIPLE}, got (bm, bk, bn)=({bm}, {bk}, "
            f"{bn})")


def smem_bytes(tm: int, tn: int) -> int:
    """Dynamic shared memory of one (tm, tn) CTA: the ring of
    :data:`STAGES` stages, each the transposed X slice (rows padded by
    :data:`A_PAD`), the W slice and xsum/xloc; the strip reduction after the
    K loop reuses it."""
    ring = STAGES * (STAGE * (tm + A_PAD) + STAGE * tn + 2 * STAGE)
    red = 2 * (tm // STRIP_ROWS) * 16 * tn
    return 4 * max(ring, red)


def cta_tile(m: int, n: int, bm: int, bn: int,
             slots: Callable[[int, int], int]) -> tuple[int, int]:
    """The CTA tile ``(tm, tn)`` of an (M, N) product whose dims the caller
    aligned to ``(bm, bn)``: among the kernel's tiles that divide M and N,
    the one that reserves the least SM time, counted as waves x slots x
    (tm tn + :data:`EDGE_COST` (tm + tn)), where ``slots(tm, tn)`` is how
    many such CTAs the device runs at once (SMs x blocks per SM). A last
    wave that runs nearly empty costs a tile as much as a full one, and a
    small tile pays more per output for the loads that feed it; ties go to
    the taller tile."""
    if m % bm or n % bn:
        raise ValueError(f"(M, N)=({m}, {n}) is not aligned to (bm, bn)="
                         f"({bm}, {bn})")
    best, best_cost = None, None
    for tm in sorted(KERNEL_TILES, reverse=True):
        for tn in sorted(KERNEL_TILES, reverse=True):
            if m % tm or n % tn:
                continue
            s = max(slots(tm, tn), 1)
            ctas = (m // tm) * (n // tn)
            cost = -(-ctas // s) * s * (tm * tn + EDGE_COST * (tm + tn))
            if best_cost is None or cost < best_cost:
                best, best_cost = (tm, tn), cost
    return best


def _flags(x_dtype, w_dtype) -> tuple[int, int]:
    return int(x_dtype == torch.bfloat16), int(w_dtype == torch.bfloat16)


@functools.lru_cache(maxsize=None)
def blocks_per_sm(x_dtype: torch.dtype, w_dtype: torch.dtype, tm: int,
                  tn: int, device="cuda") -> int:
    """CTAs of the (x_dtype, w_dtype, tm, tn) kernel instance that one SM of
    ``device`` runs at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    with the instance's registers and shared memory)."""
    lib = _build.load("ft_matmul", _SIGNATURES)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ft_matmul_occupancy(*_flags(x_dtype, w_dtype), tm, tn,
                                      smem_bytes(tm, tn),
                                      ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"ft_matmul occupancy query failed: CUDA error "
                           f"{err}")
    return blocks.value


@functools.lru_cache(maxsize=None)
def device_cta_tile(m: int, n: int, bm: int, bn: int, x_dtype: torch.dtype,
                    w_dtype: torch.dtype, device="cuda") -> tuple[int, int]:
    """The CTA tile :func:`ft_matmul` runs on ``device``: :func:`cta_tile`
    with its SM count and each instance's :func:`blocks_per_sm`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cta_tile(m, n, bm, bn, lambda tm, tn: sms * blocks_per_sm(
        x_dtype, w_dtype, tm, tn, device))


def ft_matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int = 128,
              bn: int = 128, bk: int = 128, inject=None) -> FTMatmulChecks:
    """Fused product + two-side checksum strips (:class:`FTMatmulChecks`).

    x: (M, K), w: (K, N), each float32 or bfloat16 on the kernel's path.
    Dims must be multiples of the tile sizes (the ``core.gemm`` plan layer
    pads M with zero rows). ``bm``, ``bn`` and ``bk`` constrain
    alignment only: the kernel runs its own K stage (16) and picks its CTA
    tile with :func:`device_cta_tile`; the outputs do not depend on the
    tile. ``inject`` is an optional ``(4,)`` ``[row, col, enable,
    eps]`` descriptor — or ``(F, 4)`` for concurrent SEUs — applied to the
    computed product inside the kernel. CUDA tensors launch the kernel
    (``ft_matmul.launches`` counts the launches); CPU tensors run
    :func:`ft_matmul_plain`.
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
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the CUDA ft_matmul kernel takes 16-byte aligned "
                         "operands")
    if m // STRIP_ROWS > 65535:
        raise ValueError(f"M={m} gives {m // STRIP_ROWS} row groups, more "
                         f"than the 65535 a grid column holds")
    tm, tn = device_cta_tile(m, n, bm, bn, x.dtype, w.dtype, x.device)
    return _launch(x, w, inject, tm, tn)


def _launch(x: torch.Tensor, w: torch.Tensor, inject, tm: int,
            tn: int) -> FTMatmulChecks:
    """Launch the kernel with CTA tile ``(tm, tn)`` on operands that
    :func:`ft_matmul` has checked; ``tm`` and ``tn`` divide M and N."""
    m, k = x.shape
    n = w.shape[1]
    inj = inject_rows(inject, x.device)
    c = torch.empty((m, n), dtype=x.dtype, device=x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    strips = torch.empty((4, n), **f32)          # out2, pred2, out3, pred3
    xsums = torch.empty((2, k), **f32)           # e2^T X, e3^T X
    # per 64 rows: out2, out3 partials and the input checksums' partials
    parts = torch.empty((2, m // STRIP_ROWS, n), **f32)
    xparts = torch.empty((2, m // STRIP_ROWS, k), **f32)
    lib = _build.load("ft_matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ft_matmul_launch(
            x.data_ptr(), w.data_ptr(), *_flags(x.dtype, w.dtype),
            xsums[0].data_ptr(), xsums[1].data_ptr(), xparts.data_ptr(),
            inj.data_ptr(), inj.shape[0], c.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), strips[0].data_ptr(),
            strips[1].data_ptr(), strips[2].data_ptr(),
            strips[3].data_ptr(), m, k, n, tm, tn, smem_bytes(tm, tn),
            stream)
    if err != 0:
        raise RuntimeError(f"ft_matmul launch failed: CUDA error {err}")
    ft_matmul.launches += 1
    return FTMatmulChecks(c, strips[0], strips[1], strips[2], strips[3])


ft_matmul.launches = 0
