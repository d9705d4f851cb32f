"""Time the checked-GEMM kernel with each of its CTA tiles on one card.

    python -m repro_torch.kernels.ft_matmul_tiles [--iters 10]

At the two product shapes of Phi-4-mini 3.8B's MLP, (M, K, N) = (2048,
3072, 8192) and (2048, 8192, 3072), in float32 and bf16 x f32 at the first
shape, it prints one JSON line per case: each tile's CUDA-event time, its
CTAs per SM, its grid's waves and its cost under :func:`ft_matmul.cta_tile`,
the tile the wrapper picks, and the per-row-and-column cost that each
smaller tile's time gives against 128 x 128's (the data behind
:data:`ft_matmul.EDGE_COST`). The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from . import ft_matmul as ftk

SHAPES = (((2048, 3072, 8192), torch.float32),
          ((2048, 8192, 3072), torch.float32),
          ((2048, 3072, 8192), torch.bfloat16))


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def edge_fit(tile, ms, blocks, waves, ref) -> float:
    """The EDGE_COST ``c`` at which ``tile``'s issue time per CTA, over
    ``ref``'s (each an (tile, ms, blocks, waves) case at the same K), is
    (tm tn + c (tm + tn)) / (TM TN + c (TM + TN)): a wave of CTAs takes
    blocks x one CTA's issue time."""
    (tm, tn), (rm, rn) = tile, ref[0]
    r = (ms / (waves * blocks)) / (ref[1] / (ref[3] * ref[2]))
    return (r * rm * rn - tm * tn) / ((tm + tn) - r * (rm + rn))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (m, k, n), xdtype in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(m + 3 * k + 7 * n)
        x = torch.randn((m, k), device=dev, generator=gen).to(xdtype)
        w = torch.randn((k, n), device=dev, generator=gen) / math.sqrt(k)
        tiles = {}
        for tm in ftk.KERNEL_TILES[::-1]:
            for tn in ftk.KERNEL_TILES[::-1]:
                blocks = ftk.blocks_per_sm(x.dtype, w.dtype, tm, tn, dev)
                slots = sms * blocks
                waves = -(-(m // tm) * (n // tn) // slots)
                ms = _event_ms(lambda: ftk._launch(x, w, None, tm, tn),
                               args.iters)
                tiles[(tm, tn)] = dict(
                    ms=ms, blocks_per_sm=blocks, waves=waves,
                    cost=waves * slots * (tm * tn
                                          + ftk.EDGE_COST * (tm + tn)))
        ref = tiles[(128, 128)]
        ref = ((128, 128), ref["ms"], ref["blocks_per_sm"], ref["waves"])
        for t, row in tiles.items():
            if t != (128, 128):
                row["edge_fit"] = edge_fit(t, row["ms"], row["blocks_per_sm"],
                                           row["waves"], ref)
        picked = ftk.device_cta_tile(m, n, 128, 128, x.dtype, w.dtype, dev)
        print(json.dumps({
            "shape": [m, k, n], "x": str(xdtype).removeprefix("torch."),
            "w": "float32", "picked": list(picked),
            "fastest": list(min(tiles, key=lambda t: tiles[t]["ms"])),
            "tiles": {f"{tm}x{tn}": row for (tm, tn), row in tiles.items()},
        }), flush=True)
        del x, w
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
