"""How many kernels ``torch.profiler`` records for one ``plan.ft_fft`` and
one ``plan.fft`` call as the process ages, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.trace_age [--seconds 120]

Every few seconds it traces the same calls three ways: as they are, and
after a primer inside the trace (64 short ``torch.cuda._sleep`` kernels, a
synchronize and a 20 ms pause; the primer's kernels are left out of the
count). Each line is the process's age in seconds and, per trace,
(``abft_fft`` kernels, ``block_fft`` kernels, all kernels). A call
launches one ``abft_fft`` and one ``block_fft`` (``ft_fft``) or one
``block_fft`` (``fft``) every time: a smaller count is the tracer's.
"""
from __future__ import annotations

import argparse
import time

import torch

PRIMER = "spin_kernel"        # the kernel of torch.cuda._sleep


def prime() -> None:
    """Give a trace's first recorded kernels to a primer: 64 short
    ``torch.cuda._sleep`` kernels, then wait for them and 20 ms more."""
    for _ in range(64):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()
    time.sleep(0.02)


def traced_kernels(fn, primed: bool = False) -> list[str]:
    """The names of the CUDA kernels ``torch.profiler`` records while
    ``fn`` runs (after :func:`prime` when ``primed``, whose kernels are
    left out)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        if primed:
            prime()
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and PRIMER not in e.name]


def _counts(names) -> tuple[int, int, int]:
    return (sum("abft_fft" in n for n in names),
            sum("block_fft" in n for n in names), len(names))


def main(argv=None) -> None:
    from repro_torch.core.fft import FFTSpec, FTConfig, plan

    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--every", type=float, default=4.0)
    args = ap.parse_args(argv)
    t0 = time.time()
    x = torch.randn(256, 4096, dtype=torch.complex64, device="cuda")
    pf = plan(FFTSpec(shape=(256, 4096)))
    pt = plan(FFTSpec(shape=(256, 4096), ft=FTConfig()))
    pt.ft_fft(x)
    pf.fft(x)
    torch.cuda.synchronize()
    print("age_s ft_fft fft ft_fft_primed")
    while time.time() - t0 < args.seconds:
        rows = (_counts(traced_kernels(lambda: pt.ft_fft(x))),
                _counts(traced_kernels(lambda: pf.fft(x))),
                _counts(traced_kernels(lambda: pt.ft_fft(x), primed=True)))
        print(f"{time.time() - t0:.1f} " + " ".join(
            ",".join(map(str, r)) for r in rows), flush=True)
        time.sleep(args.every)


if __name__ == "__main__":
    main()
