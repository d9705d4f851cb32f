#!/usr/bin/env python3
"""Drive the port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds both kernels from ``src/repro_torch/kernels/csrc`` with nvcc, runs the
local rank-1 fft / ifft / ft_fft path through ``plan(FFTSpec(...))`` at the
sizes of ``turbofft_bench.CONFIG``'s corners (every case far beyond the 50 MB
L2), checks every result against ``torch.fft`` at the suite's tolerance
(ATOL * max|ref|: 4e-5 complex64, 1e-11 complex128) and runs an SEU campaign
through the fused ABFT kernel. It then holds each kernel against its plain
torch version on the card at the main path's shapes and times kernel, plain
version and ``torch.fft`` with CUDA events. The last two lines are the
``kernels`` JSON and ``{"ok": true, "device": ...}``. Any failed check raises
and exits non-zero; without a CUDA device it exits 1 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
ATOL = {"complex64": 4e-5, "complex128": 1e-11}
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM data sheet
PEAK_FLOPS = {"complex64": 67e12,          # fp32 outside the tensor cores
              "complex128": 34e12}         # fp64 outside the tensor cores
# (dtype, log2 N, batch): single pass, two passes, three passes, fp64
FFT_CASES = (("complex64", 13, 1024), ("complex64", 20, 256),
             ("complex64", 25, 8), ("complex128", 13, 1024))
FT_CASES = (("complex64", 13, 1024), ("complex128", 13, 1024))
FT_TRANSACTIONS = 4
SEU_STEPS = 8


ABFT_PARTS = ("y", "delta", "X.e2", "X.e3", "Y.e2", "Y.e3")


def delta_noise(delta_clean):
    """The roundoff scale of a clean call's per-signal divergence: 4x its
    largest value in the plain version (all zeros without per-signal
    checksums: then the dtype's epsilon, so the kernel must write ~0)."""
    import torch
    eps = torch.finfo(delta_clean.dtype).eps
    return 4.0 * max(delta_clean.abs().max().item(), eps)


def abft_vs_plain(got, want, dtype, noise, what):
    """Hold the fused kernel's ``(y, delta, cs)`` against its plain version
    part by part; returns ``{part: (max abs err, err / tol)}``.

    y: ATOL * max|y|. Each checksum row [X.e2, X.e3, Y.e2, Y.e3] of each
    group g: ATOL * max_n |row[g]| -- per row, because the e3 rows grow
    with the 1-based signal id and one tolerance over all of them would
    hide a wrong small row. delta, elementwise: 1e-3 * |plain| (the
    injected signal's divergence is large) plus ``noise``, the roundoff
    scale of clean signals.
    """
    y, delta, cs = got
    yp, dp, csp = want
    out = {}

    def hold(part, err, tol):
        ratio = (err / tol).max().item()
        out[part] = (err.max().item(), ratio)
        check(ratio <= 1.0, f"{what} {part}: err {err.max().item()} "
                            f"(worst {ratio:.3g} x tol)")

    hold("y", (y - yp).abs().max(), ATOL[dtype] * yp.abs().max())
    for j, part in enumerate(ABFT_PARTS[2:]):
        hold(part, (cs[j] - csp[j]).abs().amax(-1),
             ATOL[dtype] * csp[j].abs().amax(-1))
    hold("delta", (delta - dp).abs(), 1e-3 * dp.abs() + noise)
    return {k: out[k] for k in ABFT_PARTS}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg):
    print(msg, flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core.fft import FFTSpec, FTConfig, plan
    from repro_torch.core.ft import poisson_schedule
    from repro_torch.kernels import _build
    from repro_torch.kernels.stockham import block_fft, block_fft_plain
    from repro_torch.kernels.stockham_abft import abft_fft, abft_fft_plain

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count} | {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    times = _build.build()
    log(f"nvcc: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"({time.perf_counter() - t0:.1f} s wall)")
    for kname in _build.KERNELS:
        build_log = _build.library_path(kname).with_suffix(".log")
        for line in build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {kname}: {line.strip()}")

    gen = torch.Generator(device=dev)

    def randn(shape, dtype_name):
        gen.manual_seed(SEED + sum(shape))
        return torch.randn(shape, dtype=getattr(torch, dtype_name),
                           device=dev, generator=gen)

    def max_err(got, want):
        return (got - want).abs().max().item()

    def cuda_ms(fn, iters=20, warmup=3):
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

    # ---- phases 2 and 3: the main path, launch counts from this run only
    block_fft.launches = 0
    abft_fft.launches = 0
    path_rows = []
    per_call = {"block_fft": {}, "abft_fft": {}}   # launches of one call

    def count_call(label, fn):
        before = (block_fft.launches, abft_fft.launches)
        out = fn()
        per_call["block_fft"][label] = block_fft.launches - before[0]
        per_call["abft_fft"][label] = abft_fft.launches - before[1]
        return out

    for dtype, logn, b in FFT_CASES:
        n = 1 << logn
        x = randn((b, n), dtype)
        p = plan(FFTSpec(shape=(b, n), dtype=dtype))
        label = f"plan.fft {dtype} 2^{logn}x{b}"
        y = count_call(label, lambda: p.fft(x))
        check(per_call["block_fft"][label] == p.local_plan.num_passes,
              f"{label}: {per_call['block_fft'][label]} block_fft launches "
              f"for {p.local_plan.num_passes} passes")
        ref = torch.fft.fft(x)
        err, tol = max_err(y, ref), ATOL[dtype] * ref.abs().max().item()
        check(err <= tol, f"fft {dtype} N=2^{logn} B={b}: {err} > {tol}")
        del y, ref
        yi = p.ifft(x)
        ref = torch.fft.ifft(x)
        erri, toli = max_err(yi, ref), ATOL[dtype] * ref.abs().max().item()
        check(erri <= toli,
              f"ifft {dtype} N=2^{logn} B={b}: {erri} > {toli}")
        del yi, ref
        log(f"fft/ifft {dtype} N=2^{logn} B={b} passes="
            f"{p.local_plan.num_passes} ({p.local_plan.describe()}): "
            f"err {err:.3e}/{erri:.3e} tol {tol:.3e}/{toli:.3e}")
        path_rows.append((dtype, logn, b, p, x))

    seu = {"injected": 0, "detected": 0, "located": 0, "corrected": 0,
           "false_alarms": 0}
    rng = np.random.default_rng(SEED)
    for dtype, logn, b in FT_CASES:
        n = 1 << logn
        x = randn((b, n), dtype)
        p = plan(FFTSpec(shape=(b, n), dtype=dtype,
                         ft=FTConfig(transactions=FT_TRANSACTIONS)))
        ref = torch.fft.fft(x)
        tol = ATOL[dtype] * ref.abs().max().item()
        label = f"plan.ft_fft {dtype} 2^{logn}x{b}"
        res = count_call(label, lambda: p.ft_fft(x))
        check(per_call["abft_fft"][label] == 1
              and per_call["block_fft"][label] == 2,
              f"{label}: launches {per_call}")
        clean_err = max_err(res.y, ref)
        check(clean_err <= tol, f"ft_fft clean {dtype}: {clean_err} > {tol}")
        check(int(res.flagged.sum()) == 0, f"ft_fft clean {dtype}: flagged")
        bs = min(p.local_plan.bs, b)
        sched = poisson_schedule(rng, steps=SEU_STEPS, rate_per_step=0.8,
                                 tiles=b // bs, bs=bs, n=n)
        for step in range(SEU_STEPS):
            inj = sched.for_step(step)
            res = p.ft_fft(x, inject=inj)
            flagged = res.flagged.cpu().numpy()
            if float(inj[3]) > 0:
                seu["injected"] += 1
                seu["detected"] += int(flagged.sum() == 1)
                want_sig = int(inj[0]) * bs + int(inj[1])
                seu["located"] += int(flagged.sum() == 1 and int(
                    res.location.cpu().numpy()[flagged][0]) == want_sig)
                seu["corrected"] += int(res.corrected)
            else:
                seu["false_alarms"] += int(flagged.sum())
            err = max_err(res.y, ref)
            check(err <= tol, f"ft_fft {dtype} step {step}: post-correction "
                              f"error {err} > {tol}")
        log(f"ft_fft {dtype} N=2^{logn} B={b} T={FT_TRANSACTIONS} bs={bs} "
            f"G={b // (bs * FT_TRANSACTIONS)}: clean err {clean_err:.3e} tol "
            f"{tol:.3e}; schedule {sched.num_faults} faults")
        del ref, res
        path_rows.append((dtype, logn, b, p, x))
    torch.cuda.synchronize()
    launches = {"block_fft": block_fft.launches,
                "abft_fft": abft_fft.launches}
    log(f"main-path launches per call: {json.dumps(per_call)}")
    log(f"main-path launches, whole run: {json.dumps(launches)}; SEU "
        f"campaign {json.dumps(seu)}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was never launched: {launches}")
    check(seu["injected"] > 0 and seu["injected"] == seu["detected"]
          == seu["located"] == seu["corrected"] and seu["false_alarms"] == 0,
          f"SEU campaign: {seu}")

    # ---- phase 4: each kernel against its plain version on the card, with
    # the plan's own stages and device tables
    kerr = {"block_fft": 0.0, "abft_fft": 0.0}
    kratio = {"block_fft": 0.0, "abft_fft": 0.0}   # worst err / tolerance
    seen = set()
    for dtype, logn, b, p, _ in path_rows:
        pl = p.local_plan
        if p.spec.ft is not None:     # the checksum FFT on (G, N)
            shapes = [(0, b // (min(pl.bs, b) * FT_TRANSACTIONS), False)]
        else:
            shapes = [(i, b * pl.n // pl.kernel_factors[i], inverse)
                      for i in range(pl.num_passes)
                      for inverse in (False, True)]
        for i, rows, inverse in shapes:
            f, stages = pl.kernel_factors[i], pl.stages[i]
            tables = p.tables[inverse][i]
            key = (dtype, f, rows, inverse)
            if key in seen:
                continue
            seen.add(key)
            x = randn((rows, f), dtype)
            scale = 1.0 / f if inverse else 1.0
            got = block_fft(x, stages, inverse=inverse, scale=scale,
                            tables=tables)
            want = block_fft_plain(x, stages, inverse=inverse,
                                   scale=scale)
            err = max_err(got, want)
            tol = ATOL[dtype] * want.abs().max().item()
            check(err <= tol, f"block_fft vs plain {key}: {err} > {tol}")
            kerr["block_fft"] = max(kerr["block_fft"], err)
            kratio["block_fft"] = max(kratio["block_fft"], err / tol)
            ms = cuda_ms(lambda: block_fft(x, stages, inverse=inverse,
                                           scale=scale, tables=tables),
                         iters=5, warmup=1)
            gbps = 2 * x.numel() * x.element_size() / ms / 1e6
            log(f"block_fft {dtype} ({rows}, {f}) inverse={inverse}: "
                f"{ms:.4f} ms, {gbps:.1f} GB/s; err {err:.3e} tol {tol:.3e}")
            del x, got, want
    abft_parts = dict.fromkeys(ABFT_PARTS, 0.0)
    for dtype, logn, b in FT_CASES:
        n = 1 << logn
        p = plan(FFTSpec(shape=(b, n), dtype=dtype,
                         ft=FTConfig(transactions=FT_TRANSACTIONS)))
        stages, bs = p.local_plan.stages[0], min(p.local_plan.bs, b)
        tables = p.tables[False][0]
        x = randn((b, n), dtype)
        inj = torch.tensor([b // bs - 1, bs - 1, n // 3, 1, 25.0, -40.0])
        for per_signal in (False, True):
            kw = dict(bs=bs, transactions=FT_TRANSACTIONS,
                      per_signal=per_signal)
            noise = None
            for inject in (None, inj):
                got = abft_fft(x, stages, inject=inject, tables=tables, **kw)
                want = abft_fft_plain(x, stages, inject=inject, **kw)
                if noise is None:     # the clean call comes first
                    noise = delta_noise(want[1])
                what = (f"abft_fft vs plain {dtype} per_signal={per_signal} "
                        f"inject={inject is not None}")
                parts = abft_vs_plain(got, want, dtype, noise, what)
                for part, (err, ratio) in parts.items():
                    abft_parts[part] = max(abft_parts[part], err)
                    kratio["abft_fft"] = max(kratio["abft_fft"], ratio)
                log(f"{what}: " + ", ".join(
                    f"{k} {e:.3e} ({r:.2f} of tol)"
                    for k, (e, r) in parts.items()))
            ms = cuda_ms(lambda: abft_fft(x, stages, tables=tables, **kw),
                         iters=5, warmup=1)
            log(f"abft_fft {dtype} ({b}, {n}) bs={bs} T={FT_TRANSACTIONS} "
                f"per_signal={per_signal}: {ms:.4f} ms")
        del x, got, want
    kerr["abft_fft"] = max(abft_parts.values())
    log(f"kernel vs plain max abs err: {json.dumps(kerr)}; abft_fft by "
        f"part: {json.dumps(abft_parts)}; worst err/tol: "
        f"{json.dumps(kratio)}")

    # ---- phase 5: times by CUDA events at the single-pass main-path shape
    dtype, logn, b = FFT_CASES[0]
    n = 1 << logn
    x = randn((b, n), dtype)
    itemsize = x.element_size()
    p_fft = plan(FFTSpec(shape=(b, n), dtype=dtype))
    p_ft = plan(FFTSpec(shape=(b, n), dtype=dtype,
                        ft=FTConfig(transactions=FT_TRANSACTIONS)))
    stages, tables = p_ft.local_plan.stages[0], p_ft.tables[False][0]
    bs = min(p_ft.local_plan.bs, b)
    groups = b // (bs * FT_TRANSACTIONS)
    fft_bytes = 2 * b * n * itemsize
    fft_flops = 5 * n * logn * b

    def bound(nbytes, flops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = flops / PEAK_FLOPS[dtype] * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    blk_ms = cuda_ms(lambda: block_fft(x, stages, tables=tables))
    blk_plain = cuda_ms(lambda: block_fft_plain(x, stages), iters=5)
    lib_ms = cuda_ms(lambda: torch.fft.fft(x))
    abft_kw = dict(bs=bs, transactions=FT_TRANSACTIONS, per_signal=False)
    abft_ms = cuda_ms(lambda: abft_fft(x, stages, tables=tables, **abft_kw))
    abft_plain = cuda_ms(lambda: abft_fft_plain(x, stages, **abft_kw),
                         iters=5)
    blk_bound = bound(fft_bytes, fft_flops)
    abft_bound = bound(fft_bytes + 4 * groups * n * itemsize
                       + b * itemsize // 2, fft_flops + 12 * b * n)
    path_fft_ms = cuda_ms(lambda: p_fft.fft(x))
    path_ft_ms = cuda_ms(lambda: p_ft.ft_fft(x))
    log(f"times at {dtype} N=2^{logn} B={b} (bs={bs}, T={FT_TRANSACTIONS}, "
        f"G={groups}): block_fft {blk_ms:.4f} ms, abft_fft {abft_ms:.4f} ms "
        f"(kernel overhead {abft_ms / blk_ms - 1:+.1%}), torch.fft "
        f"{lib_ms:.4f} ms; plan.fft {path_fft_ms:.4f} ms, plan.ft_fft "
        f"{path_ft_ms:.4f} ms (end-to-end overhead "
        f"{path_ft_ms / path_fft_ms - 1:+.1%})")
    del x
    for dtype_c, logn_c, b_c, p, xc in path_rows[:len(FFT_CASES)]:
        port = cuda_ms(lambda: p.fft(xc), iters=5, warmup=1)
        lib = cuda_ms(lambda: torch.fft.fft(xc), iters=5, warmup=1)
        log(f"path {dtype_c} N=2^{logn_c} B={b_c}: plan.fft {port:.4f} ms, "
            f"torch.fft.fft {lib:.4f} ms")
    del path_rows

    kernels = [
        {"name": "block_fft", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_fft.cu",
         "replaces": "src/repro/kernels/stockham.py:114",
         "launches": launches["block_fft"],
         "launches_per_call": per_call["block_fft"],
         "max_abs_err": kerr["block_fft"],
         "max_err_over_tol": kratio["block_fft"], "ms": blk_ms,
         "plain_ms": blk_plain, "bound_ms": blk_bound[0],
         "bound_by": blk_bound[1], "library_ms": lib_ms},
        {"name": "abft_fft", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/abft_fft.cu",
         "replaces": "src/repro/kernels/stockham_abft.py:119",
         "launches": launches["abft_fft"],
         "launches_per_call": per_call["abft_fft"],
         "max_abs_err": kerr["abft_fft"], "max_abs_err_parts": abft_parts,
         "max_err_over_tol": kratio["abft_fft"], "ms": abft_ms,
         "plain_ms": abft_plain, "bound_ms": abft_bound[0],
         "bound_by": abft_bound[1], "library_ms": None,
         "torch_fft_ms": lib_ms, "overhead_vs_block_fft":
             abft_ms / blk_ms - 1},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
