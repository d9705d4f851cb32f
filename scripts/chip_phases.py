"""Run one or two of ``chip_smoke.py``'s phases on the card, without the
rest of the script (which takes about 1000 s):

    python3 scripts/chip_phases.py lmp            # phase 14 alone
    python3 scripts/chip_phases.py shard          # phases 13 and 14
    python3 scripts/chip_phases.py cli 10,12 1,2  # phase 10's CLI runs
    python3 scripts/chip_phases.py xlstm          # phase 12's xLSTM, fresh
                                                  # and after phases 7-11

``lmp`` runs phase 14 as the script does, but in four fresh gloo ranks on
the card (``chip_smoke.lmp_rank``) and then its checks in this process
(``chip_smoke.lmp_phase``). ``shard`` runs phases 13 and 14 as the
script does (``chip_smoke.sharded_phase``, then ``lmp_phase`` on the
ranks' phase-14 records). ``cli`` runs ``chip_smoke.train_cli`` once for
each step pair given (the first run's steps, then the resumed run's), in
turn, and prints each pair's seconds. The parts can be given in any
order. ``xlstm`` measures phase 12's xLSTM-350M drive as the script runs
it (``chip_smoke.rm_drive``: gates (a) and (c), the protected and the
unprotected run; then ``rm_measure``'s trace) three times, one after the
other: in a fresh spawned process, then in this process after phases
7-11 as ``chip_smoke.main`` runs them (drives and measures), then in a
fresh process again. For each it prints the seconds, the ms a step,
``process_probe`` before and after and the seconds gc took. The kernels
are built first. Exits 1 when a gate fails.
"""
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402


def lmp_rank_main(rank, store, out_dir):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=4)
    with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as trace:
        try:
            res = cs.lmp_rank(rank, out_dir, trace)
        except Exception:
            res = {"rank": rank, "failures": [traceback.format_exc()]}
    with open(os.path.join(out_dir, f"rank{rank}-lm.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def lmp(smi):
    import torch
    import torch.multiprocessing as mp

    out_dir = tempfile.mkdtemp(prefix="lmp-", dir=cs._build_dir())
    t0 = time.perf_counter()
    mp.spawn(lmp_rank_main, args=(os.path.join(out_dir, "store"), out_dir),
             nprocs=4)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(4):
        with open(os.path.join(out_dir, f"rank{r}-lm.json")) as f:
            ranks.append(json.load(f))
    for res in ranks:
        for msg in res["failures"]:
            cs.log(f"rank {res['rank']}: {msg}")
    rec = cs.lmp_phase(torch.device("cuda", 0), out_dir, ranks, smi)
    print(json.dumps({"lmp": {"ranks_seconds": ranks_s,
                              "seconds": time.perf_counter() - t0,
                              "parent_seconds": rec["parent_seconds"],
                              "device": smi}}), flush=True)


def shard(smi):
    import torch

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    rec = cs.sharded_phase(dev, cs.cuda_ms, smi)
    ranks = []
    for r in range(cs.SHARD_RANKS):
        with open(os.path.join(rec["out_dir"], f"rank{r}-lm.json")) as f:
            ranks.append(json.load(f))
    lmp_rec = cs.lmp_phase(dev, rec["out_dir"], ranks, smi)
    print(json.dumps({"shard": {"seconds": time.perf_counter() - t0,
                                "four_ranks_seconds":
                                    rec["four_ranks_seconds"],
                                "lmp_parent_seconds":
                                    lmp_rec["parent_seconds"],
                                "device": smi}}), flush=True)


def cli(pairs, smi):
    for first, second in pairs:
        t0 = time.perf_counter()
        rows = cs.train_cli((first, second))
        print(json.dumps({"cli": {"steps": [first, second],
                                  "seconds": time.perf_counter() - t0,
                                  "runs_seconds": [r["seconds"]
                                                   for r in rows],
                                  "device": smi}}), flush=True)


@contextlib.contextmanager
def counted_abft():
    """The eager ABFT products and the eager batched expert products
    counted, as ``chip_smoke.main`` counts them: yields (the list of eager
    calls, ``{"calls": n}``)."""
    from repro_torch.core.abft import gemm as abft_gemm

    eager, batched_fn = abft_gemm.ft_matmul, abft_gemm.ft_matmul_batched
    calls, batched = [], {"calls": 0}

    def counted_eager(*args, **kwargs):
        calls.append(1)
        return eager(*args, **kwargs)

    def counted_batched(*args, **kwargs):
        batched["calls"] += 1
        return batched_fn(*args, **kwargs)

    abft_gemm.ft_matmul = counted_eager
    abft_gemm.ft_matmul_batched = counted_batched
    try:
        yield calls, batched
    finally:
        abft_gemm.ft_matmul = eager
        abft_gemm.ft_matmul_batched = batched_fn


def phases_7_to_11(dev):
    """Phases 7-11's drives and measures in this process, as
    ``chip_smoke.main`` runs them; their seconds."""
    import torch

    timers = (cs.cuda_ms, cs.host_ms, cs.trace_call)
    seconds = {}
    with counted_abft() as (calls, _):
        t0 = time.perf_counter()
        _, models, params, tokens, prompts = cs.lm_drive(dev)
        cs.lm_measure(dev, models, params, tokens, prompts, *timers)
        del models, params, tokens, prompts
        seconds["7"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for arch in cs.SSM_ARCHS:
            res, models, params, tokens, prompts = cs.ssm_drive(dev, arch)
            cs.ssm_measure(dev, arch, res["sites_per_step"], models, params,
                           tokens, prompts, *timers)
            del models, params, tokens, prompts
            torch.cuda.empty_cache()
        seconds["8"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for arch in cs.MOE_ARCHS:
            _, models, params, tokens, prompts = cs.moe_drive(dev, arch)
            cs.moe_measure(dev, arch, models, params, tokens, prompts,
                           *timers)
            del models, params, tokens, prompts
            torch.cuda.empty_cache()
        seconds["9"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, models, params = cs.train_drive(dev, calls)
        cs.train_measure(dev, models, params, *timers)
        del models, params
        torch.cuda.empty_cache()
        seconds["10"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for arch in cs.ENCDEC_ARCHS:
            _, models, params, batch, prompts = cs.encdec_drive(dev, arch,
                                                                calls)
            cs.encdec_measure(dev, arch, models, params, batch, prompts,
                              *timers)
            del models, params, batch, prompts
            torch.cuda.empty_cache()
        seconds["11"] = time.perf_counter() - t0
    return seconds


def process_probe():
    """What a long process accumulates: gc's pending counts, collections
    by generation and tracked objects, the caching allocator's counters on
    the card, and the host µs of one small torch op (``torch.add`` of four
    floats on the card, 20000 calls)."""
    import gc

    import torch

    a = torch.zeros(4, device="cuda")
    b = torch.empty_like(a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20000):
        torch.add(a, 1.0, out=b)
    op_us = (time.perf_counter() - t0) / 20000 * 1e6
    torch.cuda.synchronize()
    st = torch.cuda.memory_stats()
    keys = ("allocated_bytes.all.current", "reserved_bytes.all.current",
            "active.all.current", "segment.all.current",
            "inactive_split.all.current", "inactive_split_bytes.all.current",
            "num_alloc_retries", "num_device_alloc", "num_device_free")
    return {"gc_count": list(gc.get_count()),
            "gc_collections": [g["collections"] for g in gc.get_stats()],
            "gc_objects": len(gc.get_objects()), "op_us": op_us,
            "cuda": {k: int(st.get(k, 0)) for k in keys}}


@contextlib.contextmanager
def gc_seconds(out: dict):
    """Sum the seconds gc's collections take in the body into
    ``out["gc_s"]`` (and their count into ``out["gc_runs"]``)."""
    import gc

    out.setdefault("gc_s", 0.0)
    out.setdefault("gc_runs", 0)
    start = []

    def clock(phase, info):
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            out["gc_s"] += time.perf_counter() - start.pop()
            out["gc_runs"] += 1

    gc.callbacks.append(clock)
    try:
        yield out
    finally:
        gc.callbacks.remove(clock)


def xlstm_drive(label):
    """Phase 12's xLSTM-350M drive and trace in this process
    (``chip_smoke.rm_drive``, ``rm_measure``): its row."""
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proc = {"before": process_probe()}
    with gc_seconds(proc), counted_abft() as (calls, batched):
        res, prot, _ = cs.rm_drive(dev, "xlstm_350m", calls, batched)
        res.update(cs.rm_measure(dev, "xlstm_350m", prot, cs.trace_call))
        del prot
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    proc["after"] = process_probe()
    row = {"run": label, "seconds": time.perf_counter() - t0,
           "gates_s": res["gates_s"], "runs_s": res["runs_s"],
           "trace_s": res["trace_s"],
           "ms_per_step": {k: res[k]["ms_per_step"]
                           for k in ("protected", "unprotected")},
           "process": proc}
    cs.log(f"xlstm {label}: {row['seconds']:.1f} s (gates "
           f"{res['gates_s']:.1f} s, runs {res['runs_s']:.1f} s, trace "
           f"{res['trace_s']:.1f} s); ms a step {row['ms_per_step']}; gc "
           f"{proc['gc_s']:.1f} s in {proc['gc_runs']} collections; after "
           f"{json.dumps(proc['after'])}")
    return row


def _xlstm_child(path):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(path, "w") as f:
        json.dump(xlstm_drive("a fresh process"), f)


def xlstm_fresh():
    """``xlstm_drive`` in a fresh spawned process: its row."""
    import torch.multiprocessing as mp

    path = os.path.join(cs._build_dir(), "xlstm-fresh.json")
    proc = mp.get_context("spawn").Process(target=_xlstm_child, args=(path,))
    proc.start()
    proc.join()
    cs.check(proc.exitcode == 0, f"xlstm: the fresh process exited "
                                 f"{proc.exitcode}")
    with open(path) as f:
        return json.load(f)


def xlstm(smi):
    """(module docstring)"""
    import torch

    rows = [xlstm_fresh()]
    before = process_probe()
    seconds = phases_7_to_11(torch.device("cuda", 0))
    cs.log(f"phases 7-11: {json.dumps(seconds)} s")
    torch.cuda.empty_cache()
    rows.append(xlstm_drive("this process, after phases 7-11"))
    rows.append(xlstm_fresh())
    print(json.dumps({"xlstm": {"rows": rows, "phases_s": seconds,
                                "process_before_late": before,
                                "device": smi}}), flush=True)


def main(argv) -> int:
    import torch
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    cs.log(f"build {time.perf_counter() - t0:.1f} s ({smi})")
    parts, i = [], 0
    while i < len(argv):
        if argv[i] == "lmp":
            parts.append(lambda: lmp(smi))
            i += 1
        elif argv[i] == "shard":
            parts.append(lambda: shard(smi))
            i += 1
        elif argv[i] == "xlstm":
            parts.append(lambda: xlstm(smi))
            i += 1
        elif argv[i] == "cli":
            j = i + 1
            while j < len(argv) and argv[j] not in ("lmp", "cli", "shard",
                                                     "xlstm"):
                j += 1
            pairs = [tuple(int(n) for n in a.split(",")) for a in argv[i + 1:j]]
            parts.append(lambda pairs=pairs: cli(pairs, smi))
            i = j
        else:
            print(__doc__, file=sys.stderr)
            return 2
    ok = True
    for part in parts:
        try:
            part()
        except AssertionError as e:
            cs.log(f"FAILED: {e}")
            ok = False
    return 0 if ok and parts else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
