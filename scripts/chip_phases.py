"""Run one or two of ``chip_smoke.py``'s phases on the card, without the
rest of the script (which takes about 1000 s):

    python3 scripts/chip_phases.py lmp            # phase 14 alone
    python3 scripts/chip_phases.py cli 10,12 1,2  # phase 10's CLI runs

``lmp`` runs phase 14 as the script does, but in four fresh gloo ranks on
the card (``chip_smoke.lmp_rank``) and then its checks in this process
(``chip_smoke.lmp_phase``). ``cli`` runs ``chip_smoke.train_cli`` once for
each step pair given (the first run's steps, then the resumed run's), in
turn, and prints each pair's seconds. Both parts can be given, in either
order. The kernels are built first. Exits 1 when a gate fails.
"""
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


def cli(pairs, smi):
    for first, second in pairs:
        t0 = time.perf_counter()
        rows = cs.train_cli((first, second))
        print(json.dumps({"cli": {"steps": [first, second],
                                  "seconds": time.perf_counter() - t0,
                                  "runs_seconds": [r["seconds"]
                                                   for r in rows],
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
        elif argv[i] == "cli":
            j = i + 1
            while j < len(argv) and argv[j] not in ("lmp", "cli"):
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
