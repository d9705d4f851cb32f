"""Training entry point: real steps on one device, with deterministic restart
from the latest checkpoint, async checkpointing, FT telemetry and
step-addressable data. Port of ``repro.launch.train``; it runs on the card
unless ``--device cpu`` asks for the kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --preset tiny --steps 50 --ckpt-dir /tmp/ckpt --device cpu

    # Gemma-3 1B at its published widths on the card, every linear's
    # forward checked by ft_matmul
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \
        --preset full --steps 10 --ft-linears --ckpt-dir /tmp/ckpt

Weights are drawn from ``RunConfig.seed`` on the device (the reference
draws them from JAX's PRNG, so the two CLIs start from other weights);
the batches are the reference's, bit for bit. They hold tokens only:
``--arch internvl2-1b`` trains on the text path, and ``--arch
whisper-base`` raises ``KeyError: 'frames'``, as the reference's CLI does
(ROADMAP queue 3, "In the reference itself", item 10); train Whisper
through ``make_train_step`` with a batch that carries ``frames``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import optim
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ParallelConfig, RunConfig
from repro_torch.data import TokenPipeline
from repro_torch.models import Model
from repro_torch.train import make_train_step

__all__ = ["build", "main"]


def build(arch: str, preset: str, *, steps: int, batch: int, seq: int,
          lr: float = 3e-4, ft_linears: bool = False):
    if preset == "full":
        cfg = get_config(arch)
    elif preset == "tiny":
        cfg = get_smoke_config(arch)
    elif preset == "lm100m":
        cfg = dataclasses.replace(
            get_smoke_config(arch), name=f"{arch}-100m", num_layers=12,
            d_model=640, num_heads=10, num_kv_heads=2, d_ff=2560,
            vocab_size=32768)
    else:
        raise ValueError(preset)
    if ft_linears:
        cfg = dataclasses.replace(
            cfg, ft=dataclasses.replace(cfg.ft, protect_linears=True))
    run = RunConfig(model=cfg, parallel=ParallelConfig(remat="none"),
                    learning_rate=lr, warmup_steps=max(steps // 10, 5),
                    total_steps=steps)
    return cfg, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "lm100m", "full"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ft-linears", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    cfg, run = build(args.arch, args.preset, steps=args.steps,
                     batch=args.batch, seq=args.seq, lr=args.lr,
                     ft_linears=args.ft_linears)
    dev = torch.device(args.device)
    model = Model(cfg)
    step_fn = make_train_step(model, run)
    pipe = TokenPipeline(seed=run.seed, batch=args.batch, seq_len=args.seq,
                         vocab_size=cfg.vocab_size)

    params = model.init(torch.Generator(device=dev).manual_seed(run.seed),
                        device=dev)
    opt_state = optim.init_state(params)
    start = 0

    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir,
                                keep=cfg.ft.keep_checkpoints)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt_state), meta = restore_checkpoint(
                args.ckpt_dir, (params, opt_state))
            start = meta["step"] + 1
            print(f"[restore] resumed from step {meta['step']}")

    log = []
    t_start = time.time()
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe(step).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t_start, 2)
            log.append(m)
            print(f"step {step:5d} loss {m['loss']:.4f} ce {m['ce']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} "
                  f"ft_flagged {m['ft_flagged']:.0f}", flush=True)
        every = args.ckpt_every or cfg.ft.checkpoint_every
        if mgr and every and step and step % every == 0:
            mgr.save(step, (params, opt_state))
    if mgr:
        mgr.save(args.steps - 1, (params, opt_state))
        mgr.wait()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    return log


if __name__ == "__main__":
    main()
