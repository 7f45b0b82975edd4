"""Training launcher (counterpart of `repro/launch/train.py`): trains any
registered architecture the port has on one device.

    # CPU sanity run (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --reduced --device cpu --steps 20 \\
        --batch 8 --seq 64

    # the full config on one GPU (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --steps 3 --batch 1 --seq 4096

Checkpoints are written every --ckpt-every steps; --resume
restarts from the newest one (the stop/restart baseline the TrainMover
runtime benchmarks compare against). Only --mesh none is ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import time

import torch

from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.models import registry
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import data as data_mod
from repro_torch.train import step as step_mod
from repro_torch.train.optimizer import AdamCfg


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=list(registry.ARCH_IDS) + ["gpt-medium"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "16x16", "2x16x16"])
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, on_step=None) -> list:
    """Train as the arguments say; returns one dict per step taken
    (step, loss, grad_norm, lr, seconds: the step's wall time up to the
    device's completion). `on_step(step, stats)` runs after each step."""
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError("meshes are not ported "
                                  "(ROADMAP Queue 1 item 11)")
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeCfg("custom", "train", args.seq, args.batch)

    run = dataclasses.replace(step_mod.default_run_cfg(),
                              adam=AdamCfg(lr=args.lr, warmup_steps=20))
    stream = data_mod.stream_for(cfg, shape)

    t0 = time.time()
    start_step = 0
    if args.resume:
        hits = sorted(glob.glob(f"{args.ckpt_dir}/{cfg.name}-*.pkl"))
        if hits:
            state, start_step = ckpt_mod.load(hits[-1])
            state = step_mod.state_to(state, args.device)
            print(f"resumed from {hits[-1]} @ step {start_step}")
    if start_step == 0:
        state = step_mod.init_state(cfg, run, device=args.device)
    train_step = step_mod.make_train_step(cfg, run, device=args.device)
    print(f"arch={cfg.name} params={registry.count_params(cfg):,} "
          f"batch={shape.global_batch} seq={shape.seq_len} devices=1 "
          f"({args.device})")

    history = []
    for step in range(start_step, args.steps):
        batch = stream.batch(step)
        t = time.perf_counter()
        state, stats = train_step(state, batch)
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()
        history.append({"step": step + 1, "loss": float(stats["loss"]),
                        "grad_norm": float(stats["grad_norm"]),
                        "lr": float(stats["lr"]),
                        "seconds": time.perf_counter() - t})
        if on_step is not None:
            on_step(step + 1, stats)
        if (step + 1) % args.log_every == 0 or step == start_step:
            h = history[-1]
            print(f"step {step + 1:>5d}  loss {h['loss']:.4f}"
                  f"  gnorm {h['grad_norm']:.3f}"
                  f"  lr {h['lr']:.2e}"
                  f"  {time.time() - t0:.0f}s")
        if (step + 1) % args.ckpt_every == 0:
            path = f"{args.ckpt_dir}/{cfg.name}-{step + 1:07d}.pkl"
            nbytes = ckpt_mod.save(path, state, step + 1)
            print(f"checkpoint -> {path} ({nbytes / 2 ** 20:.1f} MiB)")
    print("TRAINING DONE")
    return history


if __name__ == "__main__":
    main()
