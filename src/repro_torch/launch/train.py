"""Training launcher (counterpart of `repro/launch/train.py`): trains any
registered architecture the port has, on one device or, under
`torchrun`, on a (data, model) mesh with one rank per device.

    # CPU sanity run (reduced config):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --reduced --device cpu --steps 20 \\
        --batch 8 --seq 64

    # the full config on one GPU (the default device):
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --steps 3 --batch 1 --seq 4096

    # data x tensor parallel with ZeRO-1 on four GPUs (NCCL):
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch stablelm-1.6b --mesh 2x2 \\
        --steps 3 --batch 4 --seq 2048

    # the same on the CPU (gloo):
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch stablelm-1.6b --reduced \\
        --mesh 1x2 --device cpu --steps 4 --batch 2 --seq 32

    # expert parallel: Qwen1.5-MoE-A2.7B's 60 experts, 15 a card:
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch qwen2-moe-a2.7b --mesh 1x4 \\
        --steps 3 --batch 4 --seq 2048

Under `--mesh`, the process group is torchrun's (or the caller's, when
it is already initialized): NCCL on `--device cuda` and gloo on
`--device cpu`, never the other. Rank 0 prints and writes checkpoints;
a checkpoint holds the whole state, gathered from every rank.
Checkpoints are written every --ckpt-every steps; --resume restarts
from the newest one, split onto the current mesh, which may have
another shape (the stop/restart baseline the TrainMover runtime
benchmarks compare against).
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the decoder's depth to this many layers")
    ap.add_argument("--encoder-layers", type=int, default=None,
                    help="cut the encoder's depth to this many layers")
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="none",
                    help='"none", or DxT / PxDxT: data (pod) x model '
                         'extents, one rank per device (e.g. 2x2, 16x16)')
    ap.add_argument("--tp", type=int, default=None,
                    help="the physical layout (padded heads and vocab) of "
                         "this tensor-parallel extent with --mesh none; "
                         "under a mesh it is the mesh's model extent")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _setup_mesh(args):
    """(mesh, device, whether the process group is this run's own) for
    `--mesh`: NCCL on the card (the rank's own, LOCAL_RANK), gloo on
    the CPU."""
    dev = resolve_device(args.device, "--mesh")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    own = not dist.is_initialized()
    if own:
        dist.init_process_group(backend)
    elif dist.get_backend() != backend:
        raise ValueError(f"--device {dev.type} needs {backend}; the "
                         f"process group runs {dist.get_backend()}")
    return make_production_mesh(args.mesh, dev.type), dev, own


def main(argv=None, on_step=None) -> list:
    """Train as the arguments say; returns one dict per step taken
    (step, loss, grad_norm, lr, seconds: the step's wall time up to the
    device's completion; under a mesh every rank's list is the same but
    for the seconds). `on_step(step, stats)` runs after each step."""
    args = parse_args(argv)
    cfg = (registry.reduced_config(args.arch) if args.reduced
           else registry.get_config(args.arch))
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.encoder_layers is not None:
        cfg = cfg.replace(encoder_layers=args.encoder_layers)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = ShapeCfg("custom", "train", args.seq, args.batch)

    run = dataclasses.replace(step_mod.default_run_cfg(),
                              adam=AdamCfg(lr=args.lr, warmup_steps=20))
    stream = data_mod.stream_for(cfg, shape)
    mesh, dev, own_group = None, args.device, False
    if args.mesh != "none":
        mesh, dev, own_group = _setup_mesh(args)
    try:
        return _train(args, cfg, shape, run, stream, mesh, dev, on_step)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, cfg, shape, run, stream, mesh, dev, on_step) -> list:
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    t0 = time.time()
    start_step = 0
    if args.resume:
        hits = sorted(glob.glob(f"{args.ckpt_dir}/{cfg.name}-*.pkl"))
        if hits:
            state, start_step = ckpt_mod.load(hits[-1])
            state = (step_mod.state_to(state, dev) if mesh is None else
                     step_mod.shard_state(state, cfg, mesh, dev))
            say(f"resumed from {hits[-1]} @ step {start_step}")
    if start_step == 0:
        state = step_mod.init_state(cfg, run, mesh=mesh, device=dev,
                                    tp=args.tp)
    train_step = step_mod.make_train_step(cfg, run, mesh, device=dev,
                                          tp=args.tp)
    where = (f"devices=1 ({dev}, tp layout {args.tp or 1})" if mesh is None
             else
             f"mesh={args.mesh} {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
             f" ({torch.device(dev).type}, "
             f"{dist.get_backend()})")
    say(f"arch={cfg.name} params={registry.count_params(cfg):,} "
        f"batch={shape.global_batch} seq={shape.seq_len} {where}")

    history = []
    for step in range(start_step, args.steps):
        batch = stream.batch(step)
        t = time.perf_counter()
        state, stats = train_step(state, batch)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        history.append({"step": step + 1, "loss": float(stats["loss"]),
                        "grad_norm": float(stats["grad_norm"]),
                        "lr": float(stats["lr"]),
                        "seconds": time.perf_counter() - t})
        if on_step is not None:
            on_step(step + 1, stats)
        if (step + 1) % args.log_every == 0 or step == start_step:
            h = history[-1]
            say(f"step {step + 1:>5d}  loss {h['loss']:.4f}"
                f"  gnorm {h['grad_norm']:.3f}"
                f"  lr {h['lr']:.2e}"
                f"  {time.time() - t0:.0f}s")
        if (step + 1) % args.ckpt_every == 0:
            path = f"{args.ckpt_dir}/{cfg.name}-{step + 1:07d}.pkl"
            whole = state if mesh is None else \
                step_mod.gather_state(state, cfg, mesh)
            if rank0:
                nbytes = ckpt_mod.save(path, whole, step + 1)
                say(f"checkpoint -> {path} ({nbytes / 2 ** 20:.1f} MiB)")
            del whole
            if mesh is not None:
                dist.barrier()
    say("TRAINING DONE")
    return history


if __name__ == "__main__":
    main()
