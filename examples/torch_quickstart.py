"""Quickstart on the PyTorch port: train a GPT on the TrainMover runtime,
survive an expected migration AND an unexpected failure mid-run, and
verify the loss trajectory is exactly the one an uninterrupted run
produces (the counterpart of `examples/quickstart.py`).

    PYTHONPATH=src python examples/torch_quickstart.py [--steps 300] \\
        [--small] [--device cpu]

It runs on the CUDA card unless `--device cpu` is given. The cluster is
simulated (7 machines: dp=2 x pp=2, two spares and one standby) but the
training math, gradient reduces, stage-program builds and state copies
are real; only network/bootstrap *timing* comes from the calibrated
cost model.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.core.controller import Controller
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks


def build(cfg, dp, pp, batch, seq, device, standby=1):
    cluster = Cluster(dp * pp + 2 + standby, device_capacity=32 * 2 ** 30)
    clock = SimClock()
    comm = CommHooks(clock)
    eng = PipelineEngine(cfg, dp=dp, pp=pp, global_batch=batch,
                         seq_len=seq, cluster=cluster, clock=clock,
                         comm=comm, micro_batches=2, device=device)
    return Controller(eng, standby_count=standby)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="2-layer d=128 model (fast CI mode)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.small:
        cfg = tiny_gpt(layers=2, d=128, heads=4, vocab=512)
        batch, seq = 8, 64
    else:
        # ~100M params: 12 layers x d=768 (GPT-2 small class)
        cfg = tiny_gpt(layers=12, d=768, heads=12, vocab=32768)
        batch, seq = 8, 256

    t0 = time.perf_counter()
    print(f"model={cfg.name}  steps={args.steps}  device={args.device}")

    # --- reference run (no interruptions) --------------------------
    ref = build(cfg, 2, 2, batch, seq, args.device)
    ref.bootstrap_job(list(range(4)))
    third = max(args.steps // 3, 1)
    ref_losses = ref.train(3 * third)
    del ref

    # --- interrupted run -------------------------------------------
    ctl = build(cfg, 2, 2, batch, seq, args.device)
    ctl.bootstrap_job(list(range(4)))
    losses = ctl.train(third)

    print(f"\n[{third}] expected migration (maintenance) ...")
    rep = ctl.expected_migration([ctl.engine.grid[(1, 1)]])
    print(f"  downtime={rep.downtime:.2f}s  overlapped={rep.overlap:.2f}s"
          f"  qps: +{rep.qps_added}/~{rep.qps_inherited} inherited"
          f"  mem_overhead={rep.mem_overhead_bytes:.0f}B")
    losses += ctl.train(third)

    print(f"\n[{2*third}] unexpected failure (GPU down) ...")
    rep2 = ctl.unexpected_failure(ctl.engine.grid[(0, 0)])
    print(f"  downtime={rep2.downtime:.2f}s  state via {rep2.state_path}"
          f"  promote={rep2.promote_s:.2f}s"
          f"  lost_iterations={rep2.lost_iterations}")
    losses += ctl.train(third)

    same = losses == ref_losses
    print(f"\nloss[0]={losses[0]:.4f} -> loss[-1]={losses[-1]:.4f}")
    print(f"trajectory bitwise-identical to uninterrupted run: {same}")
    print(f"downtime total={ctl.clock.lane_total('downtime'):.2f}s "
          f"(sim)  wall={time.perf_counter() - t0:.0f}s")
    assert same, "migration transparency violated!"
    assert losses[-1] < losses[0], "model did not learn"
    print("QUICKSTART OK")


if __name__ == "__main__":
    main()
