"""Rolling maintenance on the PyTorch port: drain every machine of a
running job, ONE machine at a time (the paper's §8.4 rebalancing use
case), printing the per-drain downtime — then verify the job state:
every original machine was replaced, training continued, rings stayed
valid, and the per-drain downtime is flat (no drain pays more than 1.5x
the median). The counterpart of `examples/rolling_maintenance.py`.

Halfway through the drain schedule the controller process itself is
killed and restarted from its write-ahead ControlJournal — workers
re-register, the standby ledger and topology replay, and the remaining
drains run on the adopted control plane with no extra downtime.

    PYTHONPATH=src python examples/torch_rolling_maintenance.py \\
        [--device cpu]

It runs on the CUDA card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from statistics import median

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.core.controller import Controller
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_gpt(layers=2, d=128, heads=4, vocab=512)
    cluster = Cluster(16, device_capacity=32 * 2 ** 30)
    clock = SimClock()
    eng = PipelineEngine(cfg, dp=2, pp=2, global_batch=8, seq_len=64,
                         cluster=cluster, clock=clock,
                         comm=CommHooks(clock), micro_batches=2,
                         device=args.device)
    ctl = Controller(eng, standby_count=0)
    ctl.bootstrap_job(list(range(4)))
    ctl.train(2)

    original = list(eng.grid.values())
    print(f"original machines: {sorted(original)}  device={args.device}")
    spares = iter(range(4, 16))
    per_drain = []
    for i, leaver in enumerate(original):
        if i == len(original) // 2:
            # maintenance hits the control plane too: kill the
            # controller mid-campaign and restart it from the journal
            dt0 = clock.lane_total("downtime")
            ctl = ctl.restart()
            print(f"controller restarted from journal "
                  f"(seq={ctl.journal.seq}, "
                  f"extra downtime={clock.lane_total('downtime') - dt0:.2f}s)")
        joiner = next(spares)      # fresh machine only: the leaver is
        # entering maintenance and may not rejoin yet
        rep = ctl.expected_migration([leaver], joiners=[joiner],
                                     train_during_prep=1)
        per_drain.append(rep.downtime)
        print(f"drain {i}: {leaver} -> {joiner} "
              f"downtime={rep.downtime:.2f}s overlap={rep.overlap:.1f}s")
        ctl.train(1)
    ctl.train(2)

    now = set(eng.grid.values())
    replaced = set(original) - now
    print(f"replaced: {sorted(replaced)}")
    for g in eng.groups.values():
        assert g.validate_rings(), g.gid
    train_time = clock.lane_total("train")
    ettr = train_time / (train_time + clock.lane_total("downtime"))
    med = median(per_drain)
    print(f"rings valid; per-drain downtime median={med:.2f}s "
          f"max={max(per_drain):.2f}s total={sum(per_drain):.2f}s "
          f"ETTR={ettr:.4f}")
    assert len(replaced) == 4, replaced
    assert max(per_drain) <= 1.5 * med, per_drain   # flat across drains
    # journal replay agrees with the live controller at the end
    state = ctl.journal.replay()
    assert all(r["committed"] for r in state["runs"].values())
    print("ROLLING MAINTENANCE OK")


if __name__ == "__main__":
    main()
