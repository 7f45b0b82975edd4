"""Run one (arch x shape) cell's step on the production mesh as rank 0 of
a fake process group, on `meta` tensors, and print its memory, FLOP and
collective terms: the per-cell view of the port's dry-run
(`repro_torch.launch.dryrun`; the counterpart of
examples/dryrun_cell.py).

    PYTHONPATH=src python examples/torch_dryrun_cell.py \\
        --arch qwen2-moe-a2.7b --shape train_4k [--multi-pod]

One process on the CPU, no card: the step runs once on `meta` tensors
and no kernel is launched. Like the reference's, it needs a process of
its own (it makes the process group).
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import run_cell    # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    rec = run_cell(args.arch, args.shape, args.multi_pod)
    for k, v in rec.items():
        if k == "trace":
            continue
        print(f"{k:>32s}: {v}")
    assert rec["status"] in ("ok", "skipped"), rec.get("error")


if __name__ == "__main__":
    main()
