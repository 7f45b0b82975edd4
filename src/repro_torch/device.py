"""Where the port's entry points run: the card unless the caller names
another device, and bitwise-repeatable when it is the card."""
from __future__ import annotations

import os

import torch


def resolve_device(device, who: str) -> torch.device:
    """torch.device for `device` (None -> "cuda"); raises when CUDA is
    asked for (or defaulted to) and absent. `who` names the entry point
    in the message."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who} runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to "
                           "run on the CPU")
    return dev


def deterministic_cuda() -> None:
    """Bitwise-repeatable CUDA runs: cuBLAS needs a fixed workspace
    (read when cuBLAS starts, so this runs before the first matmul)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    # deterministic mode also fills every new allocation with NaN (a
    # check for reads of memory never written, not a condition of
    # repeatability): one extra kernel per op, which doubles the launches
    # of launch-bound loops such as the sLSTM's
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
