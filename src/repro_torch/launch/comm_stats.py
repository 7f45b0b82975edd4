"""Per-collective counts and bytes of one step (counterpart of
`repro/launch/hlo_stats.py`, which reads them from compiled HLO).

The port places its collectives itself (`models/shardings.py`
`to_model`, `from_model`, `gather_model`, `split_model`,
`max_over_model`, `sum_over_batch`; ZeRO-1's reduce-scatter and
all-gather and the norm's all-reduce in `train/optimizer.py`), each a
c10d op. `Collectives` sees every c10d op a step calls, under the
reference's kind names: its count, and its bytes as the reference
counts them, the result's size times the kind's traffic multiplier
(`_MULT`: an all-reduce moves its payload twice in ring form). The
sizes come from the tensors the ops receive, in their own dtype.
`torch.distributed.tensor.debug.CommDebugMode` counts the same ops;
`Collectives.check` holds the counts to its. A collective over a group
of one rank is counted as the port calls it.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
               "all-to-all", "collective-permute")
# bytes moved per device as a multiple of the result size
_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}
# the c10d ops the port calls, each with its result as its first
# argument; another raises, so that none goes uncounted
_KIND = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter"}


def _bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(t) for t in x)
    return 0


class Collectives(TorchDispatchMode):
    """with Collectives() as c: ... — c.stats holds {kind: {count,
    bytes}} of the c10d collectives called within."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, Dict[str, float]] = {
            k: {"count": 0, "bytes": 0.0} for k in COLLECTIVES}
        self.calls: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            name = func._overloadpacket.__name__
            if name not in _KIND:
                raise NotImplementedError(f"collective c10d.{name} has no "
                                          f"kind")
            kind = _KIND[name]
            self.stats[kind]["count"] += 1
            self.stats[kind]["bytes"] += _bytes(args[0]) * _MULT[kind]
            self.calls[name] = self.calls.get(name, 0) + 1
        return out

    def check(self, comm_debug) -> None:
        """Raise unless every c10d op's count is CommDebugMode's."""
        theirs = {p.__name__: n
                  for p, n in comm_debug.get_comm_counts().items()}
        if theirs != self.calls:
            raise AssertionError(f"collectives {self.calls} against "
                                 f"CommDebugMode's {theirs}")

    @property
    def total_bytes(self) -> float:
        return sum(v["bytes"] for v in self.stats.values())
