"""Head-padding planner for TP-indivisible attention head counts.

JAX/GSPMD rejects uneven input shardings, but the production mesh fixes
the tensor-parallel axis at 16 while several assigned archs have head
counts that do not divide it (yi-34b / llava-next-34b: 56 q-heads, 8 kv;
recurrentgemma: 10 q-heads, 1 kv).

The planner computes a *physical* layout:
  * q heads padded up to a multiple of tp; padded slots are masked to
    zero output (function-preserving, gradient-preserving),
  * kv heads replicated so the physical kv count divides tp and each
    physical q slot's kv group matches its logical head's group.

Because models are initialized from scratch, the physical layout IS the
parameterization; `tests/test_tp_padding.py` proves functional
equivalence against an unpadded logical-reference attention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class HeadPlan:
    n_q: int                  # logical q heads
    n_kv: int                 # logical kv heads
    tp: int
    n_q_phys: int             # padded physical q heads (multiple of tp)
    n_kv_phys: int            # replicated physical kv heads (multiple of tp
                              # or divides tp evenly per shard)
    # phys q slot -> logical q head index, or -1 for padding
    q_slot_to_logical: Tuple[int, ...]
    # phys kv slot -> logical kv head index
    kv_slot_to_logical: Tuple[int, ...]

    @property
    def q_mask(self) -> np.ndarray:
        """(n_q_phys,) 1.0 for live slots, 0.0 for padding."""
        return np.asarray(
            [1.0 if s >= 0 else 0.0 for s in self.q_slot_to_logical],
            dtype=np.float32)

    @property
    def q_per_phys_kv(self) -> int:
        return self.n_q_phys // self.n_kv_phys


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_heads(n_q: int, n_kv: int, tp: int) -> HeadPlan:
    if n_q % n_kv:
        raise ValueError(f"q heads {n_q} not a multiple of kv heads {n_kv}")
    if n_q % tp == 0 and n_kv % tp == 0:
        # Fully divisible: identity plan.
        return HeadPlan(n_q, n_kv, tp, n_q, n_kv,
                        tuple(range(n_q)), tuple(range(n_kv)))

    n_q_phys = _ceil_to(n_q, tp)
    # Physical kv count: smallest multiple-of-gcd layout with
    #   n_kv_phys % tp == 0 (so kv tensors shard evenly) and
    #   n_q_phys % n_kv_phys == 0 (integral physical group size).
    n_kv_phys = None
    for cand in range(tp, n_q_phys + 1, tp):
        if n_q_phys % cand == 0 and cand % n_kv == 0:
            n_kv_phys = cand
            break
    if n_kv_phys is None:
        # Fall back to one kv per q slot (MHA-ification by replication).
        n_kv_phys = n_q_phys
    repl = n_kv_phys // n_kv            # each logical kv appears repl times
    kv_slot_to_logical = tuple(s // repl for s in range(n_kv_phys))

    # Each logical kv group g owns physical q slot range
    # [g*q_phys_per_group, (g+1)*q_phys_per_group); fill with its logical
    # q heads, pad the remainder.
    q_per_group = n_q // n_kv
    q_phys_per_group = n_q_phys // n_kv
    q_slots = []
    for g in range(n_kv):
        members = list(range(g * q_per_group, (g + 1) * q_per_group))
        members += [-1] * (q_phys_per_group - q_per_group)
        q_slots.extend(members)
    assert len(q_slots) == n_q_phys
    # Validate: each phys q slot's physical kv group maps back to its
    # logical kv group.
    q_per_phys_kv = n_q_phys // n_kv_phys
    for s, lq in enumerate(q_slots):
        if lq < 0:
            continue
        phys_kv = s // q_per_phys_kv
        assert kv_slot_to_logical[phys_kv] == lq // q_per_group, (
            s, lq, phys_kv)
    return HeadPlan(n_q, n_kv, tp, n_q_phys, n_kv_phys,
                    tuple(q_slots), kv_slot_to_logical)
