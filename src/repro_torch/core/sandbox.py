"""Communication-free sandbox: collective record-replay (§4)
(counterpart of `repro/core/sandbox.py`: same tape keys, op counters
and clock charges; tape entries are host copies of the tensors).

The hook layer sits between the training engine and the CCL (the
analogue of the paper's PyTorch<->NCCL interception layer). Three modes:

  NORMAL  - collectives execute for real (ring math over machine shards)
  RECORD  - execute + persist every collective *output* to the Tape,
            keyed role-relatively so any machine adopting that role can
            replay it (general-standby symmetry, §6)
  REPLAY  - sandboxed: calls that would cross the sandbox boundary are
            served from the Tape; send/barrier are bypassed; collectives
            fully inside the sandbox run natively (§4.3 boundary-aware
            replay)

Recording happens once during the first iteration(s) of the job; the
hook is then removed (mode returns to NORMAL) and steady-state training
pays zero overhead.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.simclock import SimClock


class CommMode(enum.Enum):
    NORMAL = "normal"
    RECORD = "record"
    REPLAY = "replay"


@dataclass
class Tape:
    """Role-relative recorded collective outputs.

    Keys: (role_key, op, tag, call_index). role_key is the pipeline
    stage index for expected migrations and the stage *type*
    (first/middle/last/only) for the general standby."""
    entries: Dict[Tuple, torch.Tensor] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)

    def put(self, key: Tuple, value) -> None:
        self.entries[key] = value.detach().to("cpu", copy=True)

    def get(self, key: Tuple) -> torch.Tensor:
        if key not in self.entries:
            raise KeyError(f"tape miss: {key}; have "
                           f"{sorted(self.entries)[:8]}...")
        return self.entries[key]

    def has(self, key: Tuple) -> bool:
        return key in self.entries

    def nbytes(self) -> int:
        return sum(v.nbytes for v in self.entries.values())

    def for_role(self, role_key) -> Dict[Tuple, torch.Tensor]:
        return {k: v for k, v in self.entries.items() if k[0] == role_key}

    def alias_role(self, src_role, dst_role) -> int:
        """Reuse one role's recordings for a symmetric role (dedup of
        duplicated training roles, §4.3). Returns entries aliased."""
        n = 0
        for k, v in list(self.entries.items()):
            if k[0] == src_role:
                self.entries[(dst_role,) + k[1:]] = v
                n += 1
        return n

    def coalesce_p2p(self, role_key) -> int:
        """Drop every p2p entry beyond the first call index per tag for
        one role. A shadow iteration replays exactly one microbatch, so
        the idx>0 recordings (other replicas/microbatches of the record
        iteration) are dead weight on the tape. Returns bytes freed."""
        freed = 0
        for k in list(self.entries):
            if k[0] == role_key and k[1] == "p2p" and k[3] > 0:
                freed += self.entries.pop(k).nbytes
        return freed

    def fuse_p2p_io(self, role_key) -> int:
        """Fuse a role's first activation ('act') and gradient ('grad')
        recv recordings into ONE stacked 'io' entry, dropping every
        per-tag p2p entry for the role. Middle pipeline stages replay a
        single fused recv instead of two; roles missing either tag
        (first/last stages) are left to coalesce_p2p. Returns net bytes
        freed (-1 if the role cannot fuse)."""
        ka = (role_key, "p2p", "act", 0)
        kg = (role_key, "p2p", "grad", 0)
        if not (self.has(ka) and self.has(kg)):
            return -1
        if self.get(ka).shape != self.get(kg).shape:
            return -1
        fused = torch.stack([self.get(ka), self.get(kg)])
        freed = 0
        for k in list(self.entries):
            if k[0] == role_key and k[1] == "p2p" and k[2] in ("act",
                                                               "grad"):
                freed += self.entries.pop(k).nbytes
        self.entries[(role_key, "p2p", "io", 0)] = fused
        return freed - fused.nbytes


@dataclass
class AsyncResult:
    """Handle returned by all_reduce_async: the reduced value is
    available immediately (the math runs at issue time, as a CCL's
    in-transport reduction does); the *sim charge* settles at wait(),
    when only the exposed remainder hits the lane."""
    key: Tuple
    value: Any
    clock_handle: Optional[int]     # None => nothing to charge (replay)


class CommHooks:
    """The engine-facing collective interface with interception."""

    def __init__(self, clock: SimClock, cost: CostModel = DEFAULT,
                 tape: Optional[Tape] = None,
                 mode: CommMode = CommMode.NORMAL,
                 lane: str = "train"):
        self.clock = clock
        self.cost = cost
        self.tape = tape if tape is not None else Tape()
        self.mode = mode
        self.lane = lane
        self.sandbox_members: Set[int] = set()
        self._counters: Dict[Tuple, int] = {}
        self.replay_bytes = 0
        self.record_bytes = 0
        # per-iteration hook-invocation counts (reset with the idx
        # counters at the top of each iteration); the throughput
        # benchmark asserts bucketing shrinks op_counts["all_reduce"].
        self.op_counts: Dict[str, int] = {}

    # ---------------------------------------------------------- helpers
    def _next_idx(self, role_key, op, tag) -> int:
        k = (role_key, op, tag)
        i = self._counters.get(k, 0)
        self._counters[k] = i + 1
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        return i

    def reset_counters(self) -> None:
        self._counters.clear()
        self.op_counts = {}

    def _cost_seconds(self, nbytes: float, inter: bool,
                      participants: int = 2) -> float:
        bw = self.cost.bw_inter_node if inter else self.cost.bw_intra_node
        return self.cost.collective_seconds(nbytes, bw, participants)

    def _charge(self, nbytes: float, inter: bool, name: str,
                participants: int = 2) -> None:
        """Blocking latency + bandwidth charge for one collective
        launch (formula: CostModel.collective_seconds)."""
        self.clock.advance(self._cost_seconds(nbytes, inter, participants),
                           name, lane=self.lane)

    # ------------------------------------------------------ collectives
    def all_reduce(self, role_key, tag: str, arrays: Sequence,
                   mid: Optional[int] = None,
                   participants: Optional[int] = None):
        """DP ring all-reduce across `arrays` (one per member). In
        REPLAY mode only one array (the sandboxed caller's) is passed
        and the recorded result is returned.  A caller whose reduction
        is already fused into one program (the flat gradient bucket)
        passes the single reduced array plus `participants`, the ring
        size to charge for."""
        idx = self._next_idx(role_key, "all_reduce", tag)
        key = (role_key, "all_reduce", tag, idx)
        if self.mode == CommMode.REPLAY:
            self.replay_bytes += self.tape.get(key).nbytes
            return self.tape.get(key)
        out = arrays[0]
        for a in arrays[1:]:
            out = out + a
        nb = arrays[0].nbytes
        self._charge(nb, inter=True, name=f"allreduce:{tag}",
                     participants=participants or len(arrays))
        if self.mode == CommMode.RECORD:
            self.tape.put(key, out)
            self.record_bytes += out.nbytes
        return out

    def all_reduce_async(self, role_key, tag: str, arrays: Sequence,
                         mid: Optional[int] = None,
                         participants: Optional[int] = None) -> AsyncResult:
        """Non-blocking all_reduce: same reduction, same tape keys and
        op counters as the blocking form, but the sim charge goes onto
        the per-(role) ring's ledger channel; wait() later charges only
        the exposed remainder. RECORD writes the identical fused entry,
        so shadow replays are oblivious to whether the engine issued
        the collective sync or async."""
        idx = self._next_idx(role_key, "all_reduce", tag)
        key = (role_key, "all_reduce", tag, idx)
        if self.mode == CommMode.REPLAY:
            out = self.tape.get(key)
            self.replay_bytes += out.nbytes
            return AsyncResult(key, out, None)
        out = arrays[0]
        for a in arrays[1:]:
            out = out + a
        nb = arrays[0].nbytes
        t = self._cost_seconds(nb, inter=True,
                               participants=participants or len(arrays))
        h = self.clock.issue_async(("allreduce", role_key), t,
                                   f"allreduce:{tag}")
        if self.mode == CommMode.RECORD:
            self.tape.put(key, out)
            self.record_bytes += out.nbytes
        return AsyncResult(key, out, h)

    def wait(self, handle: AsyncResult):
        """Block on an async collective; charges the exposed remainder
        to this hook's lane and returns the reduced value."""
        if handle.clock_handle is not None:
            self.clock.wait_async(handle.clock_handle, lane=self.lane)
        return handle.value

    def drain(self) -> float:
        """Settle every still-pending ledger op (e.g. overlapped p2p
        recvs that nothing explicitly waited on)."""
        return self.clock.drain_async(lane=self.lane)

    def p2p_recv(self, role_key, tag: str, src: int, dst: int, value,
                 overlap: bool = False):
        """Receive `value` sent by src. In REPLAY mode, if src is
        outside the sandbox, the recorded tensor is served instead; if
        src is inside (batch migration), the live value passes through
        (§4.3). With overlap=True the transfer is issued on the link's
        ledger channel ((src, dst) — full duplex, so each direction is
        its own stream) instead of blocking the lane; the barrier at
        the end of the iteration settles whatever stayed exposed."""
        idx = self._next_idx(role_key, "p2p", tag)
        key = (role_key, "p2p", tag, idx)
        if self.mode == CommMode.REPLAY:
            if src in self.sandbox_members and value is not None:
                return value
            self.replay_bytes += self.tape.get(key).nbytes
            return self.tape.get(key)
        nb = value.nbytes
        if overlap:
            self.clock.issue_async(("p2p", src, dst),
                                   self._cost_seconds(nb, inter=True),
                                   f"p2p:{tag}")
        else:
            self._charge(nb, inter=True, name=f"p2p:{tag}")
        if self.mode == CommMode.RECORD:
            self.tape.put(key, value)
            self.record_bytes += nb
        return value

    def p2p_send(self, role_key, tag: str, src: int, dst: int, value):
        """Sends are bypassed in REPLAY (do not affect caller state)."""
        if self.mode == CommMode.REPLAY and dst not in self.sandbox_members:
            return
        # charged on the recv side
        return

    def barrier(self, tag: str = "") -> None:
        """Iteration barrier: all in-flight comm must have completed,
        so the ledger is drained (exposing any remainder) first."""
        if self.mode == CommMode.REPLAY:
            return
        self.drain()
        self.clock.advance(self.cost.rtt_tcp * 2, f"barrier:{tag}",
                           lane=self.lane)
