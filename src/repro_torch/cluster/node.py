"""Cluster nodes (machines) with device/host memory ledgers.

A *machine* is the migration granule (the paper migrates whole machines;
GPU-granularity is §9 future work). Each machine has a device-memory
ledger whose peak is the zero-overhead invariant the tests assert, plus
a payload that is either real arrays (CPU end-to-end runs) or symbolic
byte counts (scale benchmarks).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class NodeStatus(enum.Enum):
    IDLE = "idle"            # elastic pool
    TRAINING = "training"
    STANDBY = "standby"      # pre-warmed general standby
    PREPARING = "preparing"  # joiner in the preparation phase
    LEAVING = "leaving"
    DEAD = "dead"


@dataclass(frozen=True)
class Role:
    """Machine-level parallel role. TP lives inside the machine."""
    dp: int
    pp: int
    pp_degree: int

    @property
    def stage_type(self) -> str:
        if self.pp_degree == 1:
            return "only"
        if self.pp == 0:
            return "first"
        if self.pp == self.pp_degree - 1:
            return "last"
        return "middle"


class MemoryLedger:
    """Tracks allocations over (simulated) time; peak-above-baseline is
    the paper's 'zero memory overhead' check."""

    def __init__(self, capacity: float):
        self.capacity = capacity
        self.used = 0.0
        self.peak = 0.0
        self.timeline: List[Tuple[float, float]] = [(0.0, 0.0)]
        self._tags: Dict[str, float] = {}

    def alloc(self, nbytes: float, tag: str, t: float = 0.0) -> None:
        self.used += nbytes
        self._tags[tag] = self._tags.get(tag, 0.0) + nbytes
        if self.used > self.capacity:
            raise MemoryError(
                f"OOM: {self.used/2**30:.2f} GiB > "
                f"{self.capacity/2**30:.2f} GiB (alloc {tag})")
        self.peak = max(self.peak, self.used)
        self.timeline.append((t, self.used))

    def free(self, tag: str, t: float = 0.0,
             nbytes: Optional[float] = None) -> None:
        have = self._tags.get(tag, 0.0)
        amount = have if nbytes is None else min(nbytes, have)
        self._tags[tag] = have - amount
        self.used -= amount
        self.timeline.append((t, self.used))

    def tagged(self, tag: str) -> float:
        return self._tags.get(tag, 0.0)


@dataclass
class Machine:
    mid: int
    gpus: int = 8
    device_capacity: float = 8 * 80 * 2 ** 30      # 8 x A100-80GB
    status: NodeStatus = NodeStatus.IDLE
    role: Optional[Role] = None
    device: MemoryLedger = None
    host: MemoryLedger = None
    # training payload: real pytrees (numpy) or symbolic byte counts
    payload: Dict[str, Any] = field(default_factory=dict)
    # role -> compiled artifacts warmed up so far (sandbox results)
    warm_roles: Dict[str, Any] = field(default_factory=dict)
    straggle_factor: float = 1.0                    # >1 => slowed down
    failed_gpus: int = 0                            # GPU-granular faults

    def __post_init__(self):
        if self.device is None:
            self.device = MemoryLedger(self.device_capacity)
        if self.host is None:
            self.host = MemoryLedger(2 * 1024 * 2 ** 30)  # 2 TiB host

    @property
    def alive(self) -> bool:
        return self.status != NodeStatus.DEAD

    @property
    def is_healthy(self) -> bool:
        """Fit to (re)join the job: alive, no degraded devices, not a
        straggler — the predicate joiner allocation and standby
        replenishment gate on."""
        return self.alive and self.failed_gpus == 0 \
            and self.straggle_factor == 1.0

    def steady_state_bytes(self) -> float:
        return self.device.used

    def fail(self) -> None:
        self.status = NodeStatus.DEAD
        self.payload.clear()
        self.warm_roles.clear()
        self.device = MemoryLedger(self.device_capacity)
        self.host = MemoryLedger(self.host.capacity)

    @property
    def healthy_fraction(self) -> float:
        """Surviving-device fraction after GPU-granular faults: 1.0
        for a pristine machine, 0.0 when every device failed
        (`failed_gpus` is clamped to `gpus` by degrade_gpu). The ONE
        definition both the slowdown model below and the recovery
        policy layer (core/policy.py, Controller.gpu_fault) read — a
        second hand-rolled derivation of this ratio is how the two
        sites drift."""
        return (self.gpus - self.failed_gpus) / self.gpus

    def degrade_gpu(self, n: int = 1) -> None:
        """GPU-granularity fault (§9 future work): `n` devices on this
        machine fail but the machine survives — state stays resident
        and it keeps training at degraded speed until migrated away
        with advance notice (the expected-migration path, not a kill).
        Even a fully-degraded machine records the fault (is_healthy
        goes False) — only the slowdown denominator floors at one
        surviving device."""
        self.failed_gpus = min(self.failed_gpus + n, self.gpus)
        floor = 1.0 / self.gpus           # >= one surviving device
        self.straggle_factor = max(self.straggle_factor,
                                   1.0 / max(self.healthy_fraction,
                                             floor))


class Cluster:
    def __init__(self, n_machines: int, gpus_per_machine: int = 8,
                 device_capacity: float = 8 * 80 * 2 ** 30):
        self.machines: Dict[int, Machine] = {
            i: Machine(i, gpus_per_machine, device_capacity)
            for i in range(n_machines)}

    def __getitem__(self, mid: int) -> Machine:
        return self.machines[mid]

    def add_machine(self) -> Machine:
        mid = max(self.machines) + 1
        m = Machine(mid)
        self.machines[mid] = m
        return m

    def by_status(self, status: NodeStatus) -> List[Machine]:
        return [m for m in self.machines.values() if m.status == status]

    def by_role(self, role: Role) -> Optional[Machine]:
        for m in self.machines.values():
            if m.role == role and m.alive:
                return m
        return None
