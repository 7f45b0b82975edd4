"""Telemetry-driven recovery-policy engine (Chameleon-style).

The `gpu_fault` auto policy used to be a single hard-coded threshold:
re-shard while the surviving-device fraction was at least
`CostModel.reshard_min_fraction = 0.5`, else migrate. The repo's own
measurement (BENCH_scale.json policy_boundary) says that constant was
wrong — at yi-34b state sizes in-place re-shard beats migrate-away on
downtime at EVERY surviving fraction down to 1/8, because re-shard
pays only the lost-fraction DP-peer re-fetch (plus an NVLink-speed
local re-layout) where migrate pays a fully-exposed whole-state ship
at the same QP-splice cost. A fixed fraction cannot express that; a
live CostModel query can.

`PolicyEngine.decide` scores the four recovery policies the runtime
supports — **migrate** (standby promotion / planned drain),
**reshard** (in-place re-split across surviving devices),
**dp_shrink** (degraded-mode DP-chain retirement) and
**ckpt_restart** (storage checkpoint restart) — against a `Telemetry`
snapshot captured at fault time: standby inventory and idle spares
from the ledger, the victim's flat state size from the engine spec,
its surviving-GPU fraction, storage and interconnect bandwidths, the
advance-notice window, and the degraded-throughput tail over the
expected-time-to-maintenance horizon. Each candidate gets a predicted
cost breakdown whose terms mirror the charge sites the execution
paths actually hit (the `drain` barrier, the exposed state transfers
of `state_sync`, the per-group phase-2 QP work of `two_phase`, the
Megatron restart window of `baselines`), so the ranking tracks the
measured sweep — pinned by `tests/test_policy.py` against the
checked-in BENCH_scale.json rows.

Decision rules:

- **feasibility encodes the capacity tiers**: dp_shrink is only a
  candidate once the pool is dry in a bounded cluster with degraded
  mode armed — the runtime never trades committed throughput for
  downtime while spare capacity exists; reshard is only a candidate
  for a partial-GPU fault above the `reshard_min_fraction` safety
  clamp (below it too few survivors remain to host the shard at a
  bounded slowdown — the knob's only remaining role);
- feasible candidates rank by **predicted downtime**, ties broken by
  the smaller **degraded tail** (throughput forfeited over
  `maintenance_horizon_s`), then by a fixed preference order — so the
  decision is deterministic given the snapshot;
- the decision is **journaled** (`policy` record) before dispatch, so
  a crash-restarted controller adopting the in-flight run sees the
  same choice it is replaying (and `tests/test_policy.py` proves it).

The campaign measures the engine's regret: every GPU-granular
decision scenario runs under `auto` plus each feasible fixed policy,
and `summarize()` asserts `auto_never_worse_ok` — auto's measured
downtime never exceeds the best fixed policy's (bitwise, since auto
dispatches into the identical recovery path it ranked first).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.core import baselines

# fixed preference order: the final tie-break AND the ranking order of
# equally-infeasible candidates in the reported breakdown
KNOWN_POLICIES = ("migrate", "reshard", "dp_shrink", "ckpt_restart")

# fault kinds a decision can be asked for (Controller dispatch sites)
FAULT_KINDS = ("gpu_fault", "failure", "preemption")


@dataclass(frozen=True)
class Telemetry:
    """Cluster snapshot at fault time — plain JSON-typed fields only,
    so a decision record survives the journal round trip bitwise."""
    victim: int
    surviving_fraction: float     # Machine.healthy_fraction of the victim
    state_bytes: int              # victim's flat stage state (params+opt)
    standbys: int                 # warm standby inventory (ledger)
    idle_spares: int              # healthy idle machines outside the pool
    elastic_pool: bool            # scheduler can grow the cluster
    degraded_mode: bool           # DP-shrink continuation armed
    can_shrink: bool              # >1 physically-staffed DP chain left
    dp: int
    pp: int
    affected_groups: int          # comm groups the victim participates in
    channels: int                 # NCCL channels per group
    storage_ok: bool              # a storage checkpoint exists
    storage_bw: float             # bytes/s per GPU (0 = CostModel default)
    notice_s: float = 0.0         # advance-notice window (preemptions)
    model_params: float = 0.0     # for the ckpt-restart baseline window
    total_gpus: int = 0

    def to_record(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class PolicyCost:
    """Predicted cost breakdown for one candidate policy."""
    policy: str
    feasible: bool
    downtime_s: float = 0.0       # predicted exposed (downtime-lane) cost
    overlap_s: float = 0.0        # predicted hidden preparation work
    tail_s: float = 0.0           # throughput forfeited over the horizon
    why: str = ""                 # one-line feasibility / term provenance

    def to_record(self) -> Dict[str, Any]:
        return {"policy": self.policy, "feasible": self.feasible,
                "downtime_s": round(self.downtime_s, 6),
                "overlap_s": round(self.overlap_s, 6),
                "tail_s": round(self.tail_s, 6), "why": self.why}


@dataclass
class PolicyDecision:
    kind: str                     # fault kind the decision answers
    chosen: str                   # the dispatched policy
    costs: List[PolicyCost]       # ranked: feasible first, by downtime
    telemetry: Telemetry

    def cost_of(self, policy: str) -> PolicyCost:
        for c in self.costs:
            if c.policy == policy:
                return c
        raise KeyError(policy)

    def to_record(self) -> Dict[str, Any]:
        """JSON-typed journal payload (`policy` record): enough to
        audit — and re-derive — the choice after a crash restart."""
        return {"kind": self.kind, "victim": self.telemetry.victim,
                "chosen": self.chosen,
                "ranking": [c.to_record() for c in self.costs],
                "telemetry": self.telemetry.to_record()}


class PolicyEngine:
    """Scores recovery policies against live telemetry via the
    CostModel. Stateless and deterministic: the same snapshot always
    yields the same decision (the determinism the journal replay and
    the campaign's regret accounting both lean on)."""

    def __init__(self, cost: CostModel = DEFAULT):
        self.cost = cost

    # ------------------------------------------------------ predictions
    def _qp_phase2_s(self, tele: Telemetry) -> float:
        """Per-group phase-2 QP verbs work, groups switched serially
        (the per-group `switch:<gid>` steps): the victim re-establishes
        both ring directions of every channel, machines in parallel —
        mirrors two_phase.ccl_switchover / ccl_reshard_switchover."""
        per_group = self.cost.qp_setup * tele.channels * 2
        return per_group * tele.affected_groups

    def _migrate(self, tele: Telemetry, kind: str) -> PolicyCost:
        c = self.cost
        has_capacity = (tele.standbys > 0 or tele.idle_spares > 0
                        or tele.elastic_pool)
        ship = c.transfer(tele.state_bytes, c.bw_state_transfer, c.rtt_tcp)
        qp = self._qp_phase2_s(tele)
        if kind == "failure":
            # unexpected path: detect, promote the warm standby, then
            # the state recover + QP splice are all inside the stall
            down = c.detect_failure + ship + qp
            over, why = 0.0, "detect + state recover + QP splice"
        elif kind == "preemption" and tele.notice_s > 0.0:
            # planned drain: prepare/warmup/state-ship race the notice
            # deadline; only the un-hidden remainder is exposed
            hidden = min(ship, tele.notice_s)
            down = c.iteration_barrier + (ship - hidden) + qp
            over, why = hidden, "drain: notice window hides the ship"
        else:
            # planned leave of a degraded machine (train_during_prep
            # keeps it training, but the whole-state ship lands almost
            # fully exposed — the measured term that retires the old
            # fixed threshold)
            down = c.iteration_barrier + ship + qp
            over, why = 0.0, "barrier + whole-state ship + QP splice"
        if not has_capacity:
            why = "no standby, no spare, bounded pool"
        return PolicyCost("migrate", has_capacity, down, over, 0.0, why)

    def _reshard(self, tele: Telemetry, kind: str) -> PolicyCost:
        c = self.cost
        f = tele.surviving_fraction
        if kind != "gpu_fault":
            return PolicyCost("reshard", False,
                              why="machine lost, nothing to re-shard")
        if f < c.reshard_min_fraction or f <= 0.0:
            return PolicyCost(
                "reshard", False, tail_s=c.maintenance_horizon_s,
                why=f"surviving {f:.3f} below the "
                    f"{c.reshard_min_fraction} safety clamp")
        lost = tele.state_bytes * (1.0 - f)
        kept = tele.state_bytes - lost
        down = (c.iteration_barrier
                + c.transfer(lost, c.bw_state_transfer, c.rtt_tcp)
                + c.transfer(kept, c.bw_intra_node)
                + self._qp_phase2_s(tele))
        tail = c.maintenance_horizon_s * (1.0 - f)
        return PolicyCost("reshard", True, down, 0.0, tail,
                          "barrier + lost-fraction fetch + NVLink "
                          "re-layout + QP re-bind")

    def _dp_shrink(self, tele: Telemetry) -> PolicyCost:
        c = self.cost
        pool_dry = (tele.standbys == 0 and tele.idle_spares == 0
                    and not tele.elastic_pool)
        feasible = tele.degraded_mode and pool_dry and tele.can_shrink
        if not feasible:
            why = ("spare capacity exists — never trade committed "
                   "throughput for downtime" if not pool_dry
                   else "last staffed DP chain" if not tele.can_shrink
                   else "degraded mode not armed")
        else:
            why = "resize plan + near-free ring contraction"
        down = (c.iteration_barrier
                + c.dp_resize_plan_s * tele.affected_groups
                + c.qp_setup * tele.channels)
        tail = c.maintenance_horizon_s / max(tele.dp, 1)
        return PolicyCost("dp_shrink", feasible, down, 0.0, tail, why)

    def _ckpt_restart(self, tele: Telemetry) -> PolicyCost:
        c = self.cost
        if not tele.storage_ok:
            return PolicyCost("ckpt_restart", False,
                              why="no storage checkpoint saved")
        base = baselines.megatron_restart(
            max(tele.model_params, 1.0), max(tele.total_gpus, 1),
            cost=c, storage_bw=tele.storage_bw)
        return PolicyCost("ckpt_restart", True,
                          c.detect_failure + base.downtime, 0.0, 0.0,
                          "full stop + storage restore + cold rebuild")

    # --------------------------------------------------------- decision
    def score(self, tele: Telemetry, kind: str) -> List[PolicyCost]:
        """All candidates with their predicted breakdowns, ranked:
        feasible first, then by (downtime, tail, preference order)."""
        assert kind in FAULT_KINDS, kind
        costs = [self._migrate(tele, kind), self._reshard(tele, kind),
                 self._dp_shrink(tele), self._ckpt_restart(tele)]
        costs.sort(key=lambda pc: (not pc.feasible, pc.downtime_s,
                                   pc.tail_s,
                                   KNOWN_POLICIES.index(pc.policy)))
        return costs

    def decide(self, tele: Telemetry, kind: str) -> PolicyDecision:
        costs = self.score(tele, kind)
        if not costs[0].feasible:
            raise ValueError(
                f"no feasible recovery policy for {kind} fault "
                f"(victim {tele.victim}): "
                + "; ".join(f"{c.policy}: {c.why}" for c in costs))
        return PolicyDecision(kind, costs[0].policy, costs, tele)
