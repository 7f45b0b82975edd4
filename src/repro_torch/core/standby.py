"""General standby (§6): a role-agnostic pre-warmed machine.

Rank symmetry means at most three distinct role types exist (first /
middle / last pipeline stage; "only" when PP=1). The standby runs one
sandboxed shadow iteration per role type at job start — all compiled
artifacts coexist (a few hundred KB each on real HW; here: the built
stage programs) — and retains the *middle* state since middle stages
dominate. Promotion to a first/last role only touches the small layer
delta (embedding / output head).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster, Machine, NodeStatus
from repro_torch.cluster.simclock import SimClock
from repro_torch.core.engine import PipelineEngine, stage_type
from repro_torch.train.checkpoint import tree_bytes


def role_types_for(pp: int) -> List[str]:
    if pp == 1:
        return ["only"]
    if pp == 2:
        return ["first", "last"]
    return ["first", "middle", "last"]


def representative_stage(role_type: str, pp: int) -> int:
    return {"only": 0, "first": 0, "middle": 1 if pp > 2 else 0,
            "last": pp - 1}[role_type]


@dataclass
class StandbyReport:
    machine: int
    roles_warmed: List[str]
    prep_seconds: float
    compile_seconds: Dict[str, float] = field(default_factory=dict)
    retained_role: str = "middle"


def prepare_general_standby(engine: PipelineEngine, machine: Machine,
                            clock: SimClock, cost: CostModel = DEFAULT,
                            lane: str = "overlap") -> StandbyReport:
    """Warm the standby for every role type (overlapped with training).

    Also performs CCL phase-1-equivalent prep: the standby bootstraps
    its control/TCP mesh once so any later promotion goes straight to
    the switching phase."""
    t0 = clock.now
    pp = engine.pp
    roles = role_types_for(pp)
    rep = StandbyReport(machine.mid, roles, 0.0)
    for rt in roles:
        stage = representative_stage(rt, pp)
        role = engine.shadow_iteration(machine, rt, stage, lane=lane)
        rep.compile_seconds[rt] = role.compile_seconds
    # retain the dominant role's sandbox state (middle, or last resort)
    retained = "middle" if "middle" in roles else roles[0]
    rep.retained_role = retained
    # pre-allocate the gradient bucket for the worst-case role now, off
    # the critical path — promotion's state sync then skips the alloc
    grad_bytes = max(engine.grad_buffer_bytes(representative_stage(rt, pp))
                     for rt in roles)
    machine.device.alloc(grad_bytes, "grad_buffer", clock.now)
    # bootstrap/topology prep with the whole job (host memory only)
    n = len(engine.grid)
    clock.advance(cost.bootstrap(n) + cost.topo_discovery(n) * 0.2,
                  f"standby_bootstrap:{machine.mid}", lane=lane)
    machine.host.alloc(1 << 20, "standby_topo", clock.now)
    machine.status = NodeStatus.STANDBY
    rep.prep_seconds = clock.now - t0
    return rep


def replenish(engine: PipelineEngine, cluster: Cluster,
              standbys: List[int], clock: SimClock,
              cost: CostModel = DEFAULT, target: int = 1,
              lane: str = "overlap") -> List[int]:
    """Top the standby pool back up to `target` machines from the
    elastic pool (growing the cluster if it is empty), preparing each
    as a general standby off the critical path. Mutates `standbys` in
    place and returns the newly prepared machine ids — shared by job
    bootstrap and by standby-loss replacement."""
    added: List[int] = []
    while len(standbys) < target:
        idle = [m.mid for m in cluster.by_status(NodeStatus.IDLE)
                if m.mid not in standbys and m.is_healthy]
        mid = idle[0] if idle else cluster.add_machine().mid
        prepare_general_standby(engine, cluster[mid], clock, cost,
                                lane=lane)
        standbys.append(mid)
        added.append(mid)
    return added


def promote_standby(engine: PipelineEngine, machine: Machine,
                    target_stage: int, clock: SimClock,
                    cost: CostModel = DEFAULT,
                    lane: str = "downtime") -> float:
    """Promote to the failed machine's role. Middle-stage failures are
    covered by the retained warm state; first/last only add the layer
    delta (embedding/head allocation — params come with state sync).
    Returns seconds charged to downtime."""
    rt = stage_type(target_stage, engine.pp)
    t = 0.0
    if rt not in machine.warm_roles:
        # not pre-warmed for this type (shouldn't happen for a general
        # standby) — compile on the critical path.
        role = engine.compile_role(target_stage, fresh=True)
        machine.warm_roles[rt] = role
        t += engine.compile_charge(role)
    if rt in ("first", "last", "only"):
        # layer-delta: allocate embedding/output buffers (ms-level).
        cfg = engine.cfg
        delta_bytes = cfg.vocab_size * cfg.d_model * 4
        machine.device.alloc(0.0, "role_delta", clock.now)  # net-zero swap
        t += cost.transfer(delta_bytes, cost.bw_intra_node)
    clock.advance(t, f"promote:{machine.mid}->s{target_stage}", lane=lane)
    machine.status = NodeStatus.PREPARING
    return t
