"""Two-phase delta-based CCL setup (§5.2).

Phase 1 (overlapped with training, zero device-memory overhead):
  * stayers reuse their existing TCP bootstrap mesh and handshake only
    with the joiners (delta bootstrap);
  * topology info is exchanged and every participant locally computes
    the delta reconfiguration plan;
  * joiners establish whatever is local to them: intra-machine channels
    and joiner<->joiner inter connections from the plan;
  * all phase-1 state (sockets, topology tables) is HOST memory.

Phase 2 (`ccl_switchover`, the only network downtime):
  * drop stayer->leaver QPs, establish the delta stayer<->joiner QPs,
  * flip the group to ACTIVE.

Costs are charged to the SimClock; device ledgers enforce the
zero-overhead claim.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster, Machine
from repro_torch.cluster.simclock import SimClock
from repro_torch.core.groups import (CommGroup, DeltaPlan, GroupState,
                                     apply_delta, compute_delta_plan,
                                     revert_delta)

HOST_TOPO_BYTES = 512 * 1024       # topology tables per group (host)
HOST_SOCK_BYTES = 64 * 1024        # per bootstrap peer (host)


@dataclass
class PhaseReport:
    group: str
    phase1_time_stayers: float = 0.0
    phase1_time_joiners: float = 0.0
    phase2_time: float = 0.0
    qps_added: int = 0
    qps_dropped: int = 0
    qps_inherited: int = 0
    qps_prewired: int = 0          # joiner<->joiner links done in phase 1


def ccl_prepare_stayers(group: CommGroup, replace: Dict[int, int],
                        cluster: Cluster, clock: SimClock,
                        cost: CostModel = DEFAULT,
                        lane: str = "overlap") -> PhaseReport:
    """Phase 1, stayer side. Training keeps running (lane=overlap)."""
    rep = PhaseReport(group.gid)
    plan = compute_delta_plan(group, replace)
    joiners = sorted(set(replace.values()))
    stayers = [m for m in group.members if m not in replace]

    with clock.parallel(f"phase1:{group.gid}", lane=lane) as p:
        # delta bootstrap: stayers handshake with each joiner over the
        # existing TCP mesh (reused; only joiner endpoints are new).
        for s in stayers:
            t = cost.rtt_tcp * 4 * len(joiners)
            p.track(s, t)
            cluster[s].host.alloc(HOST_SOCK_BYTES * len(joiners),
                                  f"bootstrap:{group.gid}", clock.now)
        # topology exchange + local delta computation (host-side)
        topo_t = cost.topo_discovery(len(joiners) + 1) * 0.2
        for s in stayers:
            p.track(s, topo_t)
            cluster[s].host.alloc(HOST_TOPO_BYTES, f"topo:{group.gid}",
                                  clock.now)
        rep.phase1_time_stayers = max(
            cost.rtt_tcp * 4 * len(joiners) + topo_t, 0.0)

    group.pending_plan = plan
    group.pending_members = plan.new_members
    group.bootstrap_peers |= set(joiners)
    group.state = GroupState.PREPARING
    rep.qps_inherited = plan.inherited
    return rep


def ccl_prepare_joiners(group: CommGroup, replace: Dict[int, int],
                        cluster: Cluster, clock: SimClock,
                        cost: CostModel = DEFAULT,
                        lane: str = "overlap") -> PhaseReport:
    """Phase 1, joiner side: bootstrap into the group, set up local
    (intra-machine) channels and any joiner<->joiner inter links."""
    rep = PhaseReport(group.gid)
    if group.pending_plan is None:
        group.pending_plan = compute_delta_plan(group, replace)
        group.pending_members = group.pending_plan.new_members
    plan = group.pending_plan
    joiners = sorted(set(replace.values()))
    jset = set(joiners)

    prewired = [c for c in plan.add if c.src in jset and c.dst in jset]
    with clock.parallel(f"phase1j:{group.gid}", lane=lane) as p:
        for j in joiners:
            t = cost.bootstrap(len(group.members)) * 0.3  # reuse stayers'
            t += cost.topo_discovery(len(group.members)) * 0.2
            # intra-machine channels: local, immediate (CUDA-IPC class)
            t += cost.chan_setup_intra * group.channels
            mine = [c for c in prewired if j in (c.src, c.dst)]
            t += cost.qp_setup * len(mine)
            p.track(j, t)
            cluster[j].host.alloc(
                HOST_TOPO_BYTES + HOST_SOCK_BYTES * len(group.members),
                f"topo:{group.gid}", clock.now)
            rep.phase1_time_joiners = max(rep.phase1_time_joiners, t)
    for c in prewired:
        group.connections[c.key()] = c
    rep.qps_prewired = len(prewired)
    group.state = GroupState.READY_TO_SWITCHOUT
    return rep


def ccl_switchover(group: CommGroup, cluster: Cluster, clock: SimClock,
                   cost: CostModel = DEFAULT,
                   lane: str = "downtime") -> PhaseReport:
    """Phase 2: splice the delta inter-machine connections. This is the
    sole CCL contribution to downtime (§5.2 step 3)."""
    assert group.state in (GroupState.READY_TO_SWITCHOUT,
                           GroupState.PREPARING), group.state
    plan = group.pending_plan
    assert plan is not None and plan.kind == "replace", plan
    rep = PhaseReport(group.gid)
    jset = set(plan.replace.values())
    todo_add = [c for c in plan.add if c.key() not in group.connections]
    with clock.parallel(f"phase2:{group.gid}", lane=lane) as p:
        per_machine: Dict[int, int] = {}
        for c in todo_add:
            per_machine[c.src] = per_machine.get(c.src, 0) + 1
            per_machine[c.dst] = per_machine.get(c.dst, 0) + 1
        for mid, n in per_machine.items():
            # QP re-establishment happens in parallel across machines;
            # each machine serializes its own verbs work.
            p.track(mid, cost.qp_setup * n)
    # device memory: swap-in-place — old QP buffers freed as new ones
    # allocate (paper App. A "reuse mechanism"), net zero per ledger.
    # Sorted: alloc-event order feeds the device-ledger history, which
    # the parity tests compare bitwise across runs and against the
    # reference.
    for mid in sorted(set(plan.replace.values())):
        m = cluster[mid]
        m.device.alloc(0.0, f"qps:{group.gid}", clock.now)
    apply_delta(group, plan)
    rep.phase2_time = clock.phases[-1].duration
    rep.qps_added = len(todo_add)
    rep.qps_dropped = len(plan.drop)
    rep.qps_inherited = plan.inherited
    # host-side staging freed
    for mid in group.members:
        cluster[mid].host.free(f"topo:{group.gid}", clock.now)
        cluster[mid].host.free(f"bootstrap:{group.gid}", clock.now)
    return rep


def ccl_reshard_switchover(group: CommGroup, cluster: Cluster,
                           clock: SimClock, cost: CostModel = DEFAULT,
                           lane: str = "downtime") -> PhaseReport:
    """Phase 2 of an intra-machine re-shard: the victim's QPs re-bind
    to the survivor device layout. Unlike a membership switchover no
    topology changes — the same (src, dst, channel) edges are dropped
    and re-established — but the verbs work is real: the victim and
    each ring neighbour re-create their side of every victim-adjacent
    QP, machines in parallel. apply_delta then flips the (identical)
    connection set back in and clears the pending plan."""
    assert group.state in (GroupState.READY_TO_SWITCHOUT,
                           GroupState.PREPARING), group.state
    plan = group.pending_plan
    assert plan is not None and plan.kind == "reshard", plan
    rep = PhaseReport(group.gid)
    with clock.parallel(f"reshard2:{group.gid}", lane=lane) as p:
        per_machine: Dict[int, int] = {}
        for c in plan.add:
            per_machine[c.src] = per_machine.get(c.src, 0) + 1
            per_machine[c.dst] = per_machine.get(c.dst, 0) + 1
        for mid, n in per_machine.items():
            p.track(mid, cost.qp_setup * n)
    apply_delta(group, plan)
    rep.phase2_time = clock.phases[-1].duration
    rep.qps_added = len(plan.add)
    rep.qps_dropped = len(plan.drop)
    rep.qps_inherited = plan.inherited
    return rep


def ccl_resize_switchover(group: CommGroup, cluster: Cluster,
                          clock: SimClock, cost: CostModel = DEFAULT,
                          lane: str = "downtime") -> PhaseReport:
    """Phase 2 of a degraded-mode DP resize: contract (shrink) or
    expand (grow) each channel ring around the splice point. Dropped
    QPs to a dead leaver cost nothing (teardown is local); only the
    splice-adjacent re-establishments pay verbs work, machines in
    parallel — so a shrink is near-free and a grow costs the same as a
    joiner splice. No state moves here: DP replicas hold
    bitwise-identical stage state, the engine's rank-hosting overlay
    (dp_retire / dp_restaff) handles the payload side."""
    assert group.state in (GroupState.READY_TO_SWITCHOUT,
                           GroupState.PREPARING), group.state
    plan = group.pending_plan
    assert plan is not None and plan.kind == "dp_resize", plan
    rep = PhaseReport(group.gid)
    todo_add = [c for c in plan.add if c.key() not in group.connections]
    with clock.parallel(f"resize2:{group.gid}", lane=lane) as p:
        per_machine: Dict[int, int] = {}
        for c in todo_add:
            per_machine[c.src] = per_machine.get(c.src, 0) + 1
            per_machine[c.dst] = per_machine.get(c.dst, 0) + 1
        for mid, n in per_machine.items():
            p.track(mid, cost.qp_setup * n)
    apply_delta(group, plan)
    rep.phase2_time = clock.phases[-1].duration
    rep.qps_added = len(todo_add)
    rep.qps_dropped = len(plan.drop)
    rep.qps_inherited = plan.inherited
    return rep


def ccl_revert_switchover(group: CommGroup, plan: DeltaPlan,
                          cluster: Cluster, clock: SimClock,
                          cost: CostModel = DEFAULT,
                          lane: str = "downtime") -> float:
    """Rollback of an already-applied phase 2: re-splice the leavers
    back into the rings (inverse delta) so a fault that lands between
    per-group switchovers leaves every group on a consistent epoch.
    The QP work mirrors the forward splice — the dropped connections
    are re-established, machines in parallel — and the plan is
    re-staged as pending, so the later re-switch needs no phase 1.
    Returns the seconds charged."""
    with clock.parallel(f"revert:{group.gid}", lane=lane) as p:
        per_machine: Dict[int, int] = {}
        for c in plan.drop:            # re-added on the way back
            per_machine[c.src] = per_machine.get(c.src, 0) + 1
            per_machine[c.dst] = per_machine.get(c.dst, 0) + 1
        for mid, n in per_machine.items():
            p.track(mid, cost.qp_setup * n)
    revert_delta(group, plan)
    return clock.phases[-1].duration


def switchover_many(groups: List[CommGroup], cluster: Cluster,
                    clock: SimClock, cost: CostModel = DEFAULT,
                    lane: str = "downtime") -> List[PhaseReport]:
    """Phase 2 across several groups concurrently (each machine
    serializes its own QP work; machines run in parallel)."""
    reports = []
    per_machine: Dict[int, int] = {}
    staged: List[Tuple[CommGroup, DeltaPlan, list]] = []
    for group in groups:
        assert group.state in (GroupState.READY_TO_SWITCHOUT,
                               GroupState.PREPARING), group.state
        plan = group.pending_plan
        assert plan is not None and plan.kind == "replace", plan
        todo = [c for c in plan.add if c.key() not in group.connections]
        staged.append((group, plan, todo))
        for c in todo:
            per_machine[c.src] = per_machine.get(c.src, 0) + 1
            per_machine[c.dst] = per_machine.get(c.dst, 0) + 1
    with clock.parallel("phase2:batch", lane=lane) as p:
        for mid, n in per_machine.items():
            p.track(mid, cost.qp_setup * n)
    for group, plan, todo in staged:
        rep = PhaseReport(group.gid)
        rep.qps_added = len(todo)
        rep.qps_dropped = len(plan.drop)
        rep.qps_inherited = plan.inherited
        rep.phase2_time = clock.phases[-1].duration
        for mid in sorted(set(plan.replace.values())):
            cluster[mid].device.alloc(0.0, f"qps:{group.gid}", clock.now)
        apply_delta(group, plan)
        for mid in group.members:
            cluster[mid].host.free(f"topo:{group.gid}", clock.now)
            cluster[mid].host.free(f"bootstrap:{group.gid}", clock.now)
        reports.append(rep)
    return reports


def full_reinit(group: CommGroup, cluster: Cluster, clock: SimClock,
                cost: CostModel = DEFAULT, lane: str = "downtime",
                new_members: Optional[List[int]] = None) -> float:
    """Baseline: destroy + rebuild the whole group (Oobleck/Parcae/
    restart path). Returns the time charged."""
    if new_members is not None:
        group.members = list(new_members)
    n = len(group.members)
    t = cost.bootstrap(n) + cost.topo_discovery(n)
    conns = group.establish_all()
    inter = sum(1 for c in group.connections.values() if c.inter)
    t += cost.qp_setup * inter / max(n, 1) + \
        cost.chan_setup_intra * group.channels
    clock.advance(t, f"full_reinit:{group.gid}", lane=lane)
    return t
