"""Communication groups: membership, per-channel ring topology and
connection objects. This is the runtime analogue of an NCCL communicator
that TrainMover's two-phase setup manipulates.

A group holds `channels_per_group` rings (NCCL channels). Connections
are directed edges (src -> dst) per channel; intra-machine "connections"
(TP) are implicit (they never change during machine-level migration and
are inherited wholesale, §5.2).
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple


class GroupState(enum.Enum):
    INIT = "init"
    ACTIVE = "active"
    PREPARING = "preparing"            # phase 1 in flight
    READY_TO_SWITCHOUT = "ready_to_switchout"


@dataclass(frozen=True)
class Connection:
    src: int
    dst: int
    channel: int
    inter: bool = True                 # inter-machine (RDMA QP) link

    def key(self) -> Tuple[int, int, int]:
        return (self.src, self.dst, self.channel)


@dataclass
class CommGroup:
    gid: str
    kind: str                          # "dp" | "pp" | "tp" | "transfer"
    members: List[int]                 # ordered machine ids (ring order)
    channels: int = 8
    state: GroupState = GroupState.INIT
    connections: Dict[Tuple[int, int, int], Connection] = \
        field(default_factory=dict)
    # phase-1 staging area
    pending_plan: Optional["DeltaPlan"] = None
    pending_members: Optional[List[int]] = None
    bootstrap_peers: Set[int] = field(default_factory=set)

    def ring_connections(self, members: Optional[Sequence[int]] = None
                         ) -> List[Connection]:
        members = list(members if members is not None else self.members)
        conns = []
        n = len(members)
        if n < 2:
            return conns
        for ch in range(self.channels):
            # channel rings are rotated so traffic spreads across links
            order = members[ch % n:] + members[:ch % n]
            for i, src in enumerate(order):
                conns.append(Connection(src, order[(i + 1) % n], ch))
        return conns

    def establish_all(self) -> int:
        """Full (from-scratch) connection establishment."""
        self.connections = {c.key(): c for c in self.ring_connections()}
        self.state = GroupState.ACTIVE
        self.bootstrap_peers = set(self.members)
        return len(self.connections)

    def conn_count(self) -> int:
        return len(self.connections)

    def validate_rings(self) -> bool:
        """Every channel's connections must form one Hamiltonian cycle
        over the current membership. Groups shrunk below two members
        (degraded-mode dp_resize) carry no rings at all — they are valid
        iff they hold zero connections, mirroring build_groups skipping
        singleton groups at bootstrap."""
        if len(self.members) < 2:
            return not self.connections
        members = set(self.members)
        for ch in range(self.channels):
            nxt = {c.src: c.dst for c in self.connections.values()
                   if c.channel == ch}
            if set(nxt) != members:
                return False
            seen, cur = set(), self.members[0]
            for _ in range(len(members)):
                if cur in seen:
                    return False
                seen.add(cur)
                cur = nxt[cur]
            if seen != members or cur != self.members[0]:
                return False
        return True


@dataclass
class DeltaPlan:
    """Minimal channel-level reconfiguration for a membership change
    (kind="replace"), an intra-machine re-shard (kind="reshard":
    membership unchanged, the victim's channel endpoints re-bind to its
    surviving devices, so add == drop == the victim-adjacent edges), or
    a membership-cardinality change (kind="dp_resize": degraded-mode
    DP shrink removes members, re-grow inserts them; the ring contracts
    or expands around the splice point). Cardinality changes are not
    invertible from `replace`, so dp_resize plans carry `old_members`
    and revert_delta restores membership from it."""
    group: str
    replace: Dict[int, int]            # leaver -> joiner
    add: List[Connection] = field(default_factory=list)
    drop: List[Connection] = field(default_factory=list)
    inherited: int = 0                 # untouched connections
    new_members: List[int] = field(default_factory=list)
    kind: str = "replace"              # replace | reshard | dp_resize
    old_members: List[int] = field(default_factory=list)

    @property
    def delta_fraction(self) -> float:
        total = len(self.add) + self.inherited
        return len(self.add) / max(total, 1)


def compute_delta_plan(group: CommGroup,
                       replace: Dict[int, int]) -> DeltaPlan:
    """Delta topology (§5.2): splice joiners into each channel ring in
    place of their leavers. Only connections adjacent to a leaver
    change; everything else is inherited.

    With the in-place splice the new ring order equals the old with
    leavers substituted, so |add| = |drop| and both are bounded by
    2 * channels * |replace| regardless of group size.
    """
    old_members = list(group.members)
    new_members = [replace.get(m, m) for m in old_members]
    old_conns = {c.key(): c for c in group.ring_connections(old_members)}
    new_conns = {c.key(): c for c in group.ring_connections(new_members)}
    add = [c for k, c in new_conns.items() if k not in old_conns]
    drop = [c for k, c in old_conns.items() if k not in new_conns]
    inherited = len(new_conns) - len(add)
    return DeltaPlan(group.gid, dict(replace), add, drop, inherited,
                     new_members)


def compute_reshard_plan(group: CommGroup, mid: int) -> DeltaPlan:
    """Intra-machine re-shard delta: `mid` lost some (not all) of its
    devices and re-splits its shard across the survivors. Membership
    and ring order are untouched; only the connections adjacent to the
    victim are dropped and re-established, because their QPs bind to
    device buffers whose layout just changed. |add| == |drop| ==
    2 * channels for any group size (the victim has one in- and one
    out-edge per channel ring)."""
    assert mid in group.members, (group.gid, mid)
    adj = [c for c in group.connections.values()
           if mid in (c.src, c.dst)]
    return DeltaPlan(group.gid, {}, add=list(adj), drop=list(adj),
                     inherited=len(group.connections) - len(adj),
                     new_members=list(group.members), kind="reshard")


def compute_dp_resize_plan(group: CommGroup,
                           remove: Sequence[int] = (),
                           insert: Sequence[int] = (),
                           index: int = 0) -> DeltaPlan:
    """Membership-cardinality delta for degraded-mode DP resize.

    Shrink (`remove`): the named members leave and each channel ring
    contracts around the gap — the leavers' neighbours connect
    directly. Grow (`insert`): the named members splice into the ring
    at `index`. Both directions are computed as a ring diff, so only
    splice-adjacent connections change and everything else is
    inherited; a shrink followed by the matching grow restores the
    original ring exactly (the plan is self-inverse under
    revert_delta via `old_members`)."""
    assert not (remove and insert), "resize is shrink XOR grow"
    old_members = list(group.members)
    if remove:
        gone = set(remove)
        assert gone <= set(old_members), (group.gid, remove)
        new_members = [m for m in old_members if m not in gone]
    else:
        assert insert, "empty resize"
        assert not (set(insert) & set(old_members)), (group.gid, insert)
        i = min(max(index, 0), len(old_members))
        new_members = old_members[:i] + list(insert) + old_members[i:]
    old_conns = {c.key(): c for c in group.ring_connections(old_members)}
    new_conns = {c.key(): c for c in group.ring_connections(new_members)}
    add = [c for k, c in new_conns.items() if k not in old_conns]
    drop = [c for k, c in old_conns.items() if k not in new_conns]
    inherited = len(new_conns) - len(add)
    return DeltaPlan(group.gid, {}, add, drop, inherited, new_members,
                     kind="dp_resize", old_members=old_members)


def apply_delta(group: CommGroup, plan: DeltaPlan) -> None:
    for c in plan.drop:
        group.connections.pop(c.key(), None)
    for c in plan.add:
        group.connections[c.key()] = c
    group.members = list(plan.new_members)
    group.state = GroupState.ACTIVE
    group.pending_plan = None
    group.pending_members = None


def revert_delta(group: CommGroup, plan: DeltaPlan) -> None:
    """Exact inverse of apply_delta: re-splice the leavers back into
    the rings (crash-consistent rollback of a partially-switched
    migration). The plan is re-staged as pending so the group can
    switch again without re-running phase 1."""
    for c in plan.add:
        group.connections.pop(c.key(), None)
    for c in plan.drop:
        group.connections[c.key()] = c
    if plan.kind == "dp_resize":
        # cardinality changes can't be inverted from `replace`
        group.members = list(plan.old_members)
    else:
        # a new kind must choose its inverse explicitly — falling
        # through to the replace-map inversion would corrupt the rings
        assert plan.kind in ("replace", "reshard"), plan.kind
        inverse = {j: l for l, j in plan.replace.items()}
        group.members = [inverse.get(m, m) for m in plan.new_members]
    group.state = GroupState.READY_TO_SWITCHOUT
    group.pending_plan = plan
    group.pending_members = list(plan.new_members)
    assert group.validate_rings(), \
        f"rollback left {group.gid} with broken rings"


# ------------------------------------------------- journal (de)serde
def connection_to_list(c: Connection) -> List:
    return [c.src, c.dst, c.channel, c.inter]


def connection_from_list(v: Sequence) -> Connection:
    return Connection(int(v[0]), int(v[1]), int(v[2]), bool(v[3]))


def plan_to_dict(plan: DeltaPlan) -> dict:
    """JSON-typed DeltaPlan for the ControlJournal (int-keyed maps
    become pair lists so a serialize round trip is identity)."""
    return {
        "group": plan.group,
        "replace": sorted([l, j] for l, j in plan.replace.items()),
        "add": [connection_to_list(c) for c in plan.add],
        "drop": [connection_to_list(c) for c in plan.drop],
        "inherited": plan.inherited,
        "new_members": list(plan.new_members),
        "kind": plan.kind,
        "old_members": list(plan.old_members),
    }


def plan_from_dict(d: dict) -> DeltaPlan:
    return DeltaPlan(
        d["group"], {int(l): int(j) for l, j in d["replace"]},
        [connection_from_list(c) for c in d["add"]],
        [connection_from_list(c) for c in d["drop"]],
        int(d["inherited"]), list(d["new_members"]), d["kind"],
        list(d.get("old_members", [])))


def group_to_dict(g: CommGroup) -> dict:
    """Topology + staged plan of one group, journal-ready. Live
    connection sets are derivable from (members, channels) — rings are
    deterministic — so only the membership and the staged delta need
    to persist."""
    return {
        "gid": g.gid, "kind": g.kind, "members": list(g.members),
        "channels": g.channels, "state": g.state.value,
        "pending_plan": (plan_to_dict(g.pending_plan)
                         if g.pending_plan is not None else None),
    }


# ------------------------------------------------------------ layouts
def build_groups(dp: int, pp: int, machine_grid: Dict[Tuple[int, int], int],
                 channels: int = 8) -> Dict[str, CommGroup]:
    """Machine-level comm groups for a (dp, pp) grid. TP is
    intra-machine and needs no group object here.

    - one DP group per pipeline stage (ring over dp replicas)
    - one PP group per dp chain (ring over stages)
    """
    groups: Dict[str, CommGroup] = {}
    for stage in range(pp):
        members = [machine_grid[(d, stage)] for d in range(dp)]
        if len(members) > 1:
            groups[f"dp.s{stage}"] = CommGroup(
                f"dp.s{stage}", "dp", members, channels)
    for d in range(dp):
        members = [machine_grid[(d, stage)] for stage in range(pp)]
        if len(members) > 1:
            groups[f"pp.d{d}"] = CommGroup(
                f"pp.d{d}", "pp", members, channels)
    return groups


def groups_of(groups: Dict[str, CommGroup], mid: int) -> List[CommGroup]:
    return [g for g in groups.values() if mid in g.members]
