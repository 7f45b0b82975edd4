"""Deterministic simulated clock with parallel-phase accounting.

The runtime advances time in *phases*: several nodes work concurrently
inside a phase, and the phase costs max(per-node time). Downtime vs
overlapped (background) time is tracked separately — the whole point of
TrainMover is moving work from the former lane to the latter.

The async ledger (issue_async / wait_async / drain_async) extends the
same idea to steady-state communication: a collective issued on a
channel progresses on that channel's own timeline while the issuing
lane keeps advancing (backward compute, other channels).  When the
lane finally blocks on the result, the blocked wall time splits into
the op's own exposed transfer seconds and the queueing delay spent
behind earlier ops on the same channel; the unexposed part of the cost
is tallied in comm_hidden so benchmarks can report an overlap
fraction.  Ops sharing a channel serialize (one NCCL stream per
communicator); distinct channels are concurrent.

Conservation invariant (property-tested): per channel, once no op is
in flight, issued == exposed + hidden exactly, with hidden >= 0 and
queueing delay in its own non-negative bucket.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# The lane universe. Static analysis (repro.analysis charge-coverage)
# and the runtime ledger agree on exactly this set: a typo'd lane would
# otherwise open a fourth bucket that no report ever reads.
KNOWN_LANES = frozenset({"train", "downtime", "overlap"})


@dataclass
class PhaseRecord:
    name: str
    start: float
    duration: float
    lane: str                     # "downtime" | "overlap" | "train"
    per_node: Dict[int, float] = field(default_factory=dict)


@dataclass
class AsyncOp:
    """One in-flight collective on the per-channel ledger."""
    handle: int
    channel: Any
    name: str
    issued_at: float
    cost: float
    ready_at: float               # channel-serialized completion time


class SimClock:
    def __init__(self):
        self.now = 0.0
        self.phases: List[PhaseRecord] = []
        self._lane_totals: Dict[str, float] = {}
        # ---- async-collective ledger
        self._channel_free: Dict[Any, float] = {}
        self._inflight: Dict[int, AsyncOp] = {}
        self._next_handle = 0
        self.comm_exposed = 0.0   # ledger seconds charged to a lane
        self.comm_hidden = 0.0    # ledger seconds hidden under other work
        self.comm_queued = 0.0    # queueing delay surfaced at a wait
        # per-channel breakdown (invariant: once a channel has no
        # in-flight ops, issued == exposed + hidden for that channel;
        # queueing delay is its own bucket, never negative)
        self.issued_by_channel: Dict[Any, float] = {}
        self.exposed_by_channel: Dict[Any, float] = {}
        self.hidden_by_channel: Dict[Any, float] = {}
        self.queued_by_channel: Dict[Any, float] = {}

    def advance(self, seconds: float, name: str = "",
                lane: str = "train") -> None:
        assert seconds >= 0
        assert lane in KNOWN_LANES, f"unknown lane {lane!r}"
        self.phases.append(PhaseRecord(name, self.now, seconds, lane))
        self.now += seconds
        self._lane_totals[lane] = self._lane_totals.get(lane, 0.0) + seconds

    # ------------------------------------------------------ async ledger
    def issue_async(self, channel, seconds: float, name: str = "") -> int:
        """Enqueue `seconds` of work on `channel` without blocking the
        lane. Returns a handle for wait_async. Ops on one channel
        serialize behind each other; channels run concurrently."""
        assert seconds >= 0
        start = max(self.now, self._channel_free.get(channel, 0.0))
        ready = start + seconds
        self._channel_free[channel] = ready
        h = self._next_handle
        self._next_handle += 1
        self._inflight[h] = AsyncOp(h, channel, name, self.now, seconds,
                                    ready)
        self.issued_by_channel[channel] = \
            self.issued_by_channel.get(channel, 0.0) + seconds
        return h

    def wait_async(self, handle: int, lane: str = "train") -> float:
        """Block the lane on an issued op. The blocked wall time,
        max(0, ready_at - now), splits into the op's own exposed
        transfer seconds (at most `cost`) and the queueing delay it
        spent behind earlier ops on its channel (the remainder — NOT
        comm cost, so it lands in the `queued` bucket, never as
        negative hidden time). The unexposed part of the cost is
        hidden. Waiting twice — e.g. after a drain — is a no-op.
        Returns the seconds the lane was blocked (exposed + queued)."""
        op = self._inflight.pop(handle, None)
        if op is None:
            return 0.0
        blocked = max(0.0, op.ready_at - self.now)
        exposed = min(blocked, op.cost)
        queued = blocked - exposed
        hidden = op.cost - exposed
        assert hidden >= 0.0 and queued >= 0.0, (hidden, queued)
        self.comm_exposed += exposed
        self.comm_hidden += hidden
        self.comm_queued += queued
        self.exposed_by_channel[op.channel] = \
            self.exposed_by_channel.get(op.channel, 0.0) + exposed
        self.hidden_by_channel[op.channel] = \
            self.hidden_by_channel.get(op.channel, 0.0) + hidden
        if queued > 0:
            self.queued_by_channel[op.channel] = \
                self.queued_by_channel.get(op.channel, 0.0) + queued
        if blocked > 0:
            self.advance(blocked, f"exposed:{op.name}", lane=lane)
        return blocked

    def drain_async(self, lane: str = "train") -> float:
        """Wait on every in-flight op (issue order). After a drain the
        lane has caught up with the slowest channel."""
        total = 0.0
        for h in sorted(self._inflight):
            total += self.wait_async(h, lane=lane)
        return total

    def pending_async(self) -> int:
        return len(self._inflight)

    def overlap_fraction(self) -> float:
        """Share of ledger comm seconds hidden under other work."""
        tot = self.comm_exposed + self.comm_hidden
        return self.comm_hidden / tot if tot > 0 else 0.0

    @contextmanager
    def parallel(self, name: str, lane: str = "downtime"):
        """Concurrent work: `p.track(node, seconds)` accumulates per-node
        sequential cost; the phase advances by the max.

        Crash-consistent: an exception inside the tracked body (e.g. a
        mid-switch fault injection) still records the partial phase and
        advances the clock by whatever was tracked before the fault, so
        `now` and the lane totals never go inconsistent."""
        assert lane in KNOWN_LANES, f"unknown lane {lane!r}"
        rec = PhaseRecord(name, self.now, 0.0, lane)

        class _P:
            def track(_self, node: int, seconds: float) -> None:
                rec.per_node[node] = rec.per_node.get(node, 0.0) + seconds

        try:
            yield _P()
        finally:
            rec.duration = max(rec.per_node.values(), default=0.0)
            self.phases.append(rec)
            self.now += rec.duration
            self._lane_totals[lane] = self._lane_totals.get(lane, 0.0) \
                + rec.duration

    def lane_total(self, lane: str) -> float:
        return self._lane_totals.get(lane, 0.0)

    def window(self, t0: float, t1: float, lane: Optional[str] = None):
        """Phases overlapping [t0, t1), with durations *clipped* to the
        window: a phase straddling either boundary contributes exactly
        its in-window portion, so downtime windows around injected
        faults are exact rather than attributed by start time alone."""
        out = []
        for p in self.phases:
            if lane is not None and p.lane != lane:
                continue
            end = p.start + p.duration
            s, e = max(p.start, t0), min(end, t1)
            if e > s or (p.duration == 0.0 and t0 <= p.start < t1):
                dur = max(e - s, 0.0)
                # per-node seconds scale with the clip (and are copied:
                # windowed records must never alias the phase history)
                frac = dur / p.duration if p.duration > 0 else 0.0
                per_node = {n: v * frac for n, v in p.per_node.items()}
                out.append(PhaseRecord(p.name, s, dur, p.lane, per_node))
        return out
