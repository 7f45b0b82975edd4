"""Resumable migration state machine (crash-consistent switching).

The controller's migration paths used to be straight-line call
sequences; a fault landing *inside* them (during phase-1 delta prep,
during sandboxed warmup, or between per-group switchovers) left groups
half-switched with no way to recover short of a full re-init. This
module makes the sequence an explicit state machine:

    IDLE -> DELTA_PREPARED -> JOINERS_WARMED -> SWITCHING -> COMMITTED

Each migration is a `MigrationRun`: an ordered list of named `Step`s
with a journaled step log. Steps already executed are skipped on
resume, so after a mid-switch fault the controller can

  1. roll partially-switched groups back to a consistent epoch
     (`rollback` replays the applied delta plans in reverse through
     `two_phase.ccl_revert_switchover`),
  2. settle the async ledger,
  3. handle the interleaved failure (standby promotion),
  4. drop exactly the journal steps the new failure set invalidated
     (`invalidate`), and
  5. `execute()` again — completed work is never redone.

Fault injection is first-class: a `FaultPoint` armed on the run raises
`MidSwitchFault` immediately before the matching step executes, which
is how the campaign models faults at `during_prepare`,
`during_warmup`, `mid_switchover` and `concurrent_second_failure`
timings. A FaultPoint carries an arbitrary victim *set*: K concurrent
failures landing anywhere in one switching window — stayers, DP peers,
a standby, the leaver itself, or the joiner — are absorbed by a single
rollback-replan-resume cycle (`Controller._recover_mid_switch`).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


class MigState(enum.Enum):
    IDLE = "idle"
    DELTA_PREPARED = "delta_prepared"      # phase-1 plans staged
    JOINERS_WARMED = "joiners_warmed"      # sandboxed warmup done
    SWITCHING = "switching"                # downtime window open
    COMMITTED = "committed"
    ABORTED = "aborted"                    # transient: fault being handled


@dataclass
class JournalEntry:
    step: str                  # step name, or abort/revert/resume marker
    state: str                 # machine state after the entry
    t: float                   # SimClock time when journaled
    info: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Step:
    """One resumable unit of a migration. `name` is stable across
    replans (keyed by group gid / leaver mid, never by joiner identity)
    so `MigrationRun.invalidate` can drop exactly the work a new
    failure set made stale."""
    name: str
    kind: str                  # prepare|warmup|train|cascade|barrier|
    #                          # xfer|switch|swap|detect|promote|
    #                          # recover|commit
    fn: Callable[[], None]
    state_after: Optional[MigState] = None


@dataclass
class FaultPoint:
    """Arms a fault at the `index`-th step of `kind` within a run: the
    run raises MidSwitchFault immediately before that step executes
    (once — `fired` latches)."""
    kind: str
    index: int = 0
    victims: List[int] = field(default_factory=list)
    fired: bool = False


class MidSwitchFault(Exception):
    """A failure landed inside a migration. Carries the journal step it
    interrupted and the machines it killed/degraded."""

    def __init__(self, step: str, victims: List[int]):
        super().__init__(f"fault at {step}: victims {victims}")
        self.step = step
        self.victims = list(victims)


@dataclass
class DeadlinePoint:
    """Arms a wall-clock deadline on a run: an advance-notice
    preemption revokes `victims` at `deadline` seconds of SimClock
    time, whatever step the run happens to be on. Unlike a FaultPoint
    it is time-triggered, not step-triggered — the run checks it
    before every step and raises NoticeExpired once (`fired` latches)
    if the clock has passed the deadline. `now` is a callable so the
    run reads the live clock, not a snapshot."""
    deadline: float
    now: Callable[[], float]
    victims: List[int] = field(default_factory=list)
    fired: bool = False


class NoticeExpired(MidSwitchFault):
    """The preemption notice ran out mid-drain: the leaver is revoked
    for real before the proactive migration finished. Subclassing
    MidSwitchFault routes it through the standard mid-switch recovery —
    if the state ship already completed the loss is benign (the pair
    dissolves cleanly), otherwise the leaver is recovered through the
    unexpected-failure path."""


@dataclass
class CrashPoint:
    """Arms a *controller* crash at the `index`-th step of `kind`: the
    run raises ControllerCrash immediately before that step executes
    (once — `fired` latches). Unlike a FaultPoint, the data plane is
    untouched; it is the control plane that dies, and a restarted
    controller must adopt the run from its ControlJournal record."""
    kind: str
    index: int = 0
    fired: bool = False


class ControllerCrash(Exception):
    """The controller process died mid-run. The exception unwinds the
    whole driving call — there is no in-process recovery; recovery is
    `Controller.restart()` replaying the ControlJournal."""

    def __init__(self, step: str):
        super().__init__(f"controller crashed before step {step}")
        self.step = step


class MigrationRun:
    """Journaled, resumable execution of a migration's step list."""

    def __init__(self, clock, fault: Optional[FaultPoint] = None,
                 label: str = ""):
        self.clock = clock
        self.fault = fault
        self.crash: Optional[CrashPoint] = None
        self.deadline: Optional[DeadlinePoint] = None
        self.label = label
        # ControlJournal hook: called as observer(event, data) after
        # every durable transition (step done, invalidate, revert,
        # resume) so the controller can journal the run write-ahead
        self.observer: Optional[Callable[[str, Dict[str, Any]], None]] \
            = None
        self.jid = ""                  # journal run id, set at run_begin
        self.state = MigState.IDLE
        self.steps: List[Step] = []
        self.done: Set[str] = set()
        self.journal: List[JournalEntry] = []
        # groups switched by this run, in order, with the applied plan
        # — exactly what rollback needs to revert them
        self.switched: List[Tuple[Any, Any]] = []
        self.resumes = 0
        # journal invariants the fuzz harness asserts: a step body may
        # run more than once ONLY if a recovery explicitly invalidated
        # it (or rollback dropped its switch)
        self.exec_counts: Dict[str, int] = {}
        self.invalidated_log: Set[str] = set()
        # victims recovered via the checkpoint-restart baseline because
        # the standby pool was exhausted mid-cycle
        self.ckpt_fallbacks = 0

    # --------------------------------------------------------- plumbing
    def _log(self, step: str, **info) -> None:
        self.journal.append(JournalEntry(step, self.state.value,
                                         self.clock.now, dict(info)))

    def _emit(self, event: str, **data) -> None:
        if self.observer is not None:
            self.observer(event, data)

    def set_steps(self, steps: List[Step]) -> None:
        names = [s.name for s in steps]
        assert len(names) == len(set(names)), "step names must be unique"
        self.steps = steps

    def record_switch(self, group, plan) -> None:
        """Called by a switch step after apply_delta so rollback knows
        which groups are live on new membership and how to revert."""
        self.switched.append((group, plan))

    def invalidate(self, *names: str) -> None:
        """Drop journal steps the new failure set made stale; they
        re-execute on the next pass."""
        self.invalidated_log |= self.done & set(names)
        self.done -= set(names)
        self._emit("invalidate", steps=sorted(names))

    # -------------------------------------------------------- execution
    def execute(self) -> "MigrationRun":
        """Walk the step list. Done steps are skipped (resume); state
        transitions are applied even for skipped steps so the machine
        state is consistent after a resume. An armed FaultPoint raises
        before its matching step runs."""
        counts: Dict[str, int] = {}
        for st in self.steps:
            i = counts.get(st.kind, 0)
            counts[st.kind] = i + 1
            c = self.crash
            if (c is not None and not c.fired and c.kind == st.kind
                    and c.index == i):
                # the control plane dies here: nothing after this line
                # reaches the journal (the append never happened), so a
                # restart sees exactly the steps committed so far
                c.fired = True
                self._log(f"crash@{st.name}")
                raise ControllerCrash(st.name)
            d = self.deadline
            if (d is not None and not d.fired and d.now() >= d.deadline):
                # the advance notice ran out: the preemption lands now,
                # mid-drain, and the run absorbs it like any other
                # mid-switch fault (latched — recovery resumes the run
                # without re-firing)
                d.fired = True
                self.state = MigState.ABORTED
                self._log(f"deadline@{st.name}", victims=list(d.victims))
                raise NoticeExpired(st.name, d.victims)
            f = self.fault
            if (f is not None and not f.fired and f.kind == st.kind
                    and f.index == i):
                f.fired = True
                self.state = MigState.ABORTED
                self._log(f"fault@{st.name}", victims=list(f.victims))
                raise MidSwitchFault(st.name, f.victims)
            if st.name in self.done:
                if st.state_after is not None:
                    self.state = st.state_after
                continue
            st.fn()
            self.exec_counts[st.name] = self.exec_counts.get(st.name, 0) + 1
            self.done.add(st.name)
            if st.state_after is not None:
                self.state = st.state_after
            self._log(st.name)
            self._emit("step", step=st.name, state=self.state.value)
        return self

    # --------------------------------------------------------- recovery
    def _switches_complete(self) -> bool:
        return all(s.name in self.done for s in self.steps
                   if s.kind == "switch")

    def rollback(self, revert_fn: Callable[[Any, Any], None],
                 force: bool = False) -> int:
        """Roll partially-switched groups back to the pre-switch epoch.

        Only a *partial* switch is reverted (some groups live on new
        membership, some on old — an inconsistent epoch); a fully
        committed switchover survives the fault and the run resumes
        from the swap steps instead. `force=True` reverts even a
        complete switchover (a joiner died after its groups flipped).
        Returns the number of groups reverted; their switch steps are
        dropped from the journal so they re-run after replanning."""
        if not self.switched or (self._switches_complete() and not force):
            return 0
        n = 0
        for group, plan in reversed(self.switched):
            revert_fn(group, plan)
            if f"switch:{group.gid}" in self.done:
                self.invalidated_log.add(f"switch:{group.gid}")
            self.done.discard(f"switch:{group.gid}")
            self._log(f"revert:{group.gid}", members=list(group.members))
            self._emit("revert", gid=group.gid)
            n += 1
        self.switched.clear()
        return n

    def mark_resumed(self, fault: MidSwitchFault) -> None:
        self.resumes += 1
        self._log("resume", after=fault.step, resumes=self.resumes)
        self._emit("resume", after=fault.step)
