"""The TrainMover controller (§3 workflow, §7 implementation;
counterpart of `repro/core/controller.py`).

Coordinates roles, migrations and failure recovery over a
PipelineEngine: issues migration signals, drives the preparation /
switching phases, promotes standbys, and keeps the downtime/overlap
ledgers that the benchmarks report.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster, Machine, NodeStatus
from repro_torch.cluster.simclock import SimClock
from repro_torch.core import baselines
from repro_torch.core import standby as standby_mod
from repro_torch.core import state_sync
from repro_torch.core import two_phase
from repro_torch.core.engine import (IterationInterrupt, PipelineEngine,
                                     stage_role_key, stage_type)
from repro_torch.core.groups import (CommGroup, GroupState,
                                     compute_delta_plan,
                                     compute_dp_resize_plan,
                                     compute_reshard_plan, group_to_dict,
                                     plan_from_dict, plan_to_dict)
from repro_torch.core.journal import ControlJournal
from repro_torch.core.migration import (ControllerCrash, CrashPoint,
                                        DeadlinePoint, FaultPoint,
                                        MidSwitchFault, MigState, MigrationRun,
                                        NoticeExpired, Step)
from repro_torch.core.policy import (KNOWN_POLICIES, PolicyDecision,
                                     PolicyEngine, Telemetry)
from repro_torch.models.registry import count_params
from repro_torch.train.checkpoint import InMemoryCheckpoint, tree_bytes


@dataclass
class MigrationReport:
    kind: str
    downtime: float = 0.0
    overlap: float = 0.0
    barrier: float = 0.0
    state_transfer_s: float = 0.0
    state_bytes: int = 0
    ccl_phase2_s: float = 0.0
    promote_s: float = 0.0
    rollback_s: float = 0.0
    qps_added: int = 0
    qps_dropped: int = 0
    qps_inherited: int = 0
    mem_overhead_bytes: float = 0.0
    pairs: Dict[int, int] = field(default_factory=dict)
    state_path: str = ""
    lost_iterations: int = 0
    resumes: int = 0                       # mid-switch abort/resume cycles
    # victims recovered via the checkpoint-restart baseline because the
    # standby pool was exhausted mid-cycle (overflow fallback)
    ckpt_fallbacks: int = 0
    journal: List[str] = field(default_factory=list)

    @property
    def delta_fraction(self) -> float:
        return self.qps_added / max(self.qps_added + self.qps_inherited, 1)


class Controller:
    def __init__(self, engine: PipelineEngine,
                 cost: CostModel = DEFAULT, standby_count: int = 1,
                 per_iteration_ckpt: bool = True,
                 storage_bw: float = 0.0,
                 seed: Optional[int] = None,
                 journal: Optional[ControlJournal] = None):
        self.engine = engine
        self.cluster: Cluster = engine.cluster
        self.clock: SimClock = engine.clock
        self.cost = cost
        self.standby_count = standby_count
        self.per_iteration_ckpt = per_iteration_ckpt
        self.storage_bw = storage_bw
        # one seed governs the whole run; the engine's seed is the one
        # that feeds the data stream and param init, so an explicit
        # controller seed must agree — ScenarioResult records it as the
        # run's determinism provenance
        assert seed is None or seed == engine.seed, (seed, engine.seed)
        self.seed = engine.seed
        self.imc = InMemoryCheckpoint()
        self.storage: Dict[int, Tuple[int, dict]] = {}
        self.storage_coords: Dict[int, Tuple[int, int]] = {}
        self.standbys: List[int] = []
        # Churn-storm policy knobs. elastic_pool=False models a real
        # bounded cluster: _alloc_joiners stops inventing machines and
        # a recovery that finds the pool dry must degrade instead.
        # degraded_mode=True arms that degradation: when an unexpected
        # failure has no standby and no spare, the victim's whole DP
        # chain retires (dp_shrink) and training continues at reduced
        # throughput rather than paying the checkpoint-restart window.
        self.elastic_pool: bool = True
        self.degraded_mode: bool = False
        self.reports: List[MigrationReport] = []
        self.last_run: Optional[MigrationRun] = None
        # write-ahead ControlJournal: every durable-state mutation below
        # appends a record, so Controller.restart() can rebuild a fresh
        # instance after a crash (journal passed in = the durable log
        # surviving this instance's death)
        self.journal = journal if journal is not None \
            else ControlJournal(self.clock, cost)
        # telemetry-driven recovery-policy layer (core/policy.py):
        # consulted by the `auto` dispatch sites only — a fixed policy
        # argument bypasses it entirely, so fixed-policy runs charge
        # the exact same ledger entries they always did
        self.policy_engine = PolicyEngine(cost)

    # ---------------------------------------------- journal plumbing
    def _journal_topology(self) -> None:
        self.journal.append("groups", {"groups": [
            group_to_dict(g) for _, g in sorted(self.engine.groups.items())
        ]})

    def _journal_standbys(self) -> None:
        self.journal.append("standbys", {"mids": list(self.standbys)})

    def _journal_storage_index(self) -> None:
        self.journal.append("storage_index", {"entries": sorted(
            [mid, step, list(self.storage_coords[mid])]
            for mid, (step, _) in self.storage.items())})

    def _journal_epoch(self) -> None:
        # a NESTED recovery run (victim-set absorption inside
        # _recover_mid_switch) reaches here while sibling victims are
        # still dead in the grid with no committed step — record the
        # epoch of the machines that have one rather than asserting
        # grid-wide health mid-cycle
        sig = [[m, int(self.cluster[m].payload["step"])]
               for m in self.engine.grid.values()
               if "step" in self.cluster[m].payload]
        self.journal.append("epoch", {"sig": sorted(sig)})

    def _journal_run_begin(self, run: MigrationRun, op: str,
                           params: Dict[str, Any]) -> None:
        """Write-ahead record for a new MigrationRun: the op name and
        enough of its parameters to rebuild the step list on adoption,
        plus the step names themselves. Also wires the run's observer
        so every later durable transition is journaled."""
        run.jid = self.journal.next_run_id()
        self.journal.append("run_begin", {
            "run": run.jid, "label": run.label, "op": op,
            "params": params, "steps": [s.name for s in run.steps]})
        run.observer = self._run_observer(run.jid)

    def _run_observer(self, jid: str):
        def obs(event: str, data: Dict[str, Any]) -> None:
            self.journal.append(f"run_{event}", {"run": jid, **data})
        return obs

    def _journal_run_meta(self, run: MigrationRun, **data) -> None:
        self.journal.append("run_meta", {"run": run.jid, **data})

    def _journal_policy(self, decision: PolicyDecision) -> None:
        """Durable decision record, written BEFORE dispatch: a crash
        anywhere in the chosen recovery leaves the ranked choice in
        the journal, so the adopting controller (and the audit trail)
        sees the same decision it is replaying. Appends charge the
        overlap lane, so consulting the policy never widens a downtime
        window — auto's downtime stays bit-identical to the fixed
        policy it dispatches into."""
        self.journal.append("policy", decision.to_record())

    def _victim_state_bytes(self, victim: int) -> int:
        """Flat stage state (params + optimizer) the recovery must
        move. Read from the victim's own resident payload; a victim
        already evicted falls back to a same-stage DP replica (bitwise
        the same shard) and, failing that, to zero."""
        candidates = [victim]
        try:
            _, s = self.engine.coords_of(victim)
            candidates += [m for (dd, ss), m in self.engine.grid.items()
                           if ss == s and m != victim]
        except (AssertionError, KeyError):
            pass
        for mid in candidates:
            pl = self.cluster[mid].payload
            if "params" in pl or "param_segs" in pl:
                return int(self.engine.state_bytes(mid))
        return 0

    def _policy_telemetry(self, victim: int,
                          notice_s: float = 0.0) -> Telemetry:
        """Cluster snapshot the PolicyEngine scores against — pulled
        live from the ledgers, never cached, so the decision always
        reflects the pool as it stands at fault time."""
        m = self.cluster[victim]
        return Telemetry(
            victim=victim,
            surviving_fraction=m.healthy_fraction if m.alive else 0.0,
            state_bytes=self._victim_state_bytes(victim),
            standbys=len(self.standbys),
            idle_spares=len(self._idle_spares()),
            elastic_pool=self.elastic_pool,
            degraded_mode=self.degraded_mode,
            can_shrink=self._can_shrink(victim),
            dp=self.engine.dp, pp=self.engine.pp,
            affected_groups=len(self._affected_groups([victim])),
            channels=self.cost.channels_per_group,
            storage_ok=bool(self.storage),
            storage_bw=self.storage_bw,
            notice_s=notice_s,
            model_params=float(count_params(self.engine.cfg)),
            total_gpus=sum(self.cluster[t].gpus
                           for t in self._training_mids()))

    def _consult_policy(self, victim: int, kind: str,
                        notice_s: float = 0.0) -> PolicyDecision:
        """One policy consultation: capture telemetry, rank the
        candidates, journal the decision, return it for dispatch."""
        tele = self._policy_telemetry(victim, notice_s=notice_s)
        decision = self.policy_engine.decide(tele, kind)
        self._journal_policy(decision)
        return decision

    # ------------------------------------------------------------ setup
    def bootstrap_job(self, machine_ids: List[int],
                      record: bool = True,
                      full_params: Optional[dict] = None) -> None:
        """`full_params` (a full parameter tree, e.g. from
        convert.params_from_numpy) goes to engine.setup; without one the
        weights are drawn from the engine's seed."""
        self.engine.setup(machine_ids, full_params=full_params)
        if record:
            self.engine.record_iteration()       # §4.2 pre-record step
            self._tick_checkpoints()
        standby_mod.replenish(self.engine, self.cluster, self.standbys,
                              self.clock, self.cost,
                              target=self.standby_count)
        self._journal_topology()
        self._journal_standbys()
        self._journal_epoch()

    def _training_mids(self) -> List[int]:
        return list(self.engine.grid.values())

    def _tick_checkpoints(self) -> None:
        if not self.per_iteration_ckpt:
            return
        ring = self._training_mids()
        for mid in ring:
            self.imc.put(mid, self.engine.step_count,
                         self.engine.get_state(mid), ring)

    def save_to_storage(self) -> None:
        for mid in self._training_mids():
            self.storage[mid] = (self.engine.step_count,
                                 self.engine.get_state(mid))
            # grid slot at save time: a later restart must restore a
            # slot's state onto its CURRENT occupant even if the saved
            # machine was swapped out by an intervening recovery
            self.storage_coords[mid] = self.engine.coords_of(mid)
        self._journal_storage_index()

    def train(self, iterations: int, ckpt_every: int = 1) -> List[float]:
        out = []
        for _ in range(iterations):
            out.append(self.engine.train_iteration())
            if self.engine.step_count % ckpt_every == 0:
                self._tick_checkpoints()
        return out

    def _affected_groups(self, mids: List[int]) -> List[CommGroup]:
        return [g for g in self.engine.groups.values()
                if any(m in g.members for m in mids)]

    def _alloc_joiners(self, n: int) -> List[int]:
        """Set-aware allocation: every machine handed out is RESERVED
        (PREPARING) before the next pick, so a multi-victim recovery
        allocating replacements one at a time — possibly interleaved
        with standby replenishment or an in-flight migration's reserved
        joiners — can never double-assign one machine to two grid
        slots. Degraded / straggling leavers return to the pool but
        must not be handed back to the job as joiners.

        With elastic_pool=False the pool is bounded: the list comes
        back SHORT when the idle spares run out, and the caller owns
        the shortage (degraded-mode shrink, or checkpoint-restart)."""
        out: List[int] = []
        for _ in range(n):
            idle = [m.mid for m in self.cluster.by_status(NodeStatus.IDLE)
                    if m.mid not in self.standbys and m.is_healthy]
            if idle:
                mid = idle[0]
            elif self.elastic_pool:
                mid = self.cluster.add_machine().mid
            else:
                break
            self.cluster[mid].status = NodeStatus.PREPARING
            out.append(mid)
        return out

    def _idle_spares(self) -> List[int]:
        return [m.mid for m in self.cluster.by_status(NodeStatus.IDLE)
                if m.mid not in self.standbys and m.is_healthy]

    # ----------------------------------------------- expected interruption
    def expected_migration(self, leavers: List[int],
                           joiners: Optional[List[int]] = None,
                           train_during_prep: int = 0,
                           on_prepared: Optional[Callable] = None,
                           inject: Optional[FaultPoint] = None,
                           crash: Optional[CrashPoint] = None,
                           notice_s: Optional[float] = None
                           ) -> MigrationReport:
        """Live migration with advance notice (§3 steps 1-3), driven as
        a resumable state machine (core/migration.py): IDLE ->
        DELTA_PREPARED -> JOINERS_WARMED -> SWITCHING -> COMMITTED.

        `on_prepared(controller)` fires after the preparation phase but
        before the switching phase — the seam where a cascading event
        (e.g. an unexpected failure handled while this migration was in
        flight) can land; any affected group whose pending plan the
        cascade invalidated is re-prepared before switching.

        `inject` arms a FaultPoint: the run aborts at the matching
        journal step, rolls any partially-switched groups back to a
        consistent epoch, recovers the victims (standby promotion),
        re-plans against the new failure set and resumes — completed
        steps are never redone and no full re-init happens.

        `crash` arms a CrashPoint: the *controller* dies before the
        matching step (ControllerCrash propagates out of this call);
        `Controller.restart()` then adopts the run from the journal."""
        rep = MigrationReport("expected")
        joiners = joiners or self._alloc_joiners(len(leavers))
        pairing = dict(zip(leavers, joiners))
        rep.pairs = pairing                  # live: replans update it
        # reserve the joiners NOW: a fault recovery allocating an
        # elastic machine mid-migration must not be handed a machine
        # already promised to this run (joiners used to stay IDLE
        # until their warmup step, double-assigning the grid)
        for j in pairing.values():
            self.cluster[j].status = NodeStatus.PREPARING
        affected = self._affected_groups(leavers)
        lanes0 = {ln: self.clock.lane_total(ln)
                  for ln in ("downtime", "overlap")}
        run = MigrationRun(self.clock, fault=inject, label="expected")
        run.crash = crash
        if notice_s is not None:
            # advance-notice drain: the leavers are revoked for real
            # when the notice window closes, whatever step the run is
            # on. The deadline reads the live clock so overlap-lane
            # work (warmup, state ship) eats into the window honestly.
            run.deadline = DeadlinePoint(self.clock.now + notice_s,
                                         lambda: self.clock.now,
                                         victims=list(leavers))
            rep.kind = "notice_drain"
        xferred: set = set()
        run.set_steps(self._expected_steps(
            run, rep, leavers, pairing, affected, xferred, lanes0,
            train_during_prep, on_prepared))
        self._journal_run_begin(run, "expected_migration", {
            "leavers": list(leavers),
            "pairing": sorted([l, j] for l, j in pairing.items()),
            "gids": [g.gid for g in affected],
            "train_during_prep": train_during_prep,
            "notice_s": notice_s})
        self._drive_run(run, rep, pairing, affected, xferred,
                        lanes0["downtime"])
        return rep

    def _expected_steps(self, run: MigrationRun, rep: MigrationReport,
                        leavers: List[int], pairing: Dict[int, int],
                        affected: List[CommGroup], xferred: set,
                        lanes0: Dict[str, float], train_during_prep: int,
                        on_prepared: Optional[Callable]) -> List[Step]:
        """Build the expected-migration step list. Factored out of
        expected_migration so a restarted controller can rebuild the
        exact same (name-stable) steps when adopting a journaled run —
        the closures bind `pairing`/`xferred` by reference, so replans
        and adoption both take effect without rebuilding."""
        steady = {m.mid: m.device.used
                  for m in self.cluster.machines.values()}
        peak0 = {m.mid: m.device.peak
                 for m in self.cluster.machines.values()}

        # ---- step bodies (close over pairing so replans take effect)
        def prep(g):
            def fn():
                sub = {l: pairing[l] for l in g.members if l in pairing}
                if not sub:
                    return
                two_phase.ccl_prepare_stayers(g, sub, self.cluster,
                                              self.clock, self.cost)
                two_phase.ccl_prepare_joiners(g, sub, self.cluster,
                                              self.clock, self.cost)
            return fn

        def warm(l):
            def fn():
                d, s = self.engine.coords_of(l)
                jm = self.cluster[pairing[l]]   # PREPARING since alloc
                self.engine.shadow_iteration(jm, stage_role_key(s), s,
                                             lane="overlap")
            return fn

        def train_prep():
            for _ in range(train_during_prep):   # foreground keeps training
                self.engine.train_iteration()
                self._tick_checkpoints()

        def cascade():
            on_prepared(self)
            self._reprepare_stale(affected, pairing)

        def barrier():
            rep.overlap = self.clock.lane_total("overlap") \
                - lanes0["overlap"]
            # with an advance notice the controller schedules the
            # switch AT an iteration boundary — the wait for the drain
            # hides inside the notice window (training continues), so
            # only the transfer + switchover open the downtime window
            lane = "overlap" if run.deadline is not None else "downtime"
            self.clock.advance(self.cost.iteration_barrier, "drain",
                               lane=lane)
            rep.barrier += self.cost.iteration_barrier

        def xfer():
            # one-to-one state transfers run in parallel across pairs:
            # real copies now, single max-time charge (constant in
            # #pairs, §8.3). A resume only re-ships pairs whose joiner
            # the fault invalidated.
            todo = [(l, j) for l, j in pairing.items() if l not in xferred]
            transfers = [state_sync.leaver_to_joiner(
                self.engine, l, j, self.clock, self.cost, charge=False)
                for l, j in todo]
            par = max((t.seconds for t in transfers), default=0.0)
            self.clock.advance(par, "state_xfer:parallel", lane="downtime")
            rep.state_transfer_s += par
            rep.state_bytes += sum(t.nbytes for t in transfers)
            xferred.update(l for l, _ in todo)
            self._journal_run_meta(run, xferred=sorted(xferred))

        def swap(l):
            def fn():
                # grid occupancy is journaled at run commit
                # (_drive_run); a crash between swap and commit
                # re-runs this step from the adopted run
                # repro: allow(journal-coverage)
                self.engine.swap_machine(l, pairing[l])
            return fn

        def commit():
            rep.mem_overhead_bytes = max(
                (self.cluster[mid].device.peak
                 - max(peak0[mid], steady[mid]))
                for mid in steady if mid not in pairing.values())

        steps = [Step(f"prepare:{g.gid}", "prepare", prep(g))
                 for g in affected]
        if steps:
            steps[-1].state_after = MigState.DELTA_PREPARED
        warms = [Step(f"warmup:{l}", "warmup", warm(l)) for l in leavers]
        if warms:
            warms[-1].state_after = MigState.JOINERS_WARMED
        steps += warms
        if train_during_prep:
            steps.append(Step("train_prep", "train", train_prep))
        if on_prepared is not None:
            steps.append(Step("cascade_seam", "cascade", cascade))
        steps.append(Step("barrier", "barrier", barrier,
                          MigState.SWITCHING))
        steps.append(Step("xfer", "xfer", xfer))
        steps += [Step(f"switch:{g.gid}", "switch",
                       self._switch_step(run, rep, g))
                  for g in affected]
        steps += [Step(f"swap:{l}", "swap", swap(l)) for l in leavers]
        steps.append(Step("commit", "commit", commit, MigState.COMMITTED))
        return steps

    def preemption_notice(self, leaver: int,
                          notice_s: Optional[float] = None,
                          train_during_prep: int = 0,
                          inject: Optional[FaultPoint] = None,
                          crash: Optional[CrashPoint] = None
                          ) -> MigrationReport:
        """Spot-preemption with advance notice: the provider revokes
        `leaver` in `notice_s` seconds. Run the proactive drain
        (two-phase prepare + warmup + state ship) against that
        deadline; if the window is long enough the switchover lands
        with near-zero downtime, and if the deadline fires mid-prepare
        the run absorbs it as a mid-switch fault on the leaver — benign
        when the state already shipped, the unexpected-failure path
        otherwise. Either way, once the run commits the machine is
        GONE: the preemption executes even when the drain beat it.

        The PolicyEngine is consulted first: with any spare capacity
        the drain always ranks first (the notice window hides the state
        ship), but a notice landing on a dry pool now retires the
        leaver's DP chain — or falls back to checkpoint-restart —
        instead of unconditionally draining into a pool that cannot
        supply a joiner."""
        if notice_s is None:
            notice_s = self.cost.preemption_notice_s
        chosen = self._consult_policy(leaver, "preemption",
                                      notice_s=notice_s).chosen
        if chosen == "dp_shrink":
            # dp_shrink's detect step fails the leaver: the provider
            # takes the machine back either way
            return self.dp_shrink(leaver, inject=inject, crash=crash)
        if chosen == "ckpt_restart":
            return self.checkpoint_restart(leaver)
        assert chosen == "migrate", chosen
        rep = self.expected_migration(
            [leaver], train_during_prep=train_during_prep,
            inject=inject, crash=crash, notice_s=notice_s)
        rep.kind = "notice_drain"
        lm = self.cluster[leaver]
        if lm.alive and leaver not in self.engine.grid.values():
            # the drain beat the deadline — the provider still takes
            # the machine back; it must not linger as a reusable spare
            lm.fail()
            self.imc.drop_node(leaver)
            if leaver in self.standbys:
                self.standbys.remove(leaver)
                self._journal_standbys()
        return rep

    def _drive_run(self, run: MigrationRun, rep: MigrationReport,
                   pairing: Dict[int, int], affected: List[CommGroup],
                   xferred: set, lanes0_dt: float) -> None:
        """Execute a migration run to COMMITTED, absorbing mid-switch
        faults through abort/rollback/resume cycles, then finalize the
        report from the downtime-lane delta and the journal."""
        while True:
            try:
                run.execute()
                break
            except MidSwitchFault as fault:
                self._recover_mid_switch(run, fault, pairing, affected,
                                         xferred)
        assert run.fault is None or run.fault.fired, \
            f"armed FaultPoint {run.fault} never matched a step"
        rep.downtime = self.clock.lane_total("downtime") - lanes0_dt
        rep.resumes = run.resumes
        rep.ckpt_fallbacks = run.ckpt_fallbacks
        rep.journal = [e.step for e in run.journal]
        self.last_run = run
        self.reports.append(rep)
        # the run is durable-committed: persist the post-switch group
        # topology and the new epoch signature
        self._journal_topology()
        self._journal_epoch()

    def _switch_step(self, run: MigrationRun, rep: MigrationReport,
                     g: CommGroup) -> Callable[[], None]:
        """Per-group phase-2 step shared by every migration path: the
        applied plan is recorded on the run so rollback can revert it,
        and the QP delta accrues on the report. A group left with no
        staged plan is skipped — a recovery inside this run already
        flipped it (or dissolved the pair it was staged for), and the
        replanning pass stages a fresh plan whenever real work remains.
        Re-shard plans splice through ccl_reshard_switchover."""
        def fn():
            plan = g.pending_plan
            if plan is None:
                return
            if plan.kind == "reshard":
                r = two_phase.ccl_reshard_switchover(
                    g, self.cluster, self.clock, self.cost)
            elif plan.kind == "dp_resize":
                r = two_phase.ccl_resize_switchover(
                    g, self.cluster, self.clock, self.cost)
            else:
                # a new DeltaPlan kind must pick its switchover path
                # explicitly; the membership-replace splice is NOT a
                # safe default for plans that change cardinality/layout
                assert plan.kind == "replace", plan.kind
                r = two_phase.ccl_switchover(g, self.cluster, self.clock,
                                             self.cost)
            run.record_switch(g, plan)
            # the applied plan is durable BEFORE the next step: an
            # adopted run must be able to revert exactly the groups
            # that flipped, in order, from the journal alone
            self.journal.append("run_switch", {
                "run": run.jid, "gid": g.gid, "plan": plan_to_dict(plan)})
            rep.ccl_phase2_s = max(rep.ccl_phase2_s, r.phase2_time)
            rep.qps_added += r.qps_added
            rep.qps_dropped += r.qps_dropped
            rep.qps_inherited += r.qps_inherited
        return fn

    def _recover_mid_switch(self, run: MigrationRun,
                            fault: MidSwitchFault,
                            pairing: Dict[int, int],
                            affected: List[CommGroup],
                            xferred: set) -> None:
        """Crash-consistent abort + resume for an arbitrary victim SET
        landing inside a migration: one rollback-replan-resume cycle
        absorbs K concurrent failures wherever they hit — stayers, DP
        peers, a standby, the leaver itself, or the joiner (on both
        the expected and the failure-recovery path). Partially-switched
        groups revert to the pre-switch epoch, the async ledger settles
        inside the downtime window, every victim is recovered in role
        order (standby -> leaver -> joiner -> training machines), and
        exactly the journal steps the new failure set invalidated are
        dropped before the run resumes. When the victims outnumber the
        standby pool and no in-memory redundancy exists, the overflow
        falls back to the checkpoint-restart baseline (counted on the
        report as `ckpt_fallbacks`)."""
        step_names = {s.name for s in run.steps}
        in_grid = set(self.engine.grid.values())
        victims = list(dict.fromkeys(fault.victims))
        standby_victims = [v for v in victims if v in self.standbys]
        leaver_victims = [v for v in victims if v in pairing]
        # a joiner already swapped into the grid is an ordinary
        # training machine; only a not-yet-swapped joiner is replaced
        joiner_victims = [v for v in victims if v in pairing.values()
                          and v not in in_grid]
        train_victims = [v for v in victims if v in in_grid
                         and v not in leaver_victims
                         and v not in standby_victims]
        pool_victims = [v for v in victims
                        if v not in standby_victims + leaver_victims
                        + joiner_victims + train_victims]
        done_before = set(run.done)
        # a dead joiner invalidates even a fully-completed switchover
        run.rollback(lambda g, plan: two_phase.ccl_revert_switchover(
            g, plan, self.cluster, self.clock, self.cost),
            force=bool(joiner_victims))
        self.clock.drain_async(lane="downtime")
        # the whole set is dead from the instant the fault fires: fail
        # every machine and drop its in-memory checkpoint contributions
        # BEFORE any recovery runs, so one victim's recovery can never
        # read host memory that died with another victim
        for v in victims:
            self.cluster[v].fail()
            self.imc.drop_node(v)
        # standby victims first: a dead standby must never be promoted
        # for a victim recovered later in this same cycle
        for v in standby_victims:
            self.standbys.remove(v)
        vset = set(victims)
        for v in leaver_victims:
            # benign ONLY if the shipped state survives the fault: the
            # receiving joiner must not be in the victim set itself
            shipped_alive = v in xferred and pairing.get(v) not in vset
            if shipped_alive or f"swap:{v}" in run.done:
                # state already shipped to a live joiner (or the
                # joiner already swapped in): the leaver was departing
                # anyway and its bytes live on — its death costs
                # nothing beyond the machine
                continue
            # state not shipped (or it died with the joiner): the pair
            # dissolves — a still-alive reserved joiner returns to the
            # pool and the leaver recovers like any failed training
            # machine (its leaver-keyed steps are marked done so the
            # resumed pass skips them; recovery itself goes through
            # the same availability-ordered loop as the other training
            # victims, overflow fallback included)
            j = pairing.pop(v)
            jm = self.cluster[j]
            if jm.alive and jm.status == NodeStatus.PREPARING:
                jm.status = NodeStatus.IDLE
            for name in (f"warmup:{v}", f"swap:{v}"):
                if name in step_names:
                    run.done.add(name)
            xferred.discard(v)
            train_victims.append(v)
        for v in joiner_victims:
            stale_leavers = [l for l, j in pairing.items() if j == v]
            if "promote" in step_names:
                # failure-recovery path: the promoted standby (or
                # elastic joiner) died before its swap — re-promote and
                # re-ship state on the next pass. Dropping the stale
                # pairing entry (promote re-sets it) also voids every
                # staged plan referencing the dead joiner, so the
                # replanning pass below re-stages them.
                assert "swap" not in run.done, \
                    "joiner already swapped into the grid; it must be " \
                    "recovered as a training-machine victim"
                for l in stale_leavers:
                    pairing.pop(l, None)
                run.invalidate("promote", "prepare:all", "recover")
                continue
            for l in stale_leavers:
                assert f"swap:{l}" not in run.done, \
                    "joiner already swapped into the grid; it must be " \
                    "recovered as a training-machine victim"
                pairing[l] = self._alloc_joiners(1)[0]
                run.invalidate(f"warmup:{l}")
                xferred.discard(l)
            # the xfer step re-runs but only re-ships the pairs just
            # discarded from `xferred` (state never reached the dead
            # joiner); pairs already shipped to live joiners keep theirs
            run.invalidate("xfer")
        def recoverable(v):
            # fast state sources: a surviving in-memory checkpoint
            # replica, or a live DP peer of the same stage (bitwise-
            # identical state — covers victim sets whose members held
            # each other's checkpoint replicas), or a storage
            # checkpoint taken at the current step
            return ((self.per_iteration_ckpt
                     and self.imc.get(v) is not None)
                    or state_sync.live_dp_peer(self.engine, v) is not None
                    or (v in self.storage and
                        self.storage[v][0] == self.engine.step_count))

        # greedy order by state availability: recovering a victim can
        # resurrect the fast state source of another (a freshly
        # promoted standby IS the missing DP peer for the other rank
        # of its stage), so re-evaluate after every recovery. The fast
        # path is gated on a promotion resource existing (standby pool
        # or per-iteration redundancy) — EXCEPT when no storage
        # checkpoint exists, in which case a recoverable victim must
        # take the fast path (the baseline is impossible anyway) — and
        # re-opens after a restart, whose grid-wide restore makes the
        # storage snapshot current for every remaining victim.
        remaining = list(train_victims)
        restarted = False
        while remaining:
            pick = None
            if (self.standbys or self.per_iteration_ckpt or restarted
                    or not self.storage):
                pick = next((v for v in remaining if recoverable(v)),
                            None)
            if pick is not None:
                remaining.remove(pick)
                self.unexpected_failure(pick)
                continue
            # standby pool exhausted with no in-memory redundancy (or
            # every fast state source died with the victim set): an
            # elastic joiner could not re-sync the survivors, so the
            # honest recovery is the checkpoint-restart baseline —
            # ONE restart window, recorded per scenario in the
            # downtime report rather than hidden inside a cheap-
            # looking elastic promotion; the victims after it re-sync
            # from the just-restored epoch without a second window
            v = remaining.pop(0)
            assert self.storage, \
                "unrecoverable victim: no checkpoint replica, no live " \
                "DP peer and no storage checkpoint " \
                "(save_to_storage() was never called)"
            self.checkpoint_restart(v)
            run.ckpt_fallbacks += 1
            restarted = True
        # pool_victims need no recovery (already failed above)
        # replace every standby the fault killed, off the critical path
        # (overlapped with the resumed preparation work)
        if standby_victims:
            standby_mod.replenish(
                self.engine, self.cluster, self.standbys, self.clock,
                self.cost,
                target=len(self.standbys) + len(standby_victims))
        # re-plan: drop the journal steps for any group whose staged
        # delta the recovery invalidated (plan cleared by a victim's
        # switchover, membership changed, or joiner replaced)
        for g in affected:
            if f"switch:{g.gid}" in run.done:
                continue       # committed switch that survives the fault
            sub = {l: pairing[l] for l in g.members if l in pairing}
            intact = (g.pending_plan is not None and sub
                      and g.pending_plan.replace == sub
                      and g.state in (GroupState.READY_TO_SWITCHOUT,
                                      GroupState.PREPARING))
            if intact:
                continue
            g.pending_plan = None
            g.pending_members = None
            g.state = GroupState.ACTIVE
            run.invalidate(f"prepare:{g.gid}", f"switch:{g.gid}",
                           "prepare:all")
        # if overlapped preparation work (phase 1 / warmup) must re-run
        # after the barrier already drained, rollback restored a
        # trainable epoch and the job resumes training while it
        # overlaps — so the switching window must re-open with a fresh
        # iteration drain when the re-prepared switch goes down again
        kinds = {s.name: s.kind for s in run.steps}
        redo_overlapped = any(kinds.get(n) in ("prepare", "warmup")
                              for n in done_before - run.done)
        if redo_overlapped and "barrier" in run.done:
            run.invalidate("barrier")
        run.mark_resumed(fault)
        # the replan may have rewritten the pairing, released standbys
        # and reverted groups: journal the adoption context so a crash
        # from here restarts cleanly. Lives HERE (not in the callers)
        # so every recovery — _drive_run's fault loop and _adopt_run's
        # synthetic controller-restart fault — persists identically.
        self._journal_run_meta(
            run, pairing=sorted([l, j] for l, j in pairing.items()),
            xferred=sorted(xferred))
        self._journal_standbys()
        self._journal_topology()

    # --------------------------------------------- unexpected interruption
    def unexpected_failure(self, failed: int,
                           use_standby: bool = True,
                           dirty: bool = False,
                           inject: Optional[FaultPoint] = None,
                           crash: Optional[CrashPoint] = None
                           ) -> MigrationReport:
        """Failure -> detect -> promote standby -> switch (§3 a-c),
        journaled through the same resumable state machine as expected
        migrations, so a *concurrent second failure* landing anywhere
        in this recovery (including between per-group switchovers)
        aborts cleanly and resumes instead of corrupting the job.

        dirty=True marks a mid-iteration abort that already mutated
        stayer payloads (post-update): every stayer rolls back to the
        last checkpoint even when the step counter never advanced.

        `crash` arms a CrashPoint (see expected_migration): the
        controller dies before the matching step and the recovery is
        adopted by `Controller.restart()` from the journal."""
        if (self.degraded_mode and use_standby and not self.standbys
                and not self.elastic_pool and not self._idle_spares()):
            # pool-exhausting storm: no standby, no spare, no elastic
            # growth — migrate is infeasible, so the PolicyEngine ranks
            # what remains (DP-chain retirement while more than one
            # chain is staffed, else the checkpoint-restart baseline)
            # and journals the choice before dispatch.
            chosen = self._consult_policy(failed, "failure").chosen
            if chosen == "dp_shrink":
                return self.dp_shrink(failed, inject=inject, crash=crash)
            assert chosen == "ckpt_restart", chosen
            return self.checkpoint_restart(failed)
        rep = MigrationReport("unexpected")
        affected = self._affected_groups([failed])
        lanes0_dt = self.clock.lane_total("downtime")
        run = MigrationRun(self.clock, fault=inject,
                           label=f"failure:{failed}")
        run.crash = crash
        pairing: Dict[int, int] = {}     # failed -> joiner, set by promote
        ctx: Dict[str, Any] = {}
        run.set_steps(self._failure_steps(run, rep, failed, affected,
                                          pairing, ctx, use_standby,
                                          dirty))
        self._journal_run_begin(run, "unexpected_failure", {
            "failed": failed, "use_standby": use_standby, "dirty": dirty,
            "gids": [g.gid for g in affected]})
        self._drive_run(run, rep, pairing, affected, set(), lanes0_dt)
        return rep

    def _failure_steps(self, run: MigrationRun, rep: MigrationReport,
                       failed: int, affected: List[CommGroup],
                       pairing: Dict[int, int], ctx: Dict[str, Any],
                       use_standby: bool, dirty: bool) -> List[Step]:
        """Build the failure-recovery step list. Factored out of
        unexpected_failure so a restarted controller can rebuild the
        exact same (name-stable) steps when adopting a journaled run;
        the closures bind `pairing`/`ctx` by reference, so both replans
        and adoption (which seeds them from run_meta records) take
        effect without rebuilding."""
        fm = self.cluster[failed]

        def detect():
            fm.fail()
            self.imc.drop_node(failed)
            self.clock.advance(self.cost.detect_failure, "detect",
                               lane="downtime")

        def promote():
            used_standby = bool(use_standby and self.standbys)
            ctx["used_standby"] = used_standby
            d, s = self.engine.coords_of(failed)
            if used_standby:
                j = self.standbys.pop(0)
                rep.promote_s = standby_mod.promote_standby(
                    self.engine, self.cluster[j], s, self.clock, self.cost)
            else:
                # no standby: an elastic machine joins; its preparation
                # (sandbox + CCL phase 1) overlaps with *nothing* (the
                # job is stalled), but TrainMover still overlaps CCL,
                # warmup and state transfer with each other instead of
                # serializing.
                j = self._alloc_joiners(1)[0]
                jm = self.cluster[j]
                role = self.engine.shadow_iteration(
                    jm, stage_role_key(s), s, lane="downtime",
                    fresh_compile=True)
                rep.promote_s = self.engine.compile_charge(role)
            pairing[failed] = j
            rep.pairs = {failed: j}
            # durable before any switch: a restarted controller must
            # know which standby this run consumed and which joiner it
            # claimed, or it would double-assign them on adoption
            self._journal_standbys()
            self._journal_run_meta(run, used_standby=used_standby,
                                   pairing=[[failed, j]])

        def plan():
            j = pairing[failed]
            # on a resume, groups whose switch already committed keep
            # their applied membership — re-planning them would strand
            # a stale pending plan on an ACTIVE group
            todo = [g for g in affected
                    if f"switch:{g.gid}" not in run.done]
            if ctx["used_standby"]:
                # The general standby pre-bootstrapped at job start, so
                # the groups go straight to ready-to-switchout: only the
                # local delta-plan computation remains (ms-level).
                for g in todo:
                    p = compute_delta_plan(g, {failed: j})
                    g.pending_plan = p
                    g.pending_members = p.new_members
                    g.state = GroupState.READY_TO_SWITCHOUT
                self.clock.advance(0.05 * len(todo), "delta_plan",
                                   lane="downtime")
            else:
                for g in todo:
                    two_phase.ccl_prepare_stayers(
                        g, {failed: j}, self.cluster, self.clock,
                        self.cost, lane="downtime")
                    two_phase.ccl_prepare_joiners(
                        g, {failed: j}, self.cluster, self.clock,
                        self.cost, lane="downtime")

        def recover():
            j = pairing[failed]
            storage_state = self.storage.get(failed)
            tr, step = state_sync.recover_state(
                self.engine, failed, j, self.imc if self.per_iteration_ckpt
                else None, self.clock, self.cost, self.storage_bw,
                storage_state)
            rep.state_transfer_s = tr.seconds
            rep.state_bytes = tr.nbytes
            rep.state_path = tr.path
            # stayers roll back to the same checkpoint step (local/in-mem)
            rep.lost_iterations = max(self.engine.step_count - step, 0)
            if rep.lost_iterations or dirty:
                rb = 0.0
                for mid in self._training_mids():
                    if mid == failed:
                        continue
                    hit = self.imc.get(mid)
                    if hit is not None and hit[0] == step:
                        self.engine.set_state(mid, hit[1])
                        rb = max(rb, self.cost.transfer(
                            tree_bytes(hit[1]), self.cost.bw_intra_node))
                self.clock.advance(rb, "rollback", lane="downtime")
                rep.rollback_s = rb
                # epoch journaled at run commit (_drive_run);
                # adoption replays this step
                # repro: allow(journal-coverage)
                self.engine.step_count = step

        def swap():
            # topology journaled at run commit (_drive_run)
            # repro: allow(journal-coverage)
            self.engine.swap_machine(failed, pairing[failed])

        steps = [Step("detect", "detect", detect),
                 Step("promote", "promote", promote,
                      MigState.JOINERS_WARMED),
                 Step("prepare:all", "prepare", plan,
                      MigState.DELTA_PREPARED),
                 Step("recover", "recover", recover, MigState.SWITCHING)]
        steps += [Step(f"switch:{g.gid}", "switch",
                       self._switch_step(run, rep, g))
                  for g in affected]
        steps += [Step("swap", "swap", swap),
                  Step("commit", "commit", lambda: None,
                       MigState.COMMITTED)]
        return steps

    def _reprepare_stale(self, affected: List[CommGroup],
                         pairing: Dict[int, int]) -> None:
        """Re-run phase 1 for any group whose pending plan a cascade
        invalidated (an unexpected failure handled mid-migration
        switches shared groups over and drops their staged plans)."""
        for g in affected:
            sub = {l: pairing[l] for l in g.members if l in pairing}
            if not sub:
                continue
            intact = (g.pending_plan is not None
                      and g.pending_plan.replace == sub
                      and g.state in (GroupState.READY_TO_SWITCHOUT,
                                      GroupState.PREPARING))
            if intact:
                continue
            two_phase.ccl_prepare_stayers(g, sub, self.cluster,
                                          self.clock, self.cost)
            two_phase.ccl_prepare_joiners(g, sub, self.cluster,
                                          self.clock, self.cost)

    def interrupt_iteration(self, victim: int, phase: str,
                            use_standby: bool = True) -> MigrationReport:
        """Mid-iteration failure: arm a one-shot interrupt at `phase`
        ("pre_reduce" | "post_reduce"), run the iteration until it
        fires, then recover. An aborted iteration commits nothing; a
        post_reduce abort additionally rolls every stayer back to the
        last checkpoint, so the re-run is bitwise-identical to an
        uninterrupted run."""
        self.engine.arm_interrupt(phase, victim)
        try:
            self.engine.train_iteration()
        except IterationInterrupt as intr:
            # in-flight collectives die with the iteration; the ledger
            # settles inside the downtime window, before detection
            drained = self.clock.drain_async(lane="downtime")
            rep = self.unexpected_failure(victim, use_standby=use_standby,
                                          dirty=intr.dirty)
            rep.kind = f"unexpected@{phase}"
            rep.downtime += drained
            return rep
        raise RuntimeError(f"interrupt at {phase} never fired")

    def standby_failure(self, standby: Optional[int] = None
                        ) -> MigrationReport:
        """The interruption hits the standby itself: training never
        stops (zero downtime); a replacement standby is prepared from
        the elastic pool, overlapped with training."""
        rep = MigrationReport("standby_loss")
        assert self.standbys, "standby_failure needs a live standby"
        mid = standby if standby is not None else self.standbys[0]
        self.standbys.remove(mid)
        self.cluster[mid].fail()
        t0 = self.clock.now
        added = standby_mod.replenish(
            self.engine, self.cluster, self.standbys, self.clock,
            self.cost, target=len(self.standbys) + 1)
        rep.pairs = {mid: added[0]}
        rep.overlap = self.clock.now - t0
        self._journal_standbys()
        self.reports.append(rep)
        return rep

    def checkpoint_restart(self, failed: int) -> MigrationReport:
        """Full-reinit baseline recovery (§2.3 S1): stop the job, pull
        the last *storage* checkpoint everywhere, rebuild every comm
        group from scratch. Downtime is the modeled Megatron-style
        restart (core/baselines.py) — the mechanics below (state
        restore, group re-establishment) happen inside that window.
        Requires a prior save_to_storage()."""
        assert self.storage, "checkpoint_restart needs save_to_storage()"
        rep = MigrationReport("ckpt_restart")
        d, s = self.engine.coords_of(failed)
        fm = self.cluster[failed]
        fm.fail()
        self.imc.drop_node(failed)

        t0 = self.clock.now
        self.clock.advance(self.cost.detect_failure, "detect",
                           lane="downtime")
        gpus = sum(self.cluster[m].gpus for m in self._training_mids())
        base = baselines.megatron_restart(
            float(count_params(self.engine.cfg)), gpus, cost=self.cost,
            storage_bw=self.storage_bw)
        self.clock.advance(base.downtime, "full_reinit_restart",
                           lane="downtime")

        alloc = self._alloc_joiners(1)
        if not alloc:
            # bounded pool fully dry: the restart window is minutes
            # long — plenty for the scheduler to hand capacity back, so
            # the baseline may grow even when live migration could not
            assert not self.elastic_pool
            alloc = [self.cluster.add_machine().mid]
            self.cluster[alloc[0]].status = NodeStatus.PREPARING
        j = alloc[0]
        rep.pairs = {failed: j}
        jm = self.cluster[j]
        step = None
        grid_now = set(self._training_mids())
        for mid, (st, state) in self.storage.items():
            step = st
            if mid == failed:
                target = j
            elif mid in grid_now:
                target = mid
            else:
                # the saved machine was swapped out by an intervening
                # recovery: restore its slot's CURRENT occupant, so the
                # whole grid lands on the storage epoch even when that
                # occupant had been re-synced to a newer step
                coords = self.storage_coords.get(mid)
                target = self.engine.grid.get(coords) if coords else None
                if target is None or target == j:
                    continue
            self.engine.set_state(target, state)
            rep.state_bytes += tree_bytes(state)
        self.engine.swap_machine(failed, j)
        jm.device.alloc(self.engine.state_bytes(j), "train_state",
                        self.clock.now)
        jm.device.alloc(self.engine.grad_buffer_bytes(s), "grad_buffer",
                        self.clock.now)
        self.engine.compile_role(s, fresh=True)   # cold joiner compile
        for g in self.engine.groups.values():
            g.members = [j if m == failed else m for m in g.members]
            g.pending_plan = None
            g.pending_members = None
            g.establish_all()
        rep.lost_iterations = max(self.engine.step_count - step, 0)
        self.engine.step_count = step
        rep.state_path = "storage"
        rep.downtime = self.clock.now - t0
        # the restart rebuilt every group and moved the whole grid to
        # the storage epoch: both are durable-state transitions
        self._journal_topology()
        self._journal_epoch()
        self.reports.append(rep)
        return rep

    # -------------------------------------------- degraded-mode DP resize
    def _can_shrink(self, victim: int) -> bool:
        """Shrink is possible while more than one DP chain is still
        physically staffed and the victim actually occupies the grid."""
        live = self.engine.dp - len({dd for dd, _ in self.engine.hosted})
        return victim in self.engine.grid.values() and live > 1

    def dp_shrink(self, victim: int,
                  inject: Optional[FaultPoint] = None,
                  crash: Optional[CrashPoint] = None) -> MigrationReport:
        """Degraded-mode continuation: `victim` died with the standby
        pool dry in a bounded cluster, so its whole DP chain retires
        instead of being replaced. The chain's logical ranks stay in
        the LOGICAL grid — hosted by surviving same-stage replicas, so
        microbatch split, gradient averaging and the loss sequence are
        untouched (bitwise parity by construction) — while the dp rings
        physically shrink and throughput degrades by the hosting load.
        The chain's still-alive machines come back as spares/standbys:
        the shrink converts doomed capacity into recovery headroom for
        the rest of the storm. Assumes iteration-boundary timing (the
        storm scenarios drain between iterations)."""
        rep = MigrationReport("dp_shrink")
        d_gone, _s = self.engine.coords_of(victim)
        chain = {s: self.engine.grid[(d_gone, s)]
                 for s in range(self.engine.pp)
                 if (d_gone, s) in self.engine.grid}
        members = set(chain.values())
        affected = [g for g in self.engine.groups.values()
                    if set(g.members) & members]
        lanes0 = {ln: self.clock.lane_total(ln)
                  for ln in ("downtime", "overlap")}
        run = MigrationRun(self.clock, fault=inject,
                           label=f"dp_shrink:{victim}")
        run.crash = crash
        run.set_steps(self._dp_shrink_steps(run, rep, victim, d_gone,
                                            chain, affected, lanes0))
        self._journal_run_begin(run, "dp_resize", {
            "direction": "shrink", "victim": victim, "d_gone": d_gone,
            "chain": sorted([s, m] for s, m in chain.items()),
            "gids": [g.gid for g in affected]})
        self._drive_run(run, rep, {}, affected, set(), lanes0["downtime"])
        return rep

    def _dp_shrink_steps(self, run: MigrationRun, rep: MigrationReport,
                         victim: int, d_gone: int, chain: Dict[int, int],
                         affected: List[CommGroup],
                         lanes0: Dict[str, float]) -> List[Step]:
        members = set(chain.values())

        def detect():
            vm = self.cluster[victim]
            if vm.alive:
                vm.fail()
            self.imc.drop_node(victim)
            self.clock.advance(self.cost.detect_failure, "detect",
                               lane="downtime")

        def plan():
            todo = [g for g in affected
                    if f"switch:{g.gid}" not in run.done]
            for g in todo:
                gone = [m for m in g.members if m in members]
                p = compute_dp_resize_plan(g, remove=gone)
                g.pending_plan = p
                g.pending_members = p.new_members
                g.state = GroupState.READY_TO_SWITCHOUT
            self.clock.advance(self.cost.dp_resize_plan_s * len(todo),
                               "dp_resize_plan", lane="downtime")

        def barrier():
            rep.overlap = self.clock.lane_total("overlap") \
                - lanes0["overlap"]
            self.clock.advance(self.cost.iteration_barrier, "drain",
                               lane="downtime")
            rep.barrier += self.cost.iteration_barrier

        def resize():
            freed = self.engine.dp_retire(d_gone)
            # hosts carve out the extra gradient buckets for the ranks
            # they now serve — local HBM allocs, parallel across hosts
            t = max((self.cost.transfer(self.engine.grad_buffer_bytes(s),
                                        self.cost.bw_intra_node)
                     for s in range(self.engine.pp)), default=0.0)
            self.clock.advance(t, "hosted_grad_alloc", lane="downtime")
            self._journal_run_meta(
                run, freed=sorted(freed),
                hosts=sorted([k[0], k[1], h]
                             for k, h in self.engine.hosted.items()))

        def commit():
            # the freed chain-mates become the standbys that absorb the
            # NEXT fault — capped at the configured pool size so a
            # bounded cluster never grows elastically here
            idle = self._idle_spares()
            target = min(self.standby_count,
                         len(self.standbys) + len(idle))
            if target > len(self.standbys):
                standby_mod.replenish(self.engine, self.cluster,
                                      self.standbys, self.clock,
                                      self.cost, target=target)
            self._journal_standbys()

        steps = [Step("detect", "detect", detect),
                 Step("prepare:all", "prepare", plan,
                      MigState.DELTA_PREPARED),
                 Step("barrier", "barrier", barrier, MigState.SWITCHING),
                 Step("resize", "recover", resize)]
        steps += [Step(f"switch:{g.gid}", "switch",
                       self._switch_step(run, rep, g))
                  for g in affected]
        steps.append(Step("commit", "commit", commit, MigState.COMMITTED))
        return steps

    def dp_regrow(self, inject: Optional[FaultPoint] = None,
                  crash: Optional[CrashPoint] = None
                  ) -> Optional[MigrationReport]:
        """Re-grow one retired DP chain once replacement capacity is
        back (a standby replenished, spares freed, or — with an elastic
        pool — fresh machines). Staffing prefers warm standbys; each
        new machine receives a bitwise copy of its hosting replica's
        state (parallel, per-host RDMA), the hosted overlay clears, and
        the dp rings splice the members back in. Returns None (and
        mutates nothing) when a bounded pool cannot staff a full
        chain."""
        retired = sorted({dd for dd, _ in self.engine.hosted})
        if not retired:
            return None
        d = retired[0]
        pp = self.engine.pp
        cand = list(self.standbys)
        cand += [m for m in self._idle_spares() if m not in cand]
        if len(cand) < pp and self.elastic_pool:
            while len(cand) < pp:
                cand.append(self.cluster.add_machine().mid)
        if len(cand) < pp:
            return None
        staff = {s: cand[s] for s in range(pp)}
        for mid in staff.values():
            if mid in self.standbys:
                self.standbys.remove(mid)
            self.cluster[mid].status = NodeStatus.PREPARING
        self._journal_standbys()
        rep = MigrationReport("dp_regrow")
        staffed = set(staff.values())
        # every per-stage dp ring splices a member back; only this
        # chain's pp ring revives
        affected = [g for g in self.engine.groups.values()
                    if g.gid.startswith("dp.s") or g.gid == f"pp.d{d}"]
        lanes0 = {ln: self.clock.lane_total(ln)
                  for ln in ("downtime", "overlap")}
        run = MigrationRun(self.clock, fault=inject,
                           label=f"dp_regrow:{d}")
        run.crash = crash
        run.set_steps(self._dp_grow_steps(run, rep, d, staff, affected,
                                          lanes0))
        self._journal_run_begin(run, "dp_resize", {
            "direction": "grow", "d": d,
            "staff": sorted([s, m] for s, m in staff.items()),
            "gids": [g.gid for g in affected]})
        self._drive_run(run, rep, {}, affected, set(), lanes0["downtime"])
        assert staffed <= set(self.engine.grid.values())
        return rep

    def maybe_regrow(self) -> List[MigrationReport]:
        """Re-grow retired chains while capacity allows, oldest first."""
        out: List[MigrationReport] = []
        while self.engine.hosted:
            rep = self.dp_regrow()
            if rep is None:
                break
            out.append(rep)
        return out

    def _dp_grow_steps(self, run: MigrationRun, rep: MigrationReport,
                       d: int, staff: Dict[int, int],
                       affected: List[CommGroup],
                       lanes0: Dict[str, float]) -> List[Step]:
        pp = self.engine.pp

        def plan():
            todo = [g for g in affected
                    if f"switch:{g.gid}" not in run.done]
            for g in todo:
                if g.gid == f"pp.d{d}":
                    ins = [staff[s] for s in range(pp)]
                    p = compute_dp_resize_plan(g, insert=ins, index=0)
                else:
                    s = int(g.gid.split("dp.s")[-1])
                    p = compute_dp_resize_plan(
                        g, insert=[staff[s]],
                        index=min(d, len(g.members)))
                g.pending_plan = p
                g.pending_members = p.new_members
                g.state = GroupState.READY_TO_SWITCHOUT
            self.clock.advance(self.cost.dp_resize_plan_s * len(todo),
                               "dp_resize_plan", lane="overlap")

        def warm(mid, s):
            def fn():
                rep.promote_s = max(rep.promote_s,
                                    standby_mod.promote_standby(
                                        self.engine, self.cluster[mid], s,
                                        self.clock, self.cost,
                                        lane="overlap"))
            return fn

        def barrier():
            rep.overlap = self.clock.lane_total("overlap") \
                - lanes0["overlap"]
            self.clock.advance(self.cost.iteration_barrier, "drain",
                               lane="downtime")
            rep.barrier += self.cost.iteration_barrier

        def xfer():
            # each host ships its stage state to the machine taking the
            # rank back — distinct source hosts, so the copies ride
            # their own compute channels in parallel
            handles = []
            for s in range(pp):
                host = self.engine.hosted[(d, s)]
                tr = state_sync.regrow_staff(
                    self.engine, host, staff[s], s, self.clock,
                    self.cost, charge=False)
                rep.state_bytes += tr.nbytes
                rep.state_transfer_s = max(rep.state_transfer_s,
                                           tr.seconds)
                handles.append(self.clock.issue_async(
                    ("compute", host), tr.seconds,
                    f"regrow_xfer:{host}->{staff[s]}"))
            for h in handles:
                self.clock.wait_async(h, lane="downtime")

        def resize():
            self.engine.dp_restaff(d, staff)
            self._journal_run_meta(run, staffed=sorted(staff.values()))

        steps = [Step("prepare:all", "prepare", plan,
                      MigState.DELTA_PREPARED)]
        warms = [Step(f"warmup:{staff[s]}", "warmup", warm(staff[s], s))
                 for s in range(pp)]
        if warms:
            warms[-1].state_after = MigState.JOINERS_WARMED
        steps += warms
        steps.append(Step("barrier", "barrier", barrier,
                          MigState.SWITCHING))
        steps.append(Step("xfer", "xfer", xfer))
        steps.append(Step("resize", "recover", resize))
        steps += [Step(f"switch:{g.gid}", "switch",
                       self._switch_step(run, rep, g))
                  for g in affected]
        steps.append(Step("commit", "commit", lambda: None,
                          MigState.COMMITTED))
        return steps

    # ----------------------------------------------------- crash restart
    def restart(self) -> "Controller":
        """Controller crash + supervisor respawn: build a FRESH
        Controller from the durable ControlJournal alone and return it
        (this instance is the dead process — don't use it again).

        What survives a control-plane crash and how it comes back:

        - durable journal      -> replayed (standby ledger, storage
          index, staged topology, in-flight run step logs)
        - worker-held state    -> untouched (engine tensors, in-memory
          checkpoint replicas, prepared QPs); workers RE-REGISTER with
          the new controller — the registry is rebuilt from what the
          live cluster reports, never from the journal
        - open MigrationRuns   -> adopted: steps rebuilt name-stably
          from the journaled op + params, done steps skipped, switched
          groups recoverable via the journaled plans; participants that
          died while the control plane was down are folded in as a
          mid-switch fault (rollback/replan/resume)
        - orphaned PREPARING reservations not claimed by any open run
          -> released back to the elastic pool

        Lane accounting: the restart lands in a downtime window only
        if the job was actually stopped when the controller died (an
        open failure recovery, or any run inside its switching
        window). Otherwise workers keep training without a controller
        and the respawn + replay + re-registration all overlap."""
        state = self.journal.replay()
        open_runs = {jid: r for jid, r in state["runs"].items()
                     if not r["committed"]}
        lane = "downtime" if any(
            r["op"] == "unexpected_failure" or r["state"] == "switching"
            for r in open_runs.values()) else "overlap"
        t = self.cost.controller_restart_s + self.cost.transfer(
            self.journal.bytes_durable, self.cost.bw_journal)
        self.clock.advance(t, "controller_restart+replay", lane=lane)
        # collectives in flight under the dead controller settle before
        # the new one takes over the ledger
        self.clock.drain_async(lane=lane)
        new = Controller(self.engine, cost=self.cost,
                         standby_count=self.standby_count,
                         per_iteration_ckpt=self.per_iteration_ckpt,
                         storage_bw=self.storage_bw,
                         journal=self.journal)
        # worker host memory and durable blob storage survive the
        # crash — only the controller process died. The storage INDEX
        # (which slot each blob restores to) is rebuilt from the
        # journal below, not handed over.
        new.imc = self.imc
        new.storage = self.storage
        new.elastic_pool = self.elastic_pool
        new.degraded_mode = self.degraded_mode
        new._restore_from_journal(state, lane)
        return new

    def _restore_from_journal(self, state: dict, lane: str) -> None:
        """Second half of restart(), running on the NEW controller:
        re-register workers, rebuild controller-private state from the
        replayed journal, reconcile reservations and adopt open runs."""
        alive = [m for m in self.cluster.machines.values() if m.alive]
        self.clock.advance(self.cost.worker_reregister_s * len(alive),
                           "worker_reregister", lane=lane)
        # standby ledger: journaled machines that still report alive;
        # one that died while the controller was down is simply dropped
        # (the pool replenishes on the next recovery cycle)
        # repro: allow(journal-coverage) — restoring FROM the journal
        self.standbys = [mid for mid in state["standbys"]
                         if self.cluster[mid].alive]
        # repro: allow(journal-coverage) — restoring FROM the journal
        self.storage_coords = {
            int(mid): (int(c[0]), int(c[1]))
            for mid, _step, c in state["storage_index"]}
        open_runs = {jid: r for jid, r in state["runs"].items()
                     if not r["committed"]}
        # machines claimed by an open run (its reserved joiners) must
        # keep their PREPARING reservation through the restart; any
        # other PREPARING machine is an orphan — the run that reserved
        # it was never journaled as begun, or already swapped it into
        # the grid — and returns to the elastic pool
        claimed = set()
        for r in open_runs.values():
            pairs = (r["meta"].get("pairing")
                     or r["params"].get("pairing") or [])
            claimed |= {int(j) for _l, j in pairs}
            # a dp_resize grow reserves its staffing set, not a pairing
            claimed |= {int(m) for _s, m in r["params"].get("staff", [])}
        in_grid = set(self.engine.grid.values())
        for m in self.cluster.machines.values():
            if (m.status == NodeStatus.PREPARING
                    and m.mid not in claimed and m.mid not in in_grid
                    and m.mid not in self.standbys):
                m.status = NodeStatus.IDLE
        # re-registration doubles as a grid health check: machines that
        # died while the control plane was down never re-register. They
        # fold into the first adopted run's recovery cycle — or, with
        # no run to adopt, recover standalone
        dead_grid = sorted(mid for mid in in_grid
                           if not self.cluster[mid].alive)
        first = True
        for jid in sorted(open_runs, key=lambda s: int(s[1:])):
            self._adopt_run(jid, open_runs[jid],
                            extra_dead=dead_grid if first else ())
            first = False
        if not open_runs:
            for mid in dead_grid:
                self.unexpected_failure(mid)

    def _adopt_run(self, jid: str, r: dict, extra_dead=()) -> None:
        """Rebuild one in-flight MigrationRun from its journal record
        and drive it to COMMITTED. The step list is rebuilt through the
        same builders the original controller used (step names are
        stable), journaled done-steps are skipped by the state machine,
        and the rollback ledger is reconstructed from the journaled
        switch plans. Participants that died while the control plane
        was down are folded in as a synthetic mid-switch fault before
        the run resumes."""
        op, params, meta = r["op"], r["params"], r["meta"]
        affected = [self.engine.groups[gid] for gid in params["gids"]]
        pairing = {int(l): int(j)
                   for l, j in (meta.get("pairing")
                                or params.get("pairing") or [])}
        xferred = set(int(m) for m in meta.get("xferred", []))
        lanes0 = {ln: self.clock.lane_total(ln)
                  for ln in ("downtime", "overlap")}
        run = MigrationRun(self.clock, label=r["label"])
        run.resumes = r["resumes"]
        known_dead: set = set()
        if op == "expected_migration":
            rep = MigrationReport("expected")
            rep.pairs = pairing
            # the cascade callback is a live closure and cannot be made
            # durable; adoption only has to *skip* it (done), never run it
            has_seam = "cascade_seam" in r["steps"]
            assert not (has_seam and "cascade_seam" not in r["done"]), \
                f"{jid}: cannot adopt a run with a pending cascade seam"
            run.set_steps(self._expected_steps(
                run, rep, [int(l) for l in params["leavers"]], pairing,
                affected, xferred, lanes0, params["train_during_prep"],
                (lambda _ctl: None) if has_seam else None))
        elif op == "unexpected_failure":
            rep = MigrationReport("unexpected")
            if pairing:
                rep.pairs = dict(pairing)
            ctx: Dict[str, Any] = {}
            if "used_standby" in meta:
                ctx["used_standby"] = meta["used_standby"]
            known_dead = {int(params["failed"])}
            run.set_steps(self._failure_steps(
                run, rep, int(params["failed"]), affected, pairing, ctx,
                params["use_standby"], params["dirty"]))
        elif op == "dp_resize":
            if params["direction"] == "shrink":
                rep = MigrationReport("dp_shrink")
                chain = {int(s): int(m) for s, m in params["chain"]}
                known_dead = {int(params["victim"])}
                run.set_steps(self._dp_shrink_steps(
                    run, rep, int(params["victim"]), int(params["d_gone"]),
                    chain, affected, lanes0))
            else:
                rep = MigrationReport("dp_regrow")
                staff = {int(s): int(m) for s, m in params["staff"]}
                run.set_steps(self._dp_grow_steps(
                    run, rep, int(params["d"]), staff, affected, lanes0))
        else:
            assert op == "reshard_recovery", f"unknown journaled op {op}"
            rep = MigrationReport("gpu_reshard")
            run.set_steps(self._reshard_steps(
                run, rep, int(params["victim"]), affected, lanes0))
        assert [s.name for s in run.steps] == list(r["steps"]), \
            (jid, [s.name for s in run.steps], r["steps"])
        run.done = set(r["done"])
        run.state = MigState(r["state"])
        for sw in r["switched"]:
            # replaying run_switch records already in the journal;
            # re-appending them here would duplicate history
            # repro: allow(journal-coverage)
            run.record_switch(self.engine.groups[sw["gid"]],
                              plan_from_dict(sw["plan"]))
        # re-wire the observer under the SAME jid: post-adoption
        # records extend this run's existing journal history
        run.jid = jid
        run.observer = self._run_observer(jid)
        self.journal.append("run_adopt",
                            {"run": jid, "done": sorted(run.done)})
        # victims that landed while the control plane was down: every
        # dead participant (plus the dead grid machines the health
        # check surfaced) except the failure this run was already
        # recovering becomes a synthetic mid-switch fault, handled by
        # the standard rollback/replan/resume machinery
        participants = set(pairing) | set(pairing.values())
        participants |= set(extra_dead)
        for g in affected:
            participants |= set(g.members)
        dead = sorted(m for m in participants - known_dead
                      if not self.cluster[m].alive)
        if dead:
            self._recover_mid_switch(
                run, MidSwitchFault("controller_restart", dead),
                pairing, affected, xferred)
        self._drive_run(run, rep, pairing, affected, xferred,
                        lanes0["downtime"])

    # ------------------------------------------------------- maintenance
    def rebalance(self, n_machines: int) -> MigrationReport:
        """Periodic load-rebalancing: migrate n machines at once."""
        leavers = self._training_mids()[:n_machines]
        return self.expected_migration(leavers)

    def handle_straggler(self, slowdown: float = 1.2,
                         victim: Optional[int] = None) -> MigrationReport:
        victim = victim if victim is not None else self._training_mids()[0]
        self.cluster[victim].straggle_factor = slowdown
        rep = self.expected_migration([victim], train_during_prep=1)
        return rep

    def gpu_fault(self, victim: Optional[int] = None,
                  inject: Optional[FaultPoint] = None,
                  policy: str = "migrate",
                  lose: int = 1,
                  crash: Optional[CrashPoint] = None) -> MigrationReport:
        """GPU-granularity fault (§9 future work): `lose` devices on
        the victim degrade instead of the machine dying. Recovery
        policies, selectable per fault (Chameleon-style):

        - "migrate": state stays resident and the machine keeps
          training (slowed) while its replacement is prepared off the
          critical path — the expected-migration path with advance
          notice, so downtime matches a planned leave.
        - "reshard": the machine stays in the grid and re-splits its
          shard across the surviving devices in place (ElasWave-style)
          — cheaper downtime, degraded throughput until maintenance.
        - "dp_shrink" / "ckpt_restart": the degraded-continuation and
          full-restart recoveries, dispatchable directly (the campaign
          policy axis) though `auto` only reaches them when the pool
          offers nothing better.
        - "auto": consult the PolicyEngine (core/policy.py) — rank
          every feasible recovery by CostModel-predicted downtime over
          live telemetry, journal the decision, dispatch the winner.
          (Used to be a fixed reshard_min_fraction threshold; the knob
          survives only as the engine's re-shard safety clamp.)
        """
        victim = victim if victim is not None else self._training_mids()[0]
        m = self.cluster[victim]
        m.degrade_gpu(lose)
        if policy == "auto":
            policy = self._consult_policy(victim, "gpu_fault").chosen
        if policy == "reshard":
            return self.reshard_recovery(victim, inject=inject,
                                         crash=crash)
        if policy == "dp_shrink":
            return self.dp_shrink(victim, inject=inject, crash=crash)
        if policy == "ckpt_restart":
            return self.checkpoint_restart(victim)
        if policy != "migrate":
            raise ValueError(f"unknown recovery policy {policy!r}; "
                             f"known: {', '.join(KNOWN_POLICIES)} "
                             "(or 'auto')")
        rep = self.expected_migration([victim], train_during_prep=1,
                                      inject=inject, crash=crash)
        rep.kind = "gpu_degrade"
        return rep

    def reshard_recovery(self, victim: int,
                         inject: Optional[FaultPoint] = None,
                         crash: Optional[CrashPoint] = None
                         ) -> MigrationReport:
        """Intra-machine re-sharding recovery for a partial-GPU fault:
        the victim keeps its grid slot and re-splits its shard across
        its surviving devices — lost slices re-fetch from the DP
        replica, survivors re-layout over NVLink, and the victim's
        channel QPs re-bind through a re-shard delta
        (groups.compute_reshard_plan / two_phase.ccl_reshard_switchover)
        instead of a membership splice. Driven as a journaled run, so a
        concurrent fault landing inside the re-shard aborts, recovers
        and resumes like any other migration (and a controller crash
        inside it is adopted by `Controller.restart()`)."""
        rep = MigrationReport("gpu_reshard")
        affected = self._affected_groups([victim])
        lanes0 = {ln: self.clock.lane_total(ln)
                  for ln in ("downtime", "overlap")}
        run = MigrationRun(self.clock, fault=inject,
                           label=f"reshard:{victim}")
        run.crash = crash
        run.set_steps(self._reshard_steps(run, rep, victim, affected,
                                          lanes0))
        self._journal_run_begin(run, "reshard_recovery", {
            "victim": victim, "gids": [g.gid for g in affected]})
        self._drive_run(run, rep, {}, affected, set(),
                        lanes0["downtime"])
        return rep

    def _reshard_steps(self, run: MigrationRun, rep: MigrationReport,
                       victim: int, affected: List[CommGroup],
                       lanes0: Dict[str, float]) -> List[Step]:
        """Build the re-shard step list (factored out so a restarted
        controller can rebuild it when adopting a journaled run)."""
        def gone():
            # the re-sharding machine itself died mid-reshard and a
            # recovery replaced it: the remaining re-shard steps are
            # moot (the replacement holds a whole, healthy shard)
            return victim not in self.engine.grid.values()

        def plan():
            # local-only planning, overlapped with (degraded) training:
            # the machine knows its own surviving devices, so staging
            # the re-shard delta is ms-level like the standby delta plan
            todo = [g for g in affected
                    if f"switch:{g.gid}" not in run.done
                    and victim in g.members]
            for g in todo:
                p = compute_reshard_plan(g, victim)
                g.pending_plan = p
                g.pending_members = p.new_members
                g.state = GroupState.READY_TO_SWITCHOUT
            self.clock.advance(0.05 * len(todo), "reshard_plan",
                               lane="overlap")

        def barrier():
            rep.overlap = self.clock.lane_total("overlap") \
                - lanes0["overlap"]
            self.clock.advance(self.cost.iteration_barrier, "drain",
                               lane="downtime")
            rep.barrier += self.cost.iteration_barrier

        def resplit():
            if gone():
                return
            tr = state_sync.reshard_in_place(self.engine, victim,
                                             self.clock, self.cost)
            rep.state_transfer_s = tr.seconds
            rep.state_bytes = tr.nbytes
            rep.state_path = tr.path

        steps = [Step("prepare:all", "prepare", plan,
                      MigState.DELTA_PREPARED),
                 Step("barrier", "barrier", barrier, MigState.SWITCHING),
                 Step("resplit", "xfer", resplit)]
        steps += [Step(f"switch:{g.gid}", "switch",
                       self._switch_step(run, rep, g))
                  for g in affected]
        steps.append(Step("commit", "commit", lambda: None,
                          MigState.COMMITTED))
        return steps
