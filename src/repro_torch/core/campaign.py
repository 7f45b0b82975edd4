"""Deterministic fault-injection campaign engine (counterpart of
`repro/core/campaign.py`: the reference's code, with one edit — the
run's `device`, passed to the engine).

Drives `Controller` through a declarative scenario matrix —
interruption kind (expected leave, unexpected failure, GPU-granular
degradation, straggler, rebalance, standby loss, controller crash) x
role
(first/middle/last stage, every DP rank, the standby itself, and in
victim *sets* the joiner or the leaver of an in-flight migration) x
timing (between iterations, mid-iteration before/after the bucket
reduce, during an in-flight migration, *inside the switching machinery
itself* — during phase-1 delta prep, during sandboxed warmup, between
per-group switchovers, or as a concurrent second failure — and
back-to-back cascades) x victim-set size (K in {1, 2, 3, 5} concurrent
failures in one switching window) x recovery path (standby promotion,
intra-machine re-sharding for partial-GPU faults, standby-exhausted
elastic fallback, checkpoint-restart overflow fallback when victims
outnumber standbys, full-reinit baseline) — and records a structured
`ScenarioResult` per run: sim downtime split by lane via the SimClock
ledger, loss parity against an uninterrupted reference run with the
same seed, migrated bytes, delta fraction, abort/resume cycles of the
migration state machine, and checkpoint-restart fallback counts.

Every run is fully deterministic: one seed threads through the data
stream and Controller, and the engine's `sim_compile_seconds` knob
replaces measured stage-program build charges with a modeled
constant, so repeated campaigns emit byte-identical payloads.

The campaign reproduces the paper's constant-downtime figure shape:
standby-recovery downtime stays flat across roles and timings while
the full-reinit baseline is an order of magnitude above it.
"""
from __future__ import annotations

import dataclasses
import json
import random
from dataclasses import dataclass, field
from statistics import median
from typing import Any, Dict, List, Optional

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.core import standby as standby_mod
from repro_torch.core.controller import Controller
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.migration import ControllerCrash, CrashPoint, FaultPoint
from repro_torch.core.sandbox import CommHooks
from repro_torch.core.simexec import SimExecEngine

LANES = ("downtime", "overlap", "train")

# timing axis values that land *inside* the migration state machine;
# each maps to the (step kind, occurrence) the FaultPoint (or, for
# controller_crash scenarios, the CrashPoint) fires at
MID_SWITCH_TIMINGS = {
    "during_prepare": ("prepare", 1),
    "during_warmup": ("warmup", 0),
    "mid_switchover": ("switch", 1),
    "concurrent_second_failure": ("switch", 1),
    # failure-recovery runs only: crash before the state-recovery step
    "mid_recovery": ("recover", 0),
}


# ---------------------------------------------------------------- model
@dataclass
class Scenario:
    """One declarative campaign entry. `role` names the victim by grid
    coordinates ("d0s1") or "standby"; scenario-specific knobs
    (standby_count, cascade victims, migration leaver) ride in
    `params`. A `victims` list in params turns the scenario into a
    victim *set*: entries are grid coordinates or the special tokens
    "joiner" / "leaver" / "standby", resolved against the in-flight
    migration at injection time."""
    name: str
    kind: str        # expected | failure | gpu_degrade | straggler |
    #                # rebalance | standby_loss | controller_crash
    role: str
    timing: str      # between_iter | pre_reduce | post_reduce |
    #                # during_migration | during_prepare | during_warmup |
    #                # mid_switchover | mid_recovery |
    #                # concurrent_second_failure | cascade
    recovery: str    # migration | standby | reshard | ckpt_restart |
    #                # full_reinit | replace | replay
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ScenarioResult:
    name: str
    kind: str
    role: str
    timing: str
    recovery: str
    events: int                  # interruptions injected by the scenario
    downtime_s: float            # SimClock downtime-lane delta
    downtime_per_event_s: float
    overlap_s: float             # overlapped (hidden) preparation work
    train_s: float               # foreground training inside the window
    migrated_bytes: int
    delta_fraction: float
    lost_iterations: int
    recovery_path: str           # leaver | neighbor | storage | dp_peer | ""
    loss_max_delta: float        # vs the uninterrupted reference run
    loss_parity: bool
    steps: int                   # committed iterations at scenario end
    seed: int                    # the one seed that governed the run
    resumes: int = 0             # migration-state-machine abort/resumes
    # size of the scenario's declared victim set (0 = single-victim
    # scenario); `events` additionally counts the in-flight migration
    # for mid-switch timings, so K comes from here, not events
    victims: int = 0
    # baseline restart windows paid because the standby pool overflowed
    # mid-cycle (exempt from the flat-downtime envelope, but reported)
    ckpt_fallbacks: int = 0
    # churn-storm axes: the advance-notice window driving the scenario
    # (0 for no-notice), and how many dp_shrink / dp_regrow cycles the
    # degraded-mode continuation actually ran
    notice_s: float = 0.0
    degraded_events: int = 0
    regrow_events: int = 0
    # goodput accounting over the WHOLE scenario window (gpu-recipes
    # definitions): ettr = train/(train+downtime); scheduling goodput
    # additionally credits overlapped prep; runtime goodput is ideal
    # train seconds (warmup-measured per-iter x committed steps) over
    # actual train seconds (degraded-mode hosting load lands here);
    # recovery goodput divides the same ideal by train+downtime — the
    # headline number the shrink-vs-checkpoint comparison uses
    ettr: float = 1.0
    sched_goodput: float = 1.0
    runtime_goodput: float = 1.0
    recovery_goodput: float = 1.0
    # policy axis: the policy the scenario requested ("" when the kind
    # has no policy knob), what the PolicyEngine chose when consulted
    # (last journaled `policy` record; "" when never consulted), and
    # which candidates that decision ranked feasible
    policy: str = ""
    policy_choice: str = ""
    policy_feasible: List[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class CampaignCfg:
    """Shared run shape. The default model is the tiny GPT driven by
    the real tensor engine; the matrix, not the model, is what the
    campaign scales. `mode="sim"` swaps in the tensor-free
    `SimExecEngine` (identical SimClock ledgers, no math — see
    core/simexec.py), and `arch` names a registry config (e.g.
    "gpt-10b", "yi-34b") for paper-scale runs that only sim-exec can
    carry. `device` is where the real engine runs: None is the CUDA
    card, "cpu" the CPU."""
    dp: int = 2
    pp: int = 2
    layers: int = 4
    d_model: int = 64
    heads: int = 4
    vocab: int = 256
    global_batch: int = 8
    seq_len: int = 32
    micro_batches: int = 2
    warmup_iters: int = 2        # committed iterations before injection
    total_iters: int = 6         # committed iterations at scenario end
    standby_count: int = 1
    seed: int = 0
    # deterministic-simulation constant for every measured compile /
    # shadow-exec charge (see PipelineEngine.sim_compile_seconds)
    sim_compile_seconds: float = 0.5
    # "real" = tensor engine; "sim" = model-free SimExecEngine
    mode: str = "real"
    # named registry arch (overrides the tiny-GPT layers/d/heads/vocab
    # knobs above); None keeps the CPU-runnable tiny GPT
    arch: Optional[str] = None
    # cluster size override; None keeps dp*pp + standby + 3 spares
    machines: Optional[int] = None
    # per-machine device memory; 16 GiB fits the tiny model, paper-
    # scale sim runs raise it to the 8x80 GiB a real machine has
    device_capacity_gb: float = 16.0
    # devices per machine: the GPU-granular scenarios derive their
    # loss counts from this (lose_fraction), so sim-exec runs at other
    # machine shapes exercise the same surviving fraction
    gpus_per_machine: int = 8
    # the real engine's device (None: the card); the sim engine holds
    # no tensor and takes the meta device when given None
    device: Optional[str] = None


# ---------------------------------------------------------------- build
def build_controller(cfg: CampaignCfg, standby_count: int,
                     cost: CostModel = DEFAULT,
                     per_iteration_ckpt: bool = True) -> Controller:
    if cfg.arch is not None:
        from repro_torch.models.registry import get_config
        arch = get_config(cfg.arch)
    else:
        arch = tiny_gpt(layers=cfg.layers, d=cfg.d_model,
                        heads=cfg.heads, vocab=cfg.vocab)
    n_machines = cfg.machines if cfg.machines is not None \
        else cfg.dp * cfg.pp + standby_count + 3   # spares for joiners
    assert n_machines >= cfg.dp * cfg.pp + standby_count
    cluster = Cluster(n_machines, gpus_per_machine=cfg.gpus_per_machine,
                      device_capacity=int(cfg.device_capacity_gb
                                          * 2 ** 30))
    clock = SimClock()
    comm = CommHooks(clock, cost)
    engine_cls = SimExecEngine if cfg.mode == "sim" else PipelineEngine
    assert cfg.mode in ("real", "sim"), cfg.mode
    eng = engine_cls(arch, dp=cfg.dp, pp=cfg.pp,
                     global_batch=cfg.global_batch,
                     seq_len=cfg.seq_len, cluster=cluster,
                     clock=clock, comm=comm, cost=cost,
                     micro_batches=cfg.micro_batches, seed=cfg.seed,
                     sim_compile_seconds=cfg.sim_compile_seconds,
                     device=cfg.device)
    ctl = Controller(eng, cost=cost, standby_count=standby_count,
                     per_iteration_ckpt=per_iteration_ckpt,
                     seed=cfg.seed)
    ctl.bootstrap_job(list(range(cfg.dp * cfg.pp)))
    return ctl


def _victim(ctl: Controller, role: str) -> int:
    """Resolve a "d{d}s{s}" role descriptor to a machine id."""
    d, s = role[1:].split("s")
    return ctl.engine.grid[(int(d), int(s))]


def _train_to(ctl: Controller, target_step: int,
              losses: Dict[int, float]) -> None:
    """Drive committed iterations up to `target_step`, recording each
    committed (step, loss) pair. Re-runs after a rollback overwrite
    the same keys — bitwise-identically when the run is deterministic."""
    while ctl.engine.step_count < target_step:
        it = ctl.engine.step_count
        losses[it] = ctl.engine.train_iteration()
        ctl._tick_checkpoints()


# ----------------------------------------------------------- churn traces
@dataclass
class ChurnEvent:
    """One interruption in a churn storm. `t` orders events within the
    trace (informational — drive_churn_trace executes them in order);
    `target` is a grid coordinate ("d0s1") or "" for replenish events.
    A non-zero `notice_s` marks a spot preemption with advance notice;
    `factor` carries the straggle-ramp slowdown."""
    t: float
    kind: str                   # preempt | drain | straggle | replenish
    target: str
    notice_s: float = 0.0
    factor: float = 1.0


@dataclass
class ChurnTrace:
    seed: int
    horizon_s: float
    events: List[ChurnEvent] = field(default_factory=list)


def generate_churn_trace(seed: int, dp: int = 2, pp: int = 2,
                         horizon_s: float = 600.0,
                         wave_rate_per_min: float = 2.0,
                         notice_p: float = 0.5,
                         rack_p: float = 0.15,
                         straggler_p: float = 0.2,
                         replenish_p: float = 0.25,
                         max_events: int = 12,
                         cost: CostModel = DEFAULT) -> ChurnTrace:
    """Seeded churn-storm generator: Poisson preemption waves whose
    events carry 30-120s advance notice (spot-style) or none at all
    (hard failures), one-machine-at-a-time rack drains across a DP
    chain, gradually-degrading stragglers ramping over consecutive
    events, and scheduler capacity hand-backs (replenish). The trace
    always ENDS with enough replenish events to re-grow every retired
    chain and refill the standby pool — so every storm scenario can be
    asserted back at full DP degree and bitwise parity."""
    rng = random.Random(seed)
    events: List[ChurnEvent] = []
    t = 0.0
    while t < horizon_s and len(events) < max_events:
        t += rng.expovariate(wave_rate_per_min / 60.0)
        r = rng.random()
        if r < rack_p:
            # rack maintenance: the whole chain of one DP rank drains
            # one machine at a time, each with the same advance notice
            d = rng.randrange(dp)
            notice = rng.uniform(cost.notice_min_s, cost.notice_max_s)
            for s in range(pp):
                events.append(ChurnEvent(t + s, "drain", f"d{d}s{s}",
                                         notice))
        elif r < rack_p + straggler_p:
            coord = f"d{rng.randrange(dp)}s{rng.randrange(pp)}"
            for k, f in enumerate((1.05, 1.15, 1.3)):
                events.append(ChurnEvent(t + k, "straggle", coord,
                                         factor=f))
        else:
            coord = f"d{rng.randrange(dp)}s{rng.randrange(pp)}"
            notice = (rng.uniform(cost.notice_min_s, cost.notice_max_s)
                      if rng.random() < notice_p else 0.0)
            events.append(ChurnEvent(t, "preempt", coord, notice))
        if rng.random() < replenish_p:
            events.append(ChurnEvent(t + 5.0, "replenish", ""))
    for k in range(pp + 2):
        events.append(ChurnEvent(horizon_s + k, "replenish", ""))
    return ChurnTrace(seed=seed, horizon_s=horizon_s, events=events)


def _resolve_slot(ctl: Controller, coord: str) -> Optional[int]:
    """Grid coordinate -> current live occupant, or None when the slot
    is retired (hosted by a DP peer) or its machine already died."""
    d, s = coord[1:].split("s")
    key = (int(d), int(s))
    if key in ctl.engine.hosted:
        return None
    mid = ctl.engine.grid.get(key)
    if mid is None or not ctl.cluster[mid].alive:
        return None
    return mid


def drive_churn_trace(ctl: Controller, trace: ChurnTrace,
                      baseline: bool = False,
                      max_step: Optional[int] = None) -> int:
    """Execute a churn trace against a live Controller; returns the
    number of interruptions injected. With baseline=True every fault
    takes the checkpoint-restart path (storage saved after each commit
    so no work is ever retrained — a conservative gift to the
    baseline); otherwise noticed events run the proactive drain,
    no-notice events the standby path, and a dry bounded pool falls
    through to degraded-mode dp_shrink. One committed iteration is
    interleaved after each fault while `max_step` allows, so degraded
    windows actually train (and pay their hosting load)."""
    events = 0

    def maybe_train():
        if max_step is not None and ctl.engine.step_count < max_step:
            ctl.engine.train_iteration()
            ctl._tick_checkpoints()
            if baseline:
                ctl.save_to_storage()

    for ev in trace.events:
        if ev.kind == "replenish":
            # the provider hands one machine back; retired chains
            # re-grow oldest-first, then the standby pool refills from
            # whatever idle capacity remains
            if (ctl.engine.hosted
                    or len(ctl.standbys) < ctl.standby_count):
                ctl.cluster.add_machine()
            ctl.maybe_regrow()
            spares = ctl._idle_spares()
            target = min(ctl.standby_count,
                         len(ctl.standbys) + len(spares))
            if target > len(ctl.standbys):
                standby_mod.replenish(ctl.engine, ctl.cluster,
                                      ctl.standbys, ctl.clock, ctl.cost,
                                      target=target)
                ctl._journal_standbys()
            continue
        mid = _resolve_slot(ctl, ev.target)
        if mid is None:
            continue
        if ev.kind == "straggle":
            ctl.cluster[mid].straggle_factor = ev.factor
            # migrating a straggler away trains one overlapped
            # iteration, so it needs both a joiner AND step budget
            if (ev.factor >= 1.25
                    and (ctl.elastic_pool or ctl._idle_spares())
                    and (max_step is None
                         or ctl.engine.step_count < max_step)):
                events += 1
                ctl.handle_straggler(slowdown=ev.factor, victim=mid)
            continue
        assert ev.kind in ("preempt", "drain"), ev.kind
        events += 1
        if baseline:
            ctl.checkpoint_restart(mid)
            ctl.save_to_storage()
        elif ev.notice_s > 0 and (ctl.elastic_pool or ctl._idle_spares()):
            ctl.preemption_notice(mid, notice_s=ev.notice_s)
        else:
            # no notice — or a notice with nowhere to drain TO (bounded
            # pool, no idle spare): the proactive path needs a joiner,
            # so the revocation lands as an unexpected failure (standby
            # promotion, or degraded-mode shrink once the pool is dry)
            ctl.unexpected_failure(mid)
        maybe_train()
    return events


# ------------------------------------------------------------- matrices
def default_matrix(dp: int = 2, pp: int = 2) -> List[Scenario]:
    """The full campaign: every interruption kind crossed with the
    distinct roles, timings and recovery paths the runtime supports
    (>= 20 scenarios at dp=2, pp=2)."""
    stages = {"first": 0, "last": pp - 1}
    if pp > 2:
        stages["middle"] = 1
    scs: List[Scenario] = []
    # expected leave: every stage role, plus every DP rank at stage 0
    for rn, s in stages.items():
        scs.append(Scenario(f"expected-{rn}", "expected", f"d0s{s}",
                            "between_iter", "migration"))
    for d in range(1, dp):
        scs.append(Scenario(f"expected-dp{d}", "expected", f"d{d}s0",
                            "between_iter", "migration"))
    # unexpected failure -> standby promotion, across roles
    for rn, s in stages.items():
        scs.append(Scenario(f"fail-{rn}-standby", "failure", f"d0s{s}",
                            "between_iter", "standby"))
    for d in range(1, dp):
        scs.append(Scenario(f"fail-dp{d}-standby", "failure", f"d{d}s0",
                            "between_iter", "standby"))
    # mid-iteration failures, before and after the bucket reduce
    for phase in ("pre_reduce", "post_reduce"):
        for rn, s in stages.items():
            scs.append(Scenario(f"fail-{rn}-{phase}", "failure",
                                f"d0s{s}", phase, "standby"))
    # failure landing while an expected migration is in flight: the
    # victim shares a DP group with the migrating leaver, so the
    # cascade invalidates the staged delta plan (re-prepared before
    # the switch)
    scs.append(Scenario("fail-during-migration", "failure",
                        f"d{min(dp - 1, 1)}s{pp - 1}", "during_migration",
                        "standby", {"migrate": f"d0s{pp - 1}"}))
    # failures landing *inside* the migration state machine itself:
    # during phase-1 delta prep, during sandboxed warmup, and between
    # per-group switchovers (the run aborts, rolls partially-switched
    # groups back to a consistent epoch, recovers via standby, replans
    # and resumes)
    vic = f"d{min(dp - 1, 1)}s0"
    for timing in ("during_prepare", "during_warmup", "mid_switchover"):
        scs.append(Scenario(f"fail-{timing.replace('_', '-')}", "failure",
                            vic, timing, "standby",
                            {"migrate": f"d0s{pp - 1}"}))
    # two concurrent failures landing mid-switch (different groups,
    # handled back-to-back before one resume)
    scs.append(Scenario("fail-concurrent-second", "failure", vic,
                        "concurrent_second_failure", "standby",
                        {"migrate": f"d0s{pp - 1}", "standby_count": 2,
                         "victims": [vic, "d0s0"]}))
    # generalized victim sets: K >= 3 concurrent failures landing in
    # one switching window, roles mixed across stages, DP ranks, the
    # standby pool, the joiner and the leaver itself — each absorbed
    # by a single rollback-replan-resume cycle (the paper's "any role,
    # any interruption" claim, beyond pairs)
    last = pp - 1
    vic2 = f"d{min(dp - 1, 1)}s{last}"
    scs.append(Scenario("fail-k3-stages", "failure", vic,
                        "mid_switchover", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 3,
                         "victims": [vic, "d0s0", vic2]}))
    scs.append(Scenario("fail-k3-joiner", "failure", vic,
                        "mid_switchover", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 2,
                         "victims": ["joiner", vic, "d0s0"]}))
    scs.append(Scenario("fail-k2-leaver-prexfer", "failure", "leaver",
                        "during_warmup", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 2,
                         "victims": ["leaver", vic]}))
    scs.append(Scenario("fail-k3-leaver-postxfer", "failure", "leaver",
                        "mid_switchover", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 2,
                         "victims": ["leaver", vic, "d0s0"]}))
    scs.append(Scenario("fail-k3-standby", "failure", vic,
                        "mid_switchover", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 3,
                         "victims": ["standby", vic, "d0s0"]}))
    scs.append(Scenario("fail-k5-mixed", "failure", vic,
                        "mid_switchover", "standby",
                        {"migrate": f"d0s{last}", "standby_count": 4,
                         "victims": ["joiner", "standby", vic, "d0s0",
                                     vic2]}))
    # victims outnumber the standby pool with no in-memory redundancy:
    # the overflow falls back to the checkpoint-restart baseline
    # (exempt from the flat-downtime envelope, but reported)
    scs.append(Scenario("fail-k3-overflow-ckpt", "failure", vic,
                        "mid_switchover", "ckpt_restart",
                        {"migrate": f"d0s{last}", "standby_count": 1,
                         "per_iteration_ckpt": False,
                         "save_storage": True,
                         "victims": [vic, "d0s0", vic2]}))
    scs.append(Scenario("cascade-k3", "failure", "d0s0", "cascade",
                        "standby",
                        {"standby_count": 3,
                         "victims": ["d0s0", vic, f"d0s{last}"]}))
    # GPU-granularity faults (§9): one device degrades, the machine
    # keeps training while migrated away with notice
    scs.append(Scenario("gpu-degrade-first", "gpu_degrade", "d0s0",
                        "between_iter", "migration"))
    scs.append(Scenario("gpu-degrade-last", "gpu_degrade", f"d0s{pp - 1}",
                        "between_iter", "migration"))
    # ... or re-shard in place across the surviving devices (ElasWave-
    # style): no migration, the victim keeps its grid slot, lost slices
    # re-fetch from the DP replica. The auto policy consults the
    # PolicyEngine (core/policy.py) over live telemetry — a machine
    # losing EVERY device has nothing left to re-shard onto, so auto
    # migrates after all. The loss count derives from the per-machine
    # device count (lose_fraction), not a hard-coded GPU count, so the
    # scenario exercises the same surviving fraction at any shape.
    scs.append(Scenario("gpu-reshard-first", "gpu_degrade", "d0s0",
                        "between_iter", "reshard"))
    scs.append(Scenario("gpu-reshard-last", "gpu_degrade",
                        f"d0s{pp - 1}", "between_iter", "reshard"))
    scs.append(Scenario("gpu-auto-migrate-heavy", "gpu_degrade", "d0s0",
                        "between_iter", "migration",
                        {"policy": "auto", "lose_fraction": 1.0}))
    # a machine failure landing inside a re-shard run's OWN switch
    # steps: the re-shard aborts, rolls its flipped groups back,
    # recovers the DP-peer victim via standby, re-stages the re-shard
    # deltas against the new membership and resumes
    scs.append(Scenario("gpu-reshard-mid-switch", "gpu_degrade", "d0s0",
                        "mid_switchover", "reshard",
                        {"standby_count": 2,
                         "victims": [f"d{min(dp - 1, 1)}s0"]}))
    # controller crashes (control-plane interruptions): the controller
    # process dies and a fresh one restarts from the ControlJournal —
    # workers re-register, open runs are adopted at every journaled
    # step class, and bitwise parity must survive the handover
    crash_mig = f"d0s{pp - 1}"
    scs.append(Scenario("crash-idle", "controller_crash", "controller",
                        "between_iter", "replay"))
    for timing in ("during_prepare", "during_warmup", "mid_switchover"):
        scs.append(Scenario(f"crash-{timing.replace('_', '-')}",
                            "controller_crash", "controller", timing,
                            "replay", {"migrate": crash_mig}))
    scs.append(Scenario("crash-mid-recovery", "controller_crash",
                        "controller", "mid_recovery", "replay",
                        {"fail": crash_mig, "standby_count": 1}))
    # the control plane dies mid-switchover AND a data-plane machine
    # dies while it is down: the restarted controller must fold the
    # victim into the adopted run before resuming it
    scs.append(Scenario("crash-with-victim", "controller_crash",
                        "controller", "concurrent_second_failure",
                        "replay",
                        {"migrate": crash_mig, "standby_count": 2,
                         "victims": [f"d{min(dp - 1, 1)}s0"]}))
    # back-to-back cascades: two failures with no training between
    scs.append(Scenario("cascade-two-standbys", "failure", "d0s0",
                        "cascade", "standby",
                        {"standby_count": 2,
                         "victims": ["d0s0", f"d{min(dp - 1, 1)}s0"]}))
    # standby-exhausted fallbacks: no per-iteration in-memory
    # checkpoints, so the elastic joiner genuinely restores from the
    # last *storage* checkpoint (sandbox/CCL/state-fetch still
    # overlap, unlike a serialized restart)
    scs.append(Scenario("cascade-exhausted", "failure", "d0s0",
                        "cascade", "ckpt_restart",
                        {"standby_count": 1, "save_storage": True,
                         "per_iteration_ckpt": False,
                         "victims": ["d0s0", f"d{min(dp - 1, 1)}s0"]}))
    scs.append(Scenario("fail-no-standby", "failure", "d0s0",
                        "between_iter", "ckpt_restart",
                        {"standby_count": 0, "save_storage": True,
                         "per_iteration_ckpt": False}))
    # full-reinit checkpoint-restart baseline, across roles
    for rn, s in stages.items():
        scs.append(Scenario(f"fail-{rn}-full-reinit", "failure",
                            f"d0s{s}", "between_iter", "full_reinit",
                            {"standby_count": 0, "save_storage": True}))
    # stragglers (migrated away while training keeps running)
    for rn, s in stages.items():
        scs.append(Scenario(f"straggler-{rn}", "straggler", f"d0s{s}",
                            "between_iter", "migration",
                            {"slowdown": 1.3}))
    # gradually-degrading straggler: the slowdown ramps over committed
    # iterations before crossing the migrate threshold (fig13 feeds on
    # this scenario's real-Controller numbers)
    scs.append(Scenario("straggler-gradual", "straggler", "d0s0",
                        "between_iter", "migration",
                        {"ramp": [1.05, 1.15, 1.3]}))
    # advance-notice drains (spot preemptions): with a window longer
    # than prepare+warmup the switchover lands with near-zero downtime;
    # a too-short window expires mid-prepare and falls back to the
    # unexpected-failure path (hence recovery "standby")
    scs.append(Scenario("notice-drain-long", "notice_drain",
                        f"d0s{pp - 1}", "between_iter", "migration",
                        {"notice_s": 120.0}))
    scs.append(Scenario("notice-drain-short", "notice_drain", "d0s0",
                        "between_iter", "standby", {"notice_s": 0.3}))
    scs.append(Scenario("notice-drain-rack", "notice_drain", "d0s0",
                        "between_iter", "migration",
                        {"notice_s": 90.0,
                         "drain": [f"d0s{s}" for s in range(pp)]}))
    # churn storms: a seeded trace of preemption waves, drains,
    # stragglers and capacity hand-backs. The degraded variant runs a
    # BOUNDED pool (no elastic machines): once standbys and spares are
    # gone the DP degree shrinks via rank-hosting and re-grows when the
    # scheduler hands capacity back. The ckpt variant replays the SAME
    # trace against the checkpoint-restart baseline.
    scs.append(Scenario("churn-storm-degraded", "churn_storm", "trace",
                        "between_iter", "degraded",
                        {"storm_seed": 1305, "max_step": 6,
                         "save_storage": True}))
    scs.append(Scenario("churn-storm-ckpt", "churn_storm", "trace",
                        "between_iter", "ckpt_restart",
                        {"storm_seed": 1305, "max_step": 6,
                         "save_storage": True, "baseline": True}))
    # periodic rebalance: batch migrations of different sizes
    scs.append(Scenario("rebalance-1", "rebalance", "batch1",
                        "between_iter", "migration", {"n": 1}))
    scs.append(Scenario("rebalance-ring", "rebalance", f"batch{pp}",
                        "between_iter", "migration", {"n": pp}))
    # the interruption hits the standby itself: zero downtime
    scs.append(Scenario("standby-loss", "standby_loss", "standby",
                        "between_iter", "replace"))
    return scs


REDUCED_NAMES = (
    "expected-first", "fail-first-standby", "fail-last-standby",
    "fail-dp1-standby", "fail-first-pre_reduce", "fail-first-post_reduce",
    "fail-no-standby", "fail-first-full-reinit", "standby-loss",
    # mid-switch slice: every state-machine timing is represented
    "fail-during-prepare", "fail-during-warmup", "fail-mid-switchover",
    "fail-concurrent-second", "fail-during-migration",
    # victim sets + GPU-granular recoveries (migrate vs re-shard)
    "fail-k3-joiner", "gpu-degrade-first", "gpu-reshard-first",
    "gpu-reshard-mid-switch",
    # controller-crash slice: one crash inside the switching window,
    # one inside a failure recovery (the only mid_recovery timing),
    # one with a data-plane victim landing while the plane is down
    "crash-mid-switchover", "crash-mid-recovery", "crash-with-victim",
    # remaining kind/timing axis values, so the reduced slice covers
    # every axis value of the full matrix (asserted by
    # test_reduced_covers_every_kind_and_timing — grow this tuple when
    # a new axis value lands)
    "straggler-first", "rebalance-1", "cascade-two-standbys",
    # churn-storm slice: one long-notice drain (near-zero downtime),
    # one expiring notice (fallback path), and the degraded-vs-ckpt
    # storm pair the goodput comparison needs
    "notice-drain-long", "notice-drain-short",
    "churn-storm-degraded", "churn-storm-ckpt",
)


def reduced_matrix(dp: int = 2, pp: int = 2) -> List[Scenario]:
    """The tier-1/push subset: one scenario per distinct code path."""
    by_name = {s.name: s for s in default_matrix(dp, pp)}
    return [by_name[n] for n in REDUCED_NAMES if n in by_name]


# ------------------------------------------------------------ execution
def _inject(ctl: Controller, sc: Scenario):
    """Run the scenario's interruption(s); returns the event count —
    or, for controller_crash scenarios, an (event count, restarted
    Controller) tuple: the original controller instance is the dead
    process and the caller must continue on the restarted one."""
    if sc.kind == "controller_crash":
        victims = [_victim(ctl, r) for r in sc.params.get("victims", [])]
        events = 1 + len(victims)
        if sc.timing != "between_iter":
            step_kind, idx = MID_SWITCH_TIMINGS[sc.timing]
            try:
                if sc.timing == "mid_recovery":
                    ctl.unexpected_failure(
                        _victim(ctl, sc.params["fail"]),
                        crash=CrashPoint(step_kind, idx))
                else:
                    ctl.expected_migration(
                        [_victim(ctl, sc.params["migrate"])],
                        crash=CrashPoint(step_kind, idx))
            except ControllerCrash:
                pass
            else:
                raise AssertionError("armed CrashPoint never fired")
            events += 1          # the in-flight op the crash interrupted
        # data-plane victims land while the control plane is down: the
        # restarted controller discovers them at adoption time (their
        # in-memory replicas die with them — adoption's synthetic
        # mid-switch fault drops those before any recovery reads)
        for v in victims:
            ctl.cluster[v].fail()
        return events, ctl.restart()
    if sc.kind == "expected":
        ctl.expected_migration([_victim(ctl, sc.role)])
        return 1
    if sc.kind == "notice_drain":
        drain = sc.params.get("drain")
        if drain:
            # rack drain: one machine at a time under the same notice
            for role in drain:
                ctl.preemption_notice(_victim(ctl, role),
                                      notice_s=sc.params["notice_s"])
            return len(drain)
        ctl.preemption_notice(_victim(ctl, sc.role),
                              notice_s=sc.params.get("notice_s"))
        return 1
    if sc.kind == "churn_storm":
        cfg_shape = sc.params
        trace = generate_churn_trace(
            cfg_shape.get("storm_seed", 1305),
            dp=ctl.engine.dp, pp=ctl.engine.pp,
            max_events=cfg_shape.get("max_events", 12))
        if sc.recovery == "degraded":
            ctl.elastic_pool = False
            ctl.degraded_mode = True
        n = drive_churn_trace(ctl, trace,
                              baseline=cfg_shape.get("baseline", False),
                              max_step=cfg_shape.get("max_step"))
        return max(n, 1)
    if sc.kind == "straggler":
        ramp = sc.params.get("ramp")
        if ramp:
            # gradual degradation: the factor ramps over committed
            # iterations; only the final value crosses the migrate
            # threshold
            mid = _victim(ctl, sc.role)
            for f in ramp[:-1]:
                ctl.cluster[mid].straggle_factor = f
                ctl.engine.train_iteration()
                ctl._tick_checkpoints()
            ctl.handle_straggler(slowdown=ramp[-1], victim=mid)
            return 1
        ctl.handle_straggler(slowdown=sc.params.get("slowdown", 1.3),
                             victim=_victim(ctl, sc.role))
        return 1
    if sc.kind == "rebalance":
        ctl.rebalance(sc.params["n"])
        return 1
    if sc.kind == "standby_loss":
        ctl.standby_failure()
        return 1
    if sc.kind == "gpu_degrade":
        policy = sc.params.get(
            "policy", "reshard" if sc.recovery == "reshard" else "migrate")
        inject = None
        victims: List[int] = []
        if sc.timing in MID_SWITCH_TIMINGS:
            # a machine failure lands inside the recovery run itself
            # (e.g. inside a re-shard's own switch steps)
            step_kind, idx = MID_SWITCH_TIMINGS[sc.timing]
            victims = [_victim(ctl, r) for r in sc.params["victims"]]
            inject = FaultPoint(step_kind, idx, victims)
        mid = _victim(ctl, sc.role)
        if "lose_fraction" in sc.params:
            # shape-independent loss: the count derives from the
            # victim's actual device count, so the surviving fraction
            # is the same at any machine shape
            lose = max(1, round(ctl.cluster[mid].gpus
                                * sc.params["lose_fraction"]))
        else:
            lose = sc.params.get("lose_gpus", 1)
        ctl.gpu_fault(mid, policy=policy, lose=lose, inject=inject)
        return 1 + len(victims)
    assert sc.kind == "failure", sc.kind
    if sc.timing in ("pre_reduce", "post_reduce"):
        ctl.interrupt_iteration(_victim(ctl, sc.role), sc.timing)
        return 1
    if sc.timing in MID_SWITCH_TIMINGS:
        # the fault lands inside the migration state machine: arm a
        # FaultPoint at the matching journal step of an expected
        # migration and let the run abort / roll back / resume. The
        # victim set may name the in-flight migration's own joiner or
        # leaver, or a standby, via special tokens.
        step_kind, idx = MID_SWITCH_TIMINGS[sc.timing]
        leaver = _victim(ctl, sc.params["migrate"])
        roles = sc.params.get("victims", [sc.role])
        joiners = ctl._alloc_joiners(1) if "joiner" in roles else None
        special = {"leaver": lambda: leaver,
                   "joiner": lambda: joiners[0],
                   "standby": lambda: ctl.standbys[-1]}
        victims = [special[r]() if r in special else _victim(ctl, r)
                   for r in roles]
        ctl.expected_migration([leaver], joiners=joiners,
                               inject=FaultPoint(step_kind, idx, victims))
        return 1 + len(victims)
    if sc.timing == "during_migration":
        fail_mid = _victim(ctl, sc.role)
        ctl.expected_migration(
            [_victim(ctl, sc.params["migrate"])],
            on_prepared=lambda c: c.unexpected_failure(fail_mid))
        return 2
    if sc.timing == "cascade":
        for role in sc.params["victims"]:
            ctl.unexpected_failure(_victim(ctl, role))
        return len(sc.params["victims"])
    if sc.recovery == "full_reinit":
        ctl.checkpoint_restart(_victim(ctl, sc.role))
        return 1
    ctl.unexpected_failure(_victim(ctl, sc.role),
                           use_standby=sc.params.get("use_standby", True))
    return 1


def run_scenario(sc: Scenario, cfg: CampaignCfg,
                 reference: Dict[int, float],
                 cost: CostModel = DEFAULT) -> ScenarioResult:
    standby = sc.params.get("standby_count", cfg.standby_count)
    ctl = build_controller(cfg, standby, cost,
                           sc.params.get("per_iteration_ckpt", True))
    eng = ctl.engine
    losses: Dict[int, float] = {0: eng.losses[0]}   # pre-record step
    warm_t0 = ctl.clock.lane_total("train")
    warm_s0 = eng.step_count
    _train_to(ctl, 1 + cfg.warmup_iters, losses)
    # undisturbed per-iteration train time, measured over the warmup
    # window — the "ideal" the goodput ratios are computed against
    ideal_iter = (ctl.clock.lane_total("train") - warm_t0) \
        / max(eng.step_count - warm_s0, 1)
    if sc.params.get("save_storage"):
        ctl.save_to_storage()

    lanes0 = {ln: ctl.clock.lane_total(ln) for ln in LANES}
    nrep0, nloss0, step0 = len(ctl.reports), len(eng.losses), eng.step_count
    out = _inject(ctl, sc)
    if isinstance(out, tuple):
        # controller_crash: the injection killed the controller and
        # handed back its journal-restarted successor — everything
        # below (and the post-injection training) runs on it. Reports
        # of runs adopted across the crash live on the new instance.
        events, ctl = out
        reps = list(ctl.reports)
    else:
        events = out
        reps = ctl.reports[nrep0:]
    # iterations committed inside the injection (e.g. the straggler's
    # train-during-prep) land in the loss map too
    for i, st in enumerate(range(step0, eng.step_count)):
        losses[st] = eng.losses[nloss0 + i]
    lanes = {ln: ctl.clock.lane_total(ln) - lanes0[ln] for ln in LANES}

    _train_to(ctl, 1 + cfg.total_iters, losses)
    deltas = [abs(losses[k] - reference[k]) for k in reference
              if k in losses]
    parity = (set(losses) == set(reference)
              and bool(deltas) and max(deltas) == 0.0)
    train_total = ctl.clock.lane_total("train")
    down_total = ctl.clock.lane_total("downtime")
    over_total = ctl.clock.lane_total("overlap")
    ideal_total = ideal_iter * eng.step_count
    busy = max(train_total + down_total, 1e-12)
    # PolicyEngine consultations are journaled; the last decision is
    # the scenario's policy choice (crash scenarios read the adopted
    # controller's journal — the record survives the handover)
    pol_recs = ctl.journal.replay().get("policies", [])
    pol_choice = pol_recs[-1]["chosen"] if pol_recs else ""
    pol_feasible = [c["policy"] for c in pol_recs[-1]["ranking"]
                    if c["feasible"]] if pol_recs else []
    return ScenarioResult(
        name=sc.name, kind=sc.kind, role=sc.role, timing=sc.timing,
        recovery=sc.recovery, events=events,
        downtime_s=lanes["downtime"],
        downtime_per_event_s=lanes["downtime"] / max(events, 1),
        overlap_s=lanes["overlap"], train_s=lanes["train"],
        migrated_bytes=sum(r.state_bytes for r in reps),
        delta_fraction=max((r.delta_fraction for r in reps), default=0.0),
        lost_iterations=sum(r.lost_iterations for r in reps),
        recovery_path="+".join(sorted({r.state_path for r in reps
                                       if r.state_path})),
        loss_max_delta=max(deltas, default=float("inf")),
        loss_parity=parity, steps=eng.step_count, seed=ctl.seed,
        resumes=sum(r.resumes for r in reps),
        victims=len(sc.params.get("victims", [])),
        ckpt_fallbacks=sum(r.ckpt_fallbacks for r in reps),
        notice_s=float(sc.params.get("notice_s", 0.0)),
        degraded_events=sum(1 for r in reps if r.kind == "dp_shrink"),
        regrow_events=sum(1 for r in reps if r.kind == "dp_regrow"),
        ettr=train_total / busy,
        sched_goodput=(train_total + over_total)
        / max(train_total + over_total + down_total, 1e-12),
        runtime_goodput=ideal_total / max(train_total, 1e-12),
        recovery_goodput=ideal_total / busy,
        policy=str(sc.params.get("policy", "")),
        policy_choice=pol_choice, policy_feasible=pol_feasible)


def reference_run(cfg: CampaignCfg,
                  cost: CostModel = DEFAULT) -> Dict[int, float]:
    """The uninterrupted run every scenario is compared against."""
    ctl = build_controller(cfg, standby_count=0, cost=cost)
    losses: Dict[int, float] = {0: ctl.engine.losses[0]}
    _train_to(ctl, 1 + cfg.total_iters, losses)
    return losses


def policy_axis_scenarios(scenarios: List[Scenario]) -> List[Scenario]:
    """The decision scenarios the policy axis replays: GPU-granular
    faults at an iteration boundary — the one matrix slice where
    migrate / reshard are BOTH mechanically executable, so a fixed
    policy is a fair counterfactual to measure `auto` against."""
    return [sc for sc in scenarios
            if sc.kind == "gpu_degrade" and sc.timing == "between_iter"]


def run_policy_axis(scenarios: List[Scenario], cfg: CampaignCfg,
                    reference: Dict[int, float],
                    cost: CostModel = DEFAULT) -> List[dict]:
    """Regret accounting for the PolicyEngine: every eligible decision
    scenario runs under `auto` first, then under each fixed policy the
    auto run's journaled decision ranked feasible — identical seed,
    identical injection, only the dispatch differs. Regret is auto's
    measured downtime minus the best fixed policy's; because `auto`
    dispatches into the exact recovery path it ranked first (and the
    decision journaling charges the overlap lane, never downtime), a
    correct ranking makes the regret exactly 0.0, not merely small."""
    rows: List[dict] = []
    for sc in policy_axis_scenarios(scenarios):
        auto_sc = dataclasses.replace(
            sc, name=f"{sc.name}::auto",
            params={**sc.params, "policy": "auto"})
        auto_res = run_scenario(auto_sc, cfg, reference, cost)
        fixed: Dict[str, ScenarioResult] = {}
        for pol in auto_res.policy_feasible:
            fixed_sc = dataclasses.replace(
                sc, name=f"{sc.name}::{pol}",
                params={**sc.params, "policy": pol})
            fixed[pol] = run_scenario(fixed_sc, cfg, reference, cost)
        best = min(fixed, key=lambda p: fixed[p].downtime_s)
        regret = auto_res.downtime_s - fixed[best].downtime_s
        rows.append({
            "scenario": sc.name,
            "auto_choice": auto_res.policy_choice,
            "feasible": list(auto_res.policy_feasible),
            "downtime_s": {
                "auto": auto_res.downtime_s,
                **{p: r.downtime_s for p, r in fixed.items()}},
            "recovery_goodput": {
                "auto": auto_res.recovery_goodput,
                **{p: r.recovery_goodput for p, r in fixed.items()}},
            "best_fixed": best,
            "policy_regret_s": regret,
            "auto_never_worse": regret <= 0.0,
            "loss_parity": auto_res.loss_parity
            and all(r.loss_parity for r in fixed.values()),
        })
    return rows


def run_campaign(scenarios: Optional[List[Scenario]] = None,
                 cfg: Optional[CampaignCfg] = None,
                 cost: CostModel = DEFAULT,
                 policy_axis: bool = True) -> dict:
    """Execute the matrix and assemble the campaign payload (config,
    scenarios, policy axis, summary)."""
    cfg = cfg or CampaignCfg()
    scenarios = scenarios if scenarios is not None \
        else default_matrix(cfg.dp, cfg.pp)
    reference = reference_run(cfg, cost)
    results = [run_scenario(sc, cfg, reference, cost) for sc in scenarios]
    axis = run_policy_axis(scenarios, cfg, reference, cost) \
        if policy_axis else None
    return {
        "config": dataclasses.asdict(cfg),
        "scenarios": [r.to_dict() for r in results],
        "policy_axis": axis,
        "summary": summarize(results, axis),
    }


def summarize(results: List[ScenarioResult],
              policy_axis: Optional[List[dict]] = None) -> dict:
    """The paper's constant-downtime claim, computed over the matrix:
    standby-recovery downtime is flat across roles/timings (max within
    1.5x of the median) while the full-reinit baseline exceeds it —
    and the claim covers faults landing *inside* the switching
    machinery (mid-switch timings, GPU-granular faults, K-victim sets
    up to 5 concurrent failures, intra-machine re-shards), whose
    per-event downtime must stay within the same 1.5x envelope of the
    standby median. Scenarios that overflowed the standby pool into
    the checkpoint-restart baseline are exempt from the envelope but
    reported by name, and the re-shard-vs-migrate comparison for
    GPU-granular faults is broken out."""
    # churn-storm kinds stay out of the flat-downtime envelope: a
    # notice drain is deliberately BELOW it (that asymmetry is its own
    # claim below) and a storm aggregates many heterogeneous events
    churn_kinds = ("notice_drain", "churn_storm")
    standby = [r.downtime_per_event_s for r in results
               if r.recovery == "standby" and r.ckpt_fallbacks == 0
               and r.kind not in churn_kinds]
    reinit = [r.downtime_per_event_s for r in results
              if r.recovery == "full_reinit"]
    mid = [r.downtime_per_event_s for r in results
           if (r.timing in MID_SWITCH_TIMINGS or r.kind == "gpu_degrade")
           and r.kind != "controller_crash"
           and r.ckpt_fallbacks == 0
           and r.recovery not in ("ckpt_restart", "full_reinit")]
    crash = [r.downtime_per_event_s for r in results
             if r.kind == "controller_crash"]
    overflow = [r.name for r in results if r.ckpt_fallbacks > 0]
    # the policy comparison contrasts re-shard vs migrate under
    # identical conditions, so mid-switch-fault re-shard scenarios
    # (whose per-event downtime includes a victim recovery) stay out
    # of it — they are covered by the mid-switch envelope above
    reshard = [r.downtime_per_event_s for r in results
               if r.kind == "gpu_degrade" and r.recovery == "reshard"
               and r.timing == "between_iter"]
    gpu_migrate = [r.downtime_per_event_s for r in results
                   if r.kind == "gpu_degrade"
                   and r.recovery == "migration"
                   and r.timing == "between_iter"]
    # advance-notice drains: windows at least as long as prepare +
    # warmup must land the switchover at a fraction of the no-notice
    # standby median (expired/short notices fall back and are exempt)
    long_notice = [r.downtime_per_event_s for r in results
                   if r.kind == "notice_drain" and r.notice_s >= 5.0]
    # degraded-mode continuation vs checkpoint-restart under the SAME
    # churn trace: the shrink path must win on recovery goodput
    deg = [r.recovery_goodput for r in results
           if r.kind == "churn_storm" and r.recovery == "degraded"]
    ck = [r.recovery_goodput for r in results
          if r.kind == "churn_storm" and r.recovery == "ckpt_restart"]
    churn_parity = [r.loss_parity for r in results
                    if r.kind in churn_kinds]
    med = median(standby) if standby else 0.0
    flat_within = max(standby, default=0.0) / max(med, 1e-12)
    notice_ratio = max(long_notice, default=0.0) / max(med, 1e-12)
    reinit_over = (min(reinit) / max(med, 1e-12)) if reinit else 0.0
    mid_over = max(mid, default=0.0) / max(med, 1e-12)
    mid_ok = not mid or mid_over <= 1.5
    crash_over = max(crash, default=0.0) / max(med, 1e-12)
    crash_ok = not crash or crash_over <= 1.5
    return {
        "n_scenarios": len(results),
        "standby_downtime_median_s": med,
        "standby_downtime_max_s": max(standby, default=0.0),
        "standby_flat_within": flat_within,
        "full_reinit_downtime_min_s": min(reinit, default=0.0),
        "full_reinit_over_median": reinit_over,
        "mid_switch_max_over_median": mid_over,
        "mid_switch_claim_ok": mid_ok,
        "n_victim_set_scenarios": sum(1 for r in results
                                      if r.victims >= 2),
        "max_victim_set_k": max((r.victims for r in results), default=0),
        "overflow_fallback_scenarios": sorted(overflow),
        "reshard_downtime_max_s": max(reshard, default=0.0),
        "gpu_migrate_downtime_max_s": max(gpu_migrate, default=0.0),
        "reshard_vs_migrate": (max(reshard) / max(gpu_migrate)
                               if reshard and gpu_migrate else 0.0),
        # control-plane crashes: restart + journal replay + worker
        # re-registration + run adoption must stay inside the same
        # per-event envelope as the data-plane recoveries
        "controller_crash_downtime_max_s": max(crash, default=0.0),
        "controller_crash_max_over_median": crash_over,
        "controller_crash_claim_ok": crash_ok,
        # churn-storm goodput claims (BENCH_goodput feeds on these):
        # (a) long-notice drains at <= 0.25x the no-notice standby
        # median, (b) degraded-mode beats checkpoint-restart on
        # recovery goodput under the same trace, (c) every churn
        # scenario re-grows to full DP degree at bitwise parity
        "notice_drain_downtime_max_s": max(long_notice, default=0.0),
        "notice_drain_over_median": notice_ratio,
        "notice_claim_ok": not long_notice or notice_ratio <= 0.25,
        "degraded_recovery_goodput_min": min(deg, default=0.0),
        "ckpt_recovery_goodput_max": max(ck, default=0.0),
        "degraded_beats_ckpt": (min(deg) > max(ck)) if deg and ck
        else None,
        "churn_parity_ok": all(churn_parity) if churn_parity else None,
        "all_loss_parity": all(r.loss_parity for r in results),
        "flat_claim_ok": bool(standby) and flat_within <= 1.5
        and (not reinit or reinit_over > 1.5) and mid_ok and crash_ok,
        # PolicyEngine regret accounting (run_policy_axis): auto's
        # measured downtime vs the best fixed policy per decision
        # scenario. Exactly 0.0 when the engine's ranking is right —
        # auto dispatches into the identical recovery path, and the
        # decision journaling never charges the downtime lane. None
        # when the campaign ran without the axis.
        "policy_regret_max_s": max(
            (r["policy_regret_s"] for r in policy_axis), default=0.0)
        if policy_axis is not None else None,
        "auto_never_worse_ok": all(
            r["auto_never_worse"] and r["loss_parity"]
            for r in policy_axis)
        if policy_axis is not None else None,
    }


# --------------------------------------------------------------- output
def to_markdown(payload: dict) -> str:
    """Render the campaign as the paper-shaped downtime table."""
    cols = ("name", "kind", "role", "timing", "recovery", "events",
            "downtime_per_event_s", "lost_iterations", "resumes",
            "ckpt_fallbacks", "loss_parity")
    heads = ("scenario", "kind", "role", "timing", "recovery", "events",
             "downtime/event (s)", "lost iters", "resumes", "ckpt fb",
             "parity")
    lines = ["# Interruption-scenario downtime campaign", "",
             "| " + " | ".join(heads) + " |",
             "|" + "|".join("---" for _ in heads) + "|"]
    for r in payload["scenarios"]:
        cells = []
        for c in cols:
            v = r[c]
            cells.append(f"{v:.3f}" if isinstance(v, float) else str(v))
        lines.append("| " + " | ".join(cells) + " |")
    s = payload["summary"]
    lines += [
        "",
        f"- scenarios: **{s['n_scenarios']}**",
        f"- standby-recovery downtime median: "
        f"**{s['standby_downtime_median_s']:.3f} s** "
        f"(max {s['standby_downtime_max_s']:.3f} s, "
        f"{s['standby_flat_within']:.2f}x median — flat)",
        f"- full-reinit baseline minimum: "
        f"**{s['full_reinit_downtime_min_s']:.3f} s** "
        f"({s['full_reinit_over_median']:.1f}x the standby median)",
        f"- mid-switch / GPU-granular / victim-set faults (K up to "
        f"{s['max_victim_set_k']}, {s['n_victim_set_scenarios']} "
        f"victim-set scenarios): max "
        f"**{s['mid_switch_max_over_median']:.2f}x** the standby "
        f"median (claim holds: {s['mid_switch_claim_ok']})",
        f"- GPU-granular re-shard vs migrate downtime: "
        f"**{s['reshard_downtime_max_s']:.3f} s** vs "
        f"**{s['gpu_migrate_downtime_max_s']:.3f} s** "
        f"({s['reshard_vs_migrate']:.2f}x)",
        f"- controller-crash restarts (journal replay + worker "
        f"re-registration + run adoption): max "
        f"**{s['controller_crash_downtime_max_s']:.3f} s**/event "
        f"({s['controller_crash_max_over_median']:.2f}x the standby "
        f"median; claim holds: {s['controller_crash_claim_ok']})",
        f"- standby-overflow -> checkpoint-restart fallbacks (exempt "
        f"from the envelope): {s['overflow_fallback_scenarios'] or None}",
        f"- advance-notice drains: max "
        f"**{s['notice_drain_downtime_max_s']:.3f} s**/event "
        f"({s['notice_drain_over_median']:.2f}x the no-notice standby "
        f"median; <= 0.25x claim holds: {s['notice_claim_ok']})",
        f"- degraded-mode vs checkpoint-restart recovery goodput under "
        f"the same churn trace: "
        f"**{s['degraded_recovery_goodput_min']:.3f}** vs "
        f"**{s['ckpt_recovery_goodput_max']:.3f}** "
        f"(shrink wins: {s['degraded_beats_ckpt']})",
        f"- churn scenarios re-grown to full DP at bitwise parity: "
        f"**{s['churn_parity_ok']}**",
        f"- bitwise loss parity on every scenario: "
        f"**{s['all_loss_parity']}**",
        f"- constant-downtime claim holds: **{s['flat_claim_ok']}**",
    ]
    axis = payload.get("policy_axis")
    if axis:
        lines += [
            "", "## Policy axis (auto vs fixed policies)", "",
            "Each decision scenario replayed under `auto` plus every "
            "fixed policy the journaled decision ranked feasible "
            "(identical seed and injection). Regret = auto downtime "
            "minus the best fixed policy's — exactly 0.0 when the "
            "PolicyEngine ranks right.", "",
            "| scenario | auto chose | downtime by policy (s) | "
            "best fixed | regret (s) | parity |",
            "|---|---|---|---|---|---|"]
        for r in axis:
            dts = ", ".join(f"{p}={v:.3f}"
                            for p, v in sorted(r["downtime_s"].items()))
            lines.append(
                f"| {r['scenario']} | {r['auto_choice']} | {dts} | "
                f"{r['best_fixed']} | {r['policy_regret_s']:.6f} | "
                f"{r['loss_parity']} |")
        lines += [
            "",
            f"- max policy regret: **{s['policy_regret_max_s']:.6f} s**",
            f"- auto never worse than the best fixed policy: "
            f"**{s['auto_never_worse_ok']}**",
        ]
    return "\n".join(lines) + "\n"


def write_outputs(payload: dict, json_path: str,
                  md_path: Optional[str] = None) -> None:
    with open(json_path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    if md_path:
        with open(md_path, "w") as f:
            f.write(to_markdown(payload))
