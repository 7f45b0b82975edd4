"""The port's Controller against the JAX Controller: one script of
interruptions (the quickstart's expected migration and unexpected
failure, then an unexpected failure without a standby, a
checkpoint-restart, a re-shard recovery, a DP shrink and re-grow, a
controller crash adopted by restart(), a preemption notice, iterations
interrupted at post_reduce and pre_reduce, the loss of the standby, a
re-grow by maybe_regrow, a GPU fault whose recovery the PolicyEngine
picks, a rebalance and a straggler) runs on both from the same weights,
each event followed by one training iteration.

For every event: the port's losses are within LOSS_TOL of the
reference's; the interrupted port run is bitwise equal to an unbroken
port run; the SimClock phases and lanes, the comm counters, the
ControlJournal, the device ledgers and the MigrationReport fields are
identical to the reference's, with no tolerance."""
import dataclasses
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_jax_engine import fast_jax_engine
from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs.gpt import tiny_gpt as jtiny_gpt
from repro.core.controller import Controller as JController
from repro.core import metrics as jmetrics
from repro.core.engine import PipelineEngine as JEngine
from repro.core.migration import ControllerCrash as JControllerCrash
from repro.core.migration import CrashPoint as JCrashPoint
from repro.core.sandbox import CommHooks as JCommHooks
from repro.models import backbone as jbackbone
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.convert import params_from_numpy
from repro_torch.core.controller import Controller
from repro_torch.core import metrics
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.migration import ControllerCrash, CrashPoint
from repro_torch.core.sandbox import CommHooks

# tests/test_system.py's tiny GPT and grid; the quickstart's cluster
LAYERS, D, HEADS, VOCAB = 4, 64, 4, 256
DP, PP, BATCH, SEQ = 2, 2, 8, 32
MACHINES = DP * PP + 2 + 1
LOSS_TOL = 1e-5


def _crash_and_restart(ctl, side):
    """The controller dies before the second group switch of an
    expected migration; a fresh one adopts the run from the journal."""
    with pytest.raises(side.ControllerCrash):
        ctl.expected_migration([ctl.engine.grid[(0, PP - 1)]],
                               crash=side.CrashPoint("switch", 1))
    new = ctl.restart()
    return new, new.reports[-1]


def _reshard(ctl, side):
    victim = ctl.engine.grid[(1, PP - 1)]
    ctl.cluster[victim].degrade_gpu(1)
    return ctl, ctl.reshard_recovery(victim)


def _checkpoint_restart(ctl, side):
    ctl.save_to_storage()
    return ctl, ctl.checkpoint_restart(ctl.engine.grid[(0, PP - 1)])


def _maybe_regrow(ctl, side):
    """The chain retired by the shrink before comes back: one report."""
    (rep,) = ctl.maybe_regrow()
    return ctl, rep


# (name, event): each event takes (controller, side) and returns the
# controller that goes on (restart() makes a new one) and its report
EVENTS = [
    ("expected_migration", lambda c, s: (c, c.expected_migration(
        [c.engine.grid[(1, 1)]]))),
    ("unexpected_failure", lambda c, s: (c, c.unexpected_failure(
        c.engine.grid[(0, 0)]))),
    ("failure_without_standby", lambda c, s: (c, c.unexpected_failure(
        c.engine.grid[(1, 0)], use_standby=False))),
    ("checkpoint_restart", _checkpoint_restart),
    ("reshard_recovery", _reshard),
    ("dp_shrink", lambda c, s: (c, c.dp_shrink(c.engine.grid[(1, 0)]))),
    ("dp_regrow", lambda c, s: (c, c.dp_regrow())),
    ("restart_after_crash", _crash_and_restart),
    ("preemption_notice", lambda c, s: (c, c.preemption_notice(
        c.engine.grid[(0, 1)]))),
    ("interrupt_post_reduce", lambda c, s: (c, c.interrupt_iteration(
        c.engine.grid[(1, 1)], "post_reduce"))),
    ("interrupt_pre_reduce", lambda c, s: (c, c.interrupt_iteration(
        c.engine.grid[(0, 0)], "pre_reduce"))),
    ("dp_shrink_before_maybe_regrow", lambda c, s: (c, c.dp_shrink(
        c.engine.grid[(0, 1)]))),
    # the shrink's freed chain-mate is the standby that fails here
    ("standby_failure", lambda c, s: (c, c.standby_failure())),
    ("maybe_regrow", _maybe_regrow),
    ("gpu_fault_auto", lambda c, s: (c, c.gpu_fault(
        c.engine.grid[(1, 0)], policy="auto"))),
    ("rebalance", lambda c, s: (c, c.rebalance(2))),
    ("handle_straggler", lambda c, s: (c, c.handle_straggler(
        1.2, c.engine.grid[(1, 1)]))),
]
NAMES = [n for n, _ in EVENTS]
QUICKSTART = NAMES[:2]
# events after which a retired DP chain is hosted by its survivor
HOSTED = {"dp_shrink", "dp_shrink_before_maybe_regrow", "standby_failure"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _controller(side):
    clock = side.SimClock()
    eng = side.PipelineEngine(
        side.cfg, dp=DP, pp=PP, global_batch=BATCH, seq_len=SEQ,
        cluster=side.Cluster(MACHINES, device_capacity=16 * 2 ** 30),
        clock=clock, comm=side.CommHooks(clock), micro_batches=2,
        sim_compile_seconds=1.0, **side.engine_kw)
    ctl = side.Controller(eng, standby_count=1)
    ctl.bootstrap_job(list(range(DP * PP)), **side.boot_kw)
    return ctl


def _ledgers(ctl, since: int) -> dict:
    """Everything the runs must agree on bit for bit; phases from index
    `since` on."""
    clock, comm, eng = ctl.clock, ctl.engine.comm, ctl.engine
    return {
        "phases": [(p.name, p.start, p.duration, p.lane, dict(p.per_node))
                   for p in clock.phases[since:]],
        "lanes": {ln: clock.lane_total(ln)
                  for ln in ("train", "downtime", "overlap")},
        "comm": (dict(comm.op_counts), comm.record_bytes,
                 comm.replay_bytes, clock.comm_exposed, clock.comm_hidden,
                 clock.comm_queued, clock.pending_async()),
        "journal": (ctl.journal.to_json(), ctl.journal.appends,
                    ctl.journal.bytes_appended),
        "topology": (sorted(eng.grid.items()), sorted(eng.hosted.items()),
                     list(ctl.standbys), eng.step_count,
                     eng.epoch_signature()),
        "machines": [(m.mid, m.status.name, m.alive, m.failed_gpus,
                      sorted(map(str, m.warm_roles)), m.device.used,
                      m.device.peak, m.host.used)
                     for m in ctl.cluster.machines.values()],
    }


def _drive(side) -> dict:
    """Bootstrap, one iteration, then each event and one iteration."""
    ctl = _controller(side)
    out = {"boot": _ledgers(ctl, 0), "events": {}}
    mark = len(ctl.clock.phases)
    losses = ctl.train(1)
    for name, event in EVENTS:
        n = len(ctl.engine.losses)
        ctl, rep = event(ctl, side)
        report = dataclasses.asdict(rep)
        # iterations the event trained itself (a migration that keeps
        # training while it prepares), then one more
        losses += ctl.engine.losses[n:] + ctl.train(1)
        out["events"][name] = {"report": report,
                               "ledgers": _ledgers(ctl, mark),
                               "losses": list(losses)}
        mark = len(ctl.clock.phases)
    out["losses"] = losses
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = jtiny_gpt(LAYERS, D, HEADS, VOCAB)
    # the JAX engine's own initial weights, as numpy
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.float32))
    jside = SimpleNamespace(
        cfg=jcfg, Cluster=JCluster, SimClock=JSimClock,
        CommHooks=JCommHooks, PipelineEngine=JEngine,
        Controller=JController, CrashPoint=JCrashPoint,
        ControllerCrash=JControllerCrash, engine_kw={}, boot_kw={})
    with fast_jax_engine():
        ref = _drive(jside)
    side = SimpleNamespace(
        cfg=tiny_gpt(LAYERS, D, HEADS, VOCAB), Cluster=Cluster,
        SimClock=SimClock, CommHooks=CommHooks,
        PipelineEngine=PipelineEngine, Controller=Controller,
        CrashPoint=CrashPoint, ControllerCrash=ControllerCrash,
        engine_kw={"device": "cpu"},
        boot_kw={"full_params": params_from_numpy(full_np, "cpu")})
    port = _drive(side)
    unbroken = _controller(side)
    port["unbroken"] = unbroken.train(len(port["losses"]))
    return ref, port


def test_bootstrap_ledgers_identical(runs):
    ref, port = runs
    assert port["boot"] == ref["boot"]


def test_whole_run_losses_within_tolerance(runs):
    ref, port = runs
    # one iteration before the events and one after each, and the one
    # handle_straggler trains while its joiner prepares
    assert len(port["losses"]) == len(ref["losses"]) == 2 + len(EVENTS)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=0,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_losses_match_the_reference(runs, name):
    ref, port = runs
    np.testing.assert_allclose(port["events"][name]["losses"],
                               ref["events"][name]["losses"], rtol=0,
                               atol=LOSS_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_interrupted_run_bitwise_equals_unbroken(runs, name):
    _, port = runs
    losses = port["events"][name]["losses"]
    assert losses == port["unbroken"][:len(losses)]


@pytest.mark.parametrize("name", NAMES)
def test_report_fields_identical(runs, name):
    ref, port = runs
    assert port["events"][name]["report"] == ref["events"][name]["report"]


@pytest.mark.parametrize("part", ["phases", "lanes", "comm", "journal",
                                  "topology", "machines"])
@pytest.mark.parametrize("name", NAMES)
def test_ledgers_identical(runs, name, part):
    ref, port = runs
    assert port["events"][name]["ledgers"][part] == \
        ref["events"][name]["ledgers"][part]


def test_quickstart_events_take_the_paths_they_promise(runs):
    """The quickstart's pair as the paper tells it: the expected
    migration's preparation overlaps training and costs no device
    memory; the failure recovers from the in-memory checkpoint through
    the general standby, losing no iteration."""
    _, port = runs
    mig, fail = (port["events"][n]["report"] for n in QUICKSTART)
    assert mig["overlap"] > 0 and mig["mem_overhead_bytes"] == 0
    assert mig["state_bytes"] > 0 and mig["downtime"] < 5.0
    assert fail["state_path"] == "neighbor"
    assert fail["lost_iterations"] == 0


@pytest.mark.parametrize("name, kind, path", [
    ("expected_migration", "expected", ""),
    ("unexpected_failure", "unexpected", "neighbor"),
    ("failure_without_standby", "unexpected", "neighbor"),
    ("checkpoint_restart", "ckpt_restart", "storage"),
    ("reshard_recovery", "gpu_reshard", "dp_peer"),
    ("dp_shrink", "dp_shrink", ""),
    ("dp_regrow", "dp_regrow", ""),
    ("restart_after_crash", "expected", ""),
    ("preemption_notice", "notice_drain", ""),
    ("interrupt_post_reduce", "unexpected@post_reduce", "neighbor"),
    ("interrupt_pre_reduce", "unexpected@pre_reduce", "neighbor"),
    ("dp_shrink_before_maybe_regrow", "dp_shrink", ""),
    ("standby_failure", "standby_loss", ""),
    ("maybe_regrow", "dp_regrow", ""),
    ("gpu_fault_auto", "gpu_reshard", "dp_peer"),
    ("rebalance", "expected", ""),
    ("handle_straggler", "expected", "")])
def test_each_event_takes_its_recovery_path(runs, name, kind, path):
    """The script reaches the path each event names (so the parity
    above covers it): the report's kind and state path, the DP chain
    hosted after the shrink and staffed again after the re-grow."""
    _, port = runs
    report = port["events"][name]["report"]
    assert (report["kind"], report["state_path"]) == (kind, path)
    hosted = port["events"][name]["ledgers"]["topology"][1]
    assert bool(hosted) == (name in HOSTED)


def test_quickstart_example_runs_on_the_cpu(capsys):
    """examples/torch_quickstart.py --small --device cpu --steps 6, in
    this process."""
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--small", "--device", "cpu", "--steps", "6"])
    out = capsys.readouterr().out.splitlines()
    assert "trajectory bitwise-identical to uninterrupted run: True" in out
    assert out[-1] == "QUICKSTART OK"


def _metric_args(run: dict) -> dict:
    """core/metrics.py's inputs from one run's ledger: the quickstart's
    two downtimes, the rebalance's, the lanes at the end."""
    ev = run["events"]
    lanes = ev[NAMES[-1]]["ledgers"]["lanes"]
    gpus = DP * PP * 8
    exp, unexp = (ev[n]["report"]["downtime"] for n in QUICKSTART)
    return {
        "events_per_week": (gpus,),
        "gpu_hours_wasted_week": (gpus, exp, unexp, 8),
        "ettr": (lanes["train"], lanes["train"] + lanes["downtime"]),
        "ettr_under_events": (gpus, unexp),
        "rebalance_ettr": (3600.0, ev["rebalance"]["report"]["downtime"]),
    }


@pytest.mark.parametrize("fn", ["events_per_week", "gpu_hours_wasted_week",
                                "ettr", "ettr_under_events",
                                "rebalance_ettr"])
def test_metrics_identical_on_the_run(runs, fn):
    """The port's evaluation metrics of its own run equal the JAX
    package's of its run, bit for bit."""
    ref, port = runs
    got = getattr(metrics, fn)(*_metric_args(port)[fn])
    want = getattr(jmetrics, fn)(*_metric_args(ref)[fn])
    if dataclasses.is_dataclass(got):
        got, want = dataclasses.astuple(got), dataclasses.astuple(want)
    assert got == want
