"""The port's PipelineEngine against the JAX engine: same weights, same
grid, same data. Losses agree within tolerance; SimClock phases, comm
op counts, tape keys and state byte sizes are identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fast_jax_engine import fast_jax_engine
from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs.gpt import tiny_gpt as jtiny_gpt
from repro.core.engine import IterationInterrupt as JIterationInterrupt
from repro.core.engine import PipelineEngine as JEngine
from repro.core.sandbox import CommHooks as JCommHooks
from repro.models import backbone as jbackbone
from repro.train.checkpoint import tree_bytes as jtree_bytes
from repro_torch.cluster.node import Cluster, NodeStatus, Role
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import IterationInterrupt, PipelineEngine
from repro_torch.core.sandbox import CommHooks
from repro_torch.train.checkpoint import tree_bytes
from repro_torch.tree import tree_flatten

# the campaign's tiny GPT and grid (core/campaign.py CampaignCfg)
LAYERS, D, HEADS, VOCAB = 4, 64, 4, 256
DP, PP, BATCH, SEQ, ITERS = 2, 2, 8, 32, 3
LOSS_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_port(full_np, flat=True):
    clock = SimClock()
    comm = CommHooks(clock)
    eng = PipelineEngine(tiny_gpt(LAYERS, D, HEADS, VOCAB), DP, PP, BATCH,
                         SEQ, Cluster(DP * PP + 2), clock, comm,
                         use_flat_buffers=flat, sim_compile_seconds=1.0,
                         device="cpu")
    eng.setup(list(range(DP * PP)), full_params=params_from_numpy(
        full_np, "cpu"))
    tape = eng.record_iteration()
    for _ in range(ITERS):
        eng.train_iteration()
    return eng, clock, comm, tape


@pytest.fixture(scope="module")
def runs():
    jcfg = jtiny_gpt(LAYERS, D, HEADS, VOCAB)
    clock = JSimClock()
    comm = JCommHooks(clock)
    jeng = JEngine(jcfg, DP, PP, BATCH, SEQ, JCluster(DP * PP + 2), clock,
                   comm, sim_compile_seconds=1.0)
    jeng.setup(list(range(DP * PP)))
    jtape = jeng.record_iteration()
    for _ in range(ITERS):
        jeng.train_iteration()
    # the JAX engine's own initial weights, as numpy
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.float32))
    return (jeng, clock, comm, jtape), _run_port(full_np), full_np


def test_losses_match_jax(runs):
    (jeng, *_), (eng, *_), _ = runs
    assert len(eng.losses) == len(jeng.losses) == ITERS + 1
    np.testing.assert_allclose(eng.losses, jeng.losses, rtol=LOSS_TOL,
                               atol=LOSS_TOL)


def test_clock_and_comm_ledgers_identical(runs):
    (jeng, jclock, jcomm, _), (eng, clock, comm, _), _ = runs
    phases = lambda c: [(p.name, p.lane, p.duration) for p in c.phases]
    assert phases(clock) == phases(jclock)
    assert clock.lane_total("train") == jclock.lane_total("train")
    assert comm.op_counts == jcomm.op_counts
    assert (comm.record_bytes, comm.replay_bytes) == \
        (jcomm.record_bytes, jcomm.replay_bytes)


def test_tape_and_state_sizes_identical(runs):
    (jeng, _, _, jtape), (eng, _, _, tape), _ = runs
    assert set(tape.entries) == set(jtape.entries)
    assert tape.meta == jtape.meta
    assert {k: v.nbytes for k, v in tape.entries.items()} == \
        {k: v.nbytes for k, v in jtape.entries.items()}
    for s in range(PP):
        assert eng.state_spec(s).nbytes == jeng.state_spec(s).nbytes
    for mid in eng.grid.values():
        assert eng.get_state_flat(mid)[0].nbytes == \
            jeng.get_state_flat(mid)[0].nbytes
        assert eng.state_bytes(mid) == jeng.state_bytes(mid)
        assert eng.cluster[mid].device.peak == jeng.cluster[mid].device.peak
    assert eng.epoch_signature() == jeng.epoch_signature()


@pytest.fixture(scope="module")
def per_leaf(runs):
    return _run_port(runs[2], flat=False)[0]


def test_flat_and_per_leaf_losses_bitwise_equal(runs, per_leaf):
    _, (eng, *_), _ = runs
    assert per_leaf.losses == eng.losses


def test_opt_state_tree_equal_on_flat_and_per_leaf_paths(runs, per_leaf):
    _, (eng, *_), _ = runs
    for s in range(PP):
        fa, fd = tree_flatten(eng.opt_state_tree(0, s))
        la, ld = tree_flatten(per_leaf.opt_state_tree(0, s))
        assert fd == ld
        assert all(torch.equal(x, y) for x, y in zip(fa, la))


def test_state_round_trip_keeps_training_bitwise(runs):
    _, _, full_np = runs
    a, *_ = _run_port(full_np)
    b, *_ = _run_port(full_np)
    for mid in list(b.grid.values()):         # ship every rank's state
        _, s = b.coords_of(mid)
        buf, step = b.get_state_flat(mid)
        b.set_state_flat(mid, s, buf, step)
    assert b.reshard_machine(b.grid[(0, 0)]) == b.state_spec(0).nbytes
    assert a.train_iteration() == b.train_iteration()
    for mid in a.grid.values():
        for x, y in zip(tree_flatten(a.get_state(mid))[0],
                        tree_flatten(b.get_state(mid))[0]):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_swap_machine_hands_a_rank_to_a_joiner(runs):
    _, _, full_np = runs
    a, *_ = _run_port(full_np)
    b, *_ = _run_port(full_np)
    leaver, joiner = b.grid[(0, PP - 1)], DP * PP
    buf, step = b.get_state_flat(leaver)
    b.set_state_flat(joiner, PP - 1, buf, step)
    b.swap_machine(leaver, joiner)
    assert b.grid[(0, PP - 1)] == joiner
    assert b.coords_of(joiner) == (0, PP - 1)
    with pytest.raises(KeyError):
        b.coords_of(leaver)
    assert b.cluster[joiner].role == Role(0, PP - 1, PP)
    assert b.cluster[leaver].role is None
    assert b.cluster[leaver].status == NodeStatus.IDLE
    assert a.train_iteration() == b.train_iteration()


def _drive_paths(eng, interrupt_cls, tree_bytes) -> dict:
    """The three engine paths the Controller's recoveries build on, in
    turn, on an engine after record + ITERS iterations: two sandboxed
    shadow iterations on a spare, then an iteration; an interrupt armed
    at post_reduce, then the iteration again; dp_retire(1), an
    iteration hosted by the surviving chain, dp_restaff, an iteration.
    Per step: the clock phases it added, the lanes, the comm counters,
    the step counters and the loss."""
    clock, comm, out = eng.clock, eng.comm, {}
    mark = len(clock.phases)

    def note(name, loss=None, **extra):
        nonlocal mark
        out[name] = {
            "loss": loss,
            "phases": [(p.name, p.start, p.duration, p.lane)
                       for p in clock.phases[mark:]],
            "lanes": {ln: clock.lane_total(ln)
                      for ln in ("train", "downtime", "overlap")},
            "comm": (dict(comm.op_counts), comm.record_bytes,
                     comm.replay_bytes, clock.comm_exposed,
                     clock.comm_hidden, clock.pending_async()),
            "steps": (eng.step_count, sorted(
                (mid, int(eng.cluster[mid].payload["step"]))
                for mid in eng.grid.values())),
            **extra}
        mark = len(clock.phases)

    spare = eng.cluster[DP * PP]
    cached = []
    for stage, role_type in ((0, "first"), (PP - 1, "last")):
        role = eng.shadow_iteration(spare, role_type, stage)
        # the role the standby caches is the one the iteration built
        cached.append(spare.warm_roles[role_type] is role)
    note("shadow", warm=sorted(spare.warm_roles), cached=cached,
         sandbox_bytes=tree_bytes(spare.payload["sandbox_state"]))
    note("after_shadow", eng.train_iteration())
    eng.arm_interrupt("post_reduce", victim=eng.grid[(1, 0)])
    with pytest.raises(interrupt_cls) as ei:
        eng.train_iteration()
    note("post_reduce", phase=ei.value.phase, dirty=ei.value.dirty,
         victim=ei.value.victim)
    note("after_post_reduce", eng.train_iteration())
    gone = eng.dp_retire(1)
    note("dp_retire", gone=gone, hosted=sorted(eng.hosted.items()),
         mids=[eng.machine(d, s).mid for d in range(DP)
               for s in range(PP)])
    note("hosted", eng.train_iteration())
    eng.dp_restaff(1, {s: gone[s] for s in range(PP)})
    note("restaffed", eng.train_iteration(), hosted=sorted(eng.hosted))
    return out


@pytest.fixture(scope="module")
def paths(runs):
    _, _, full_np = runs
    clock = JSimClock()
    jeng = JEngine(jtiny_gpt(LAYERS, D, HEADS, VOCAB), DP, PP, BATCH, SEQ,
                   JCluster(DP * PP + 2), clock, JCommHooks(clock),
                   sim_compile_seconds=1.0)
    with fast_jax_engine():
        jeng.setup(list(range(DP * PP)))
        jeng.record_iteration()
        for _ in range(ITERS):
            jeng.train_iteration()
        ref = _drive_paths(jeng, JIterationInterrupt, jtree_bytes)
    eng, *_ = _run_port(full_np)
    port = _drive_paths(eng, IterationInterrupt, tree_bytes)
    still, *_ = _run_port(full_np)
    return ref, port, still.train_iteration()


def test_shadow_iteration_replays_from_the_tape(paths):
    """Two sandboxed shadow iterations on a spare: the overlap charge,
    the replayed bytes and the roles warmed are the JAX engine's, and
    the job trains on as if they never ran."""
    ref, port, still_loss = paths
    for step in ("shadow", "after_shadow"):
        assert port[step]["phases"] == ref[step]["phases"]
        assert port[step]["lanes"] == ref[step]["lanes"]
        assert port[step]["comm"] == ref[step]["comm"]
    assert port["shadow"]["warm"] == ref["shadow"]["warm"] == \
        ["first", "last"]
    assert port["shadow"]["cached"] == ref["shadow"]["cached"] == \
        [True, True]
    assert port["shadow"]["sandbox_bytes"] == ref["shadow"]["sandbox_bytes"]
    assert port["shadow"]["comm"][2] > 0          # replayed from the tape
    assert port["after_shadow"]["loss"] == still_loss
    assert abs(port["after_shadow"]["loss"] - ref["after_shadow"]["loss"]) \
        <= LOSS_TOL


def test_armed_interrupt_commits_nothing(runs):
    _, _, full_np = runs
    eng, *_ = _run_port(full_np)
    step = eng.step_count
    eng.arm_interrupt("pre_reduce", victim=eng.grid[(1, 0)])
    with pytest.raises(IterationInterrupt) as ei:
        eng.train_iteration()
    assert ei.value.phase == "pre_reduce" and not ei.value.dirty
    assert eng.step_count == step
    eng.train_iteration()                      # one-shot: runs on
    assert eng.step_count == step + 1


def test_post_reduce_interrupt_matches_reference(paths):
    """An interrupt armed at post_reduce fires dirty (payloads already
    updated, the step counter not advanced), as in the JAX engine, with
    the same ledgers; the iteration run again agrees with the JAX
    engine's."""
    ref, port, _ = paths
    assert port["post_reduce"]["dirty"] is True
    for step in ("post_reduce", "after_post_reduce"):
        for part in ("phases", "lanes", "comm", "steps"):
            assert port[step][part] == ref[step][part], (step, part)
    for key in ("phase", "dirty", "victim"):
        assert port["post_reduce"][key] == ref["post_reduce"][key]
    assert abs(port["after_post_reduce"]["loss"]
               - ref["after_post_reduce"]["loss"]) <= LOSS_TOL


def test_dp_retire_and_restaff(paths):
    """The iteration hosted by the surviving chain after dp_retire(1),
    and the one after dp_restaff, against the JAX engine: losses within
    LOSS_TOL, clock phases, comm counters and hosting identical."""
    ref, port, _ = paths
    for step in ("dp_retire", "hosted", "restaffed"):
        for part in ("phases", "lanes", "comm", "steps"):
            assert port[step][part] == ref[step][part], (step, part)
    for key in ("gone", "hosted", "mids"):
        assert port["dp_retire"][key] == ref["dp_retire"][key]
    assert port["restaffed"]["hosted"] == ref["restaffed"]["hosted"] == []
    for step in ("hosted", "restaffed"):
        assert abs(port[step]["loss"] - ref[step]["loss"]) <= LOSS_TOL
