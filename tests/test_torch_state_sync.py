"""The port's state movement against the JAX package's: the same state
operations on two engines that hold the same weights.

`leaver_to_joiner`, `reshard_in_place`, `regrow_staff` and the three
paths of `recover_state` (neighbour in-memory checkpoint, live DP peer,
storage) run in one sequence on both. Their TransferReports, the
SimClock phases and lanes and the device ledgers are identical to the
reference's; on the port each joiner ends up with its source's state
bit for bit, and the moved grid trains on bitwise like a grid that
never moved."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from fast_jax_engine import fast_jax_engine
from repro.cluster.node import Cluster as JCluster
from repro.cluster.simclock import SimClock as JSimClock
from repro.configs.gpt import tiny_gpt as jtiny_gpt
from repro.core import state_sync as jstate_sync
from repro.core.engine import PipelineEngine as JEngine
from repro.core.sandbox import CommHooks as JCommHooks
from repro.models import backbone as jbackbone
from repro.train.checkpoint import InMemoryCheckpoint as JInMemoryCheckpoint
from repro_torch.cluster.costmodel import DEFAULT
from repro_torch.cluster.node import Cluster
from repro_torch.cluster.simclock import SimClock
from repro_torch.configs.gpt import tiny_gpt
from repro_torch.convert import params_from_numpy
from repro_torch.core import state_sync
from repro_torch.core.engine import PipelineEngine
from repro_torch.core.sandbox import CommHooks
from repro_torch.train.checkpoint import InMemoryCheckpoint
from repro_torch.tree import tree_flatten

LAYERS, D, HEADS, VOCAB = 4, 64, 4, 256
DP, PP, BATCH, SEQ = 2, 2, 8, 32
SPARES = 6
LOSS_TOL = 1e-5
OPS = ["leaver_to_joiner", "reshard_in_place", "regrow_staff",
       "recover_neighbor", "recover_dp_peer", "recover_storage",
       "recover_dp_peer_after_storage"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    several workers at once: one thread each keeps them from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(side):
    clock = side.SimClock()
    eng = side.PipelineEngine(
        side.cfg, DP, PP, BATCH, SEQ,
        side.Cluster(DP * PP + SPARES, device_capacity=16 * 2 ** 30),
        clock, side.CommHooks(clock), sim_compile_seconds=1.0,
        **side.engine_kw)
    eng.setup(list(range(DP * PP)), **side.setup_kw)
    eng.record_iteration()
    eng.train_iteration()
    return eng


class _Moves:
    """Every set_state_flat / set_state an engine receives: (mid, kind,
    bytes)."""

    def __init__(self, eng):
        self.log = []
        flat, tree = eng.set_state_flat, eng.set_state

        def set_state_flat(mid, stage, buf, step):
            self.log.append((mid, "flat", buf.nbytes))
            flat(mid, stage, buf, step)

        def set_state(mid, state):
            self.log.append((mid, "tree", None))
            tree(mid, state)

        eng.set_state_flat, eng.set_state = set_state_flat, set_state


def _drive(side) -> dict:
    """The sequence of state operations; per op its report, the clock
    phases it added, the lanes after it, the device ledgers, the live
    DP peers and (for the port) the source and joiner states."""
    eng = _engine(side)
    ss, clock, cl = side.state_sync, eng.clock, eng.cluster
    moves = _Moves(eng)
    spare = iter(range(DP * PP, DP * PP + SPARES))
    out, mark = {}, len(clock.phases)

    def note(name, rep, src_state, dst, step=None):
        nonlocal mark
        out[name] = {
            "report": dataclasses.asdict(rep), "step": step,
            "phases": [(p.name, p.start, p.duration, p.lane,
                        dict(p.per_node)) for p in clock.phases[mark:]],
            "lanes": {ln: clock.lane_total(ln)
                      for ln in ("train", "downtime", "overlap")},
            "devices": [(m.mid, m.status.name, m.alive, m.device.used,
                         m.device.peak, sorted(m.device._tags.items()))
                        for m in cl.machines.values()],
            "peers": {mid: ss.live_dp_peer(eng, mid)
                      for mid in sorted(eng.grid.values())},
            "moves": list(moves.log),
            "src": src_state, "dst": side.state_of(eng, dst)}
        moves.log.clear()
        mark = len(clock.phases)

    # expected leave: the leaver's one packed buffer to a joiner
    leaver, joiner = eng.grid[(0, 1)], next(spare)
    src = side.state_of(eng, leaver)
    rep = ss.leaver_to_joiner(eng, leaver, joiner, clock)
    eng.swap_machine(leaver, joiner)
    note("leaver_to_joiner", rep, src, joiner)

    # partial-GPU fault: re-split in place, the bytes unchanged
    mid = eng.grid[(1, 0)]
    cl[mid].degrade_gpu(1)
    src = side.state_of(eng, mid)
    note("reshard_in_place", ss.reshard_in_place(eng, mid, clock), src,
         mid)

    # re-grow staffing: a bitwise copy of the hosting replica
    host, joiner = eng.grid[(0, 0)], next(spare)
    src = side.state_of(eng, host)
    rep = ss.regrow_staff(eng, host, joiner, 0, clock)
    note("regrow_staff", rep, src, joiner)

    # unexpected failures, one per recovery path
    imc = side.InMemoryCheckpoint()
    ring = list(eng.grid.values())
    for m in ring:
        imc.put(m, eng.step_count, eng.get_state(m), ring)
    storage = {m: (eng.step_count, eng.get_state(m)) for m in ring}
    before = {c: side.state_of(eng, m) for c, m in eng.grid.items()}
    paths = [("recover_neighbor", (1, 1), imc),
             ("recover_dp_peer", (1, 0), None),
             ("recover_storage", (0, 0), None),
             ("recover_dp_peer_after_storage", (1, 0), None)]
    for name, coords, ckpt in paths:
        failed, joiner = eng.grid[coords], next(spare)
        if name == "recover_storage":     # its DP peer dies with it
            cl[eng.grid[(1, 0)]].fail()
        cl[failed].fail()
        imc.drop_node(failed)
        rep, step = ss.recover_state(eng, failed, joiner, ckpt, clock,
                                     storage_state=storage.get(failed))
        eng.swap_machine(failed, joiner)
        note(name, rep, before[coords], joiner, step)
    out["loss"] = eng.train_iteration()
    out["grid"] = sorted(eng.grid.items())
    return out


def _port_state(eng, mid):
    """A machine's params, optimizer state and step: bytes per array,
    the value of each scalar."""
    return [l if not isinstance(l, torch.Tensor)
            else l.item() if l.dim() == 0 else l.numpy().tobytes()
            for l in tree_flatten(eng.get_state(mid))[0]]


@pytest.fixture(scope="module")
def runs():
    jcfg = jtiny_gpt(LAYERS, D, HEADS, VOCAB)
    full_np = jax.tree.map(np.asarray, jbackbone.init_params(
        jcfg, jax.random.PRNGKey(0), tp=1, dtype=jnp.float32))
    jside = SimpleNamespace(
        cfg=jcfg, Cluster=JCluster, SimClock=JSimClock,
        CommHooks=JCommHooks, PipelineEngine=JEngine,
        InMemoryCheckpoint=JInMemoryCheckpoint, state_sync=jstate_sync,
        engine_kw={}, setup_kw={}, state_of=lambda eng, mid: None)
    with fast_jax_engine():
        ref = _drive(jside)
    side = SimpleNamespace(
        cfg=tiny_gpt(LAYERS, D, HEADS, VOCAB), Cluster=Cluster,
        SimClock=SimClock, CommHooks=CommHooks,
        PipelineEngine=PipelineEngine,
        InMemoryCheckpoint=InMemoryCheckpoint, state_sync=state_sync,
        engine_kw={"device": "cpu"},
        setup_kw={"full_params": params_from_numpy(full_np, "cpu")},
        state_of=_port_state)
    port = _drive(side)
    still = _engine(side)
    port["still_loss"] = still.train_iteration()
    port["still_state_bytes"] = {s: still.state_spec(s).nbytes
                                 for s in range(PP)}
    return ref, port


@pytest.mark.parametrize("op", OPS)
def test_transfer_report_identical(runs, op):
    ref, port = runs
    assert port[op]["report"] == ref[op]["report"]
    assert port[op]["step"] == ref[op]["step"]


@pytest.mark.parametrize("part", ["phases", "lanes", "devices", "peers"])
@pytest.mark.parametrize("op", OPS)
def test_clock_and_device_ledgers_identical(runs, op, part):
    ref, port = runs
    assert port[op][part] == ref[op][part]


def test_recovery_paths_are_the_three_named(runs):
    _, port = runs
    assert [port[op]["report"]["path"] for op in OPS[3:]] == \
        ["neighbor", "dp_peer", "storage", "dp_peer"]


def test_joiner_receives_one_buffer_of_the_state_spec(runs):
    _, port = runs
    joiner = port["leaver_to_joiner"]["moves"]
    assert joiner == [(DP * PP, "flat", port["still_state_bytes"][1])]
    assert port["leaver_to_joiner"]["report"]["nbytes"] == \
        port["still_state_bytes"][1]
    assert port["regrow_staff"]["moves"] == \
        [(DP * PP + 1, "flat", port["still_state_bytes"][0])]


@pytest.mark.parametrize("op", OPS)
def test_moved_state_bitwise_equal(runs, op):
    """The joiner's packed state (and step) is its source's, byte for
    byte: the leaver's, the re-split machine's own, the hosting
    replica's, or the failed machine's as it was before the fault."""
    _, port = runs
    assert port[op]["src"] is not None
    assert port[op]["dst"] == port[op]["src"]


def test_moved_grid_trains_on_bitwise(runs):
    _, port = runs
    assert port["loss"] == port["still_loss"]


def test_moved_grid_loss_matches_the_reference(runs):
    ref, port = runs
    assert abs(port["loss"] - ref["loss"]) <= LOSS_TOL
    assert port["grid"] == ref["grid"]


@settings(deadline=None, max_examples=8)
@given(stage=st.integers(0, PP - 1), d=st.integers(0, DP - 1),
       seed=st.integers(0, 2 ** 32 - 1))
def test_transfer_charge_depends_only_on_bytes(stage, d, seed):
    """Whatever the leaver holds (here: random bytes), leaver_to_joiner
    charges the same seconds for the stage's buffer size and the joiner
    receives those bytes unchanged."""
    clock = SimClock()
    eng = PipelineEngine(tiny_gpt(LAYERS, D, HEADS, VOCAB), DP, PP, BATCH,
                         SEQ,
                         Cluster(DP * PP + 1), clock, CommHooks(clock),
                         sim_compile_seconds=1.0, device="cpu")
    eng.setup(list(range(DP * PP)))
    leaver, joiner = eng.grid[(d, stage)], DP * PP
    nbytes = eng.state_spec(stage).nbytes
    buf = np.random.default_rng(seed).integers(0, 256, nbytes,
                                               dtype=np.uint8)
    eng.set_state_flat(leaver, stage, buf, 3)
    rep = state_sync.leaver_to_joiner(eng, leaver, joiner, clock)
    eng.swap_machine(leaver, joiner)
    assert rep.nbytes == nbytes
    assert rep.seconds == DEFAULT.transfer(nbytes, DEFAULT.bw_state_transfer,
                                           DEFAULT.rtt_tcp)
    assert clock.lane_total("downtime") == rep.seconds
    got, step = eng.get_state_flat(joiner)
    assert step == 3 and got.tobytes() == buf.tobytes()
