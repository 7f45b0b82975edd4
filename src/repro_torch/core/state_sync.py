"""State synchronization (§7): one-to-one leaver->joiner transfer for
expected events; redundancy/checkpoint paths for unexpected failures.

The zero-memory-overhead choreography of §8.5 is enforced through the
ledgers: the leaver repurposes its gradient buffer as the transfer
channel; the joiner stages the transfer in the headroom left by the
not-yet-established phase-2 inter connections, and the channel is torn
down before switchover completes.

Every clock/device charge here derives from byte sizes
(.nbytes / tree_bytes), never from tensor values, so the port's
ledgers equal the reference's for the same state (the parity tests
depend on that staying true).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster, Machine
from repro_torch.cluster.simclock import SimClock
from repro_torch.train.checkpoint import InMemoryCheckpoint, tree_bytes


@dataclass
class TransferReport:
    nbytes: int
    seconds: float
    path: str                   # leaver | neighbor | storage
    joiner_peak_delta: float    # device-memory overhead observed (bytes)
    # how the buffer was assembled: "flat-memcpy" when the engine's
    # state already lives as 1-D buckets/vectors (fully-flat optimizer
    # path), "per-leaf-pack" when a pytree walk built it
    packing: str = "per-leaf-pack"


def leaver_to_joiner(engine, leaver: int, joiner: int, clock: SimClock,
                     cost: CostModel = DEFAULT, lane: str = "downtime",
                     charge: bool = True) -> TransferReport:
    """Expected-event path: direct GPU-to-GPU state copy over RDMA.
    With charge=False the caller accounts the (parallel) time itself.

    The transfer unit is the leaver's packed flat state buffer
    (core/flatbuf.ByteSpec): ONE contiguous buffer shipped over the
    repurposed gradient-bucket channel — the §8.5 choreography made
    literal, with a single RTT instead of one per state leaf. With the
    fully-flat optimizer path the pack degenerates to a memcpy: param
    segment buckets and flat Adam vectors are already contiguous, and
    the joiner defers unflattening params to its first fwd/bwd."""
    cl: Cluster = engine.cluster
    lm, jm = cl[leaver], cl[joiner]
    stage = engine.coords_of(leaver)[1]
    buf, step = engine.get_state_flat(leaver)
    nbytes = buf.nbytes
    baseline_peak = jm.device.used

    # Leaver: training is over for it — the gradient buffer becomes the
    # NCCL transfer channel (§8.5), so no new device memory there.
    gbuf = lm.device.tagged("grad_buffer")
    lm.device.free("grad_buffer", clock.now)
    lm.device.alloc(gbuf, "xfer_channel", clock.now)
    # Joiner: phase-2 inter buffers are not established yet -> headroom.
    jm.device.alloc(64 * 2 ** 20, "xfer_channel", clock.now)

    t = cost.transfer(nbytes, cost.bw_state_transfer, cost.rtt_tcp)
    if charge:
        clock.advance(t, f"state_xfer:{leaver}->{joiner}", lane=lane)

    engine.set_state_flat(joiner, stage, buf, step)   # the real copy
    grad_bytes = engine.grad_buffer_bytes(stage)
    jm.device.alloc(nbytes, "train_state", clock.now)
    # a general standby pre-allocated its bucket during preparation —
    # only a grad_buffer actually allocated HERE is excluded from the
    # joiner's overhead below
    grad_alloced = 0.0
    if jm.device.tagged("grad_buffer") == 0:
        jm.device.alloc(grad_bytes, "grad_buffer", clock.now)
        grad_alloced = grad_bytes
    # tear the channel down before phase 2 completes
    jm.device.free("xfer_channel", clock.now)
    lm.device.free("xfer_channel", clock.now)
    peak_delta = jm.device.peak - baseline_peak - nbytes - grad_alloced
    packing = ("flat-memcpy" if getattr(engine, "use_flat_buffers", False)
               else "per-leaf-pack")
    return TransferReport(nbytes, t, "leaver", max(peak_delta, 0.0),
                          packing)


def reshard_in_place(engine, mid: int, clock: SimClock,
                     cost: CostModel = DEFAULT,
                     lane: str = "downtime") -> TransferReport:
    """GPU-granular recovery (§9 / ElasWave-style): `mid` lost some of
    its devices and re-splits its shard across the survivors instead
    of migrating away. The slices that lived on the dead devices are
    lost with their HBM and re-fetch from the machine's DP replica
    (identical stage state, RDMA path); the surviving slices re-layout
    over NVLink. The engine then re-packs the flat buckets for the new
    device layout — bitwise the same bytes, so loss parity holds by
    construction. The gradient bucket re-allocates sized for the
    survivor layout (swap-in-place, net zero on the ledger)."""
    m: Machine = engine.cluster[mid]
    assert 0 < m.failed_gpus < m.gpus, \
        f"reshard needs a partial-GPU fault (failed={m.failed_gpus})"
    nbytes = engine.reshard_machine(mid)
    lost = int(nbytes * m.failed_gpus / m.gpus)
    t_fetch = cost.transfer(lost, cost.bw_state_transfer, cost.rtt_tcp)
    t_local = cost.transfer(nbytes - lost, cost.bw_intra_node)
    peer = live_dp_peer(engine, mid)
    if peer is not None:
        # the lost-slice re-fetch occupies the DP replica's compute
        # channel (the peer serves the read) rather than free-riding;
        # the survivor-slice NVLink re-layout stays a local charge
        h = clock.issue_async(("compute", peer), t_fetch,
                              f"reshard_fetch:{peer}->{mid}")
        clock.wait_async(h, lane=lane)
    else:
        clock.advance(t_fetch, f"reshard_fetch:{mid}", lane=lane)
    clock.advance(t_local, f"reshard:{mid}", lane=lane)
    t = t_fetch + t_local
    gbuf = m.device.tagged("grad_buffer")
    m.device.free("grad_buffer", clock.now)
    m.device.alloc(gbuf, "grad_buffer", clock.now)
    packing = ("flat-memcpy" if getattr(engine, "use_flat_buffers", False)
               else "per-leaf-pack")
    return TransferReport(lost, t, "dp_peer", 0.0, packing)


def live_dp_peer(engine, mid: int) -> Optional[int]:
    """A live data-parallel replica of `mid`'s stage, if one survives.
    DP replicas hold bitwise-identical stage state after every update,
    so a victim whose in-memory checkpoint died with an adjacent victim
    can still recover exactly — the redundancy is inherent to data
    parallelism, not a checkpoint artifact."""
    d, s = engine.coords_of(mid)
    for d2 in range(engine.dp):
        if d2 == d:
            continue
        # retired slots (degraded-mode shrink) have no grid entry;
        # explicit None check — machine id 0 is falsy
        peer = engine.grid.get((d2, s))
        if peer is None or peer == mid:
            continue
        pm = engine.cluster[peer]
        if pm.alive and "step" in pm.payload:
            return peer
    return None


def regrow_staff(engine, host: int, joiner: int, stage: int,
                 clock: SimClock, cost: CostModel = DEFAULT,
                 lane: str = "downtime",
                 charge: bool = True) -> TransferReport:
    """Degraded-mode re-grow staffing: the re-staffed rank's state is a
    bitwise copy of its surviving DP replica (the host that served the
    rank while it was retired), shipped as one packed flat buffer over
    RDMA. Unlike leaver_to_joiner the host is NOT leaving — it keeps
    its own buffers and training role — so the copy occupies the host's
    compute channel and stages in the joiner's pre-switch headroom.
    With charge=False the caller issues/waits the (parallel, per-host)
    time itself via the returned seconds."""
    buf, step = engine.get_state_flat(host)
    nbytes = buf.nbytes
    jm = engine.cluster[joiner]
    t = cost.transfer(nbytes, cost.bw_state_transfer, cost.rtt_tcp)
    if charge:
        h = clock.issue_async(("compute", host), t,
                              f"regrow_xfer:{host}->{joiner}")
        clock.wait_async(h, lane=lane)
    engine.set_state_flat(joiner, stage, buf, step)
    jm.device.alloc(nbytes, "train_state", clock.now)
    if jm.device.tagged("grad_buffer") == 0:
        jm.device.alloc(engine.grad_buffer_bytes(stage), "grad_buffer",
                        clock.now)
    packing = ("flat-memcpy" if getattr(engine, "use_flat_buffers", False)
               else "per-leaf-pack")
    return TransferReport(nbytes, t, "dp_peer", 0.0, packing)


def recover_state(engine, failed: int, joiner: int,
                  imc: Optional[InMemoryCheckpoint], clock: SimClock,
                  cost: CostModel = DEFAULT, storage_bw: float = 0.0,
                  storage_state=None,
                  lane: str = "downtime") -> Tuple[TransferReport, int]:
    """Unexpected-failure path: neighbour in-memory checkpoint if the
    redundancy exists, else a live DP replica of the same stage
    (bitwise-identical state — covers victim sets whose members held
    each other's checkpoint replicas), else remote storage
    (distributed-optimizer case). Returns (report, checkpoint_step)."""
    cl: Cluster = engine.cluster
    jm = cl[joiner]
    hit = imc.get(failed) if imc is not None else None
    peer = live_dp_peer(engine, failed) if hit is None else None
    if hit is not None:
        step, state = hit
        nbytes = tree_bytes(state)
        # neighbour CPU memory -> joiner GPU over RDMA
        t = cost.transfer(nbytes, cost.bw_state_transfer, cost.rtt_tcp)
        path = "neighbor"
    elif peer is not None:
        step = int(cl[peer].payload["step"])
        state = engine.get_state(peer)
        nbytes = tree_bytes(state)
        # replica GPU -> joiner GPU over RDMA
        t = cost.transfer(nbytes, cost.bw_state_transfer, cost.rtt_tcp)
        path = "dp_peer"
    else:
        assert storage_state is not None, \
            "no redundancy, no live DP replica, no storage checkpoint"
        step, state = storage_state
        nbytes = tree_bytes(state)
        bw = (storage_bw or cost.bw_storage_per_gpu) * jm.gpus
        t = cost.transfer(nbytes, bw, cost.rtt_tcp)
        path = "storage"
    if path == "dp_peer":
        # the fetch OCCUPIES the replica's compute channel (the peer
        # reads its own HBM to serve the copy) instead of free-riding:
        # same lane seconds when the channel is idle, but a fetch
        # landing while the peer still has collectives in flight
        # honestly queues behind them on the per-channel ledger
        h = clock.issue_async(("compute", peer), t,
                              f"state_recover:{failed}->{joiner}")
        clock.wait_async(h, lane=lane)
    else:
        clock.advance(t, f"state_recover:{failed}->{joiner}", lane=lane)
    engine.set_state(joiner, state)
    jm.device.alloc(nbytes, "train_state", clock.now)
    # a general standby pre-allocated its gradient bucket during
    # preparation (off the critical path); only cold joiners alloc here
    if jm.device.tagged("grad_buffer") == 0:
        jm.device.alloc(tree_bytes(state["params"]), "grad_buffer",
                        clock.now)
    return TransferReport(nbytes, t, path, 0.0), step
