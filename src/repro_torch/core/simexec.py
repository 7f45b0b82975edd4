"""Model-free sim-exec engine: the paper-scale fast path (counterpart of
`repro/core/simexec.py`).

`SimExecEngine` is a `PipelineEngine` that carries **no tensors**.
Parameter / optimizer / activation state is represented by zero-storage
symbolic buffers — `np.broadcast_to(scalar, (nbytes,))` views whose
logical `.nbytes` is exact while the backing storage is one element —
so every byte count the runtime derives from state (`tree_bytes`,
`MemoryLedger` allocations, `CommHooks` transfer charges, `state_sync`
packing, `InMemoryCheckpoint` footprints) is identical to real-exec, at
O(1) memory and zero FLOPs. The views stay numpy arrays: `to_host`
copies torch tensors only, so a view reaches a checkpoint unallocated,
where an expanded tensor would be materialised in full.

The SimClock charge sequence of `train_iteration`, state transfer and
warmup mirrors `PipelineEngine` **exactly**: same phase names, same
lanes, same async-ledger channels, same issue/wait order, same byte
sizes (all sizes come from the meta-device specs the real engine uses).
With `sim_compile_seconds` set — mandatory here, since there is nothing
to measure — every charge the real engine makes is a deterministic
function of (config, CostModel), so a campaign run in sim-exec mode
produces the *same ledger, byte for byte*, as real-exec.

What is NOT preserved: numerics. There are no params, so bitwise loss
parity degenerates to a deterministic per-iteration loss stamp
(`_sim_loss` — a pure function of the iteration index, bitwise the
reference's, which keeps rollback/re-run parity and the campaign's
per-mode reference comparison exact *within* sim-exec).

The engine holds no tensor and never touches a card: without a device
it takes the meta device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cluster.node import NodeStatus, Role
from repro_torch.core import groups as groups_mod
from repro_torch.core.engine import (FLOPS_PER_GPU, CompiledRole,
                                     PipelineEngine, stage_role_key)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import tree_bytes
from repro_torch.tree import tree_map


def sym_bytes(nbytes: int) -> np.ndarray:
    """Zero-storage stand-in for an `nbytes`-sized buffer: a broadcast
    uint8 view whose logical `.nbytes` is exact (backing storage is one
    element). It flows through `tree_bytes`, `InMemoryCheckpoint.put`
    and the `CommHooks` nbytes probes without ever materializing."""
    return np.broadcast_to(np.uint8(0), (int(nbytes),))


def sym_array(size: int, dtype: torch.dtype) -> np.ndarray:
    """Zero-storage stand-in for a 1-D `dtype[size]` buffer (gradient
    segments, whose collective charge is `size * itemsize` bytes): only
    its byte count is read, and numpy has no bfloat16."""
    return sym_bytes(int(size) * dtype.itemsize)


class SimExecEngine(PipelineEngine):
    """Tensor-free `PipelineEngine`: identical SimClock/ledger behavior,
    no math. Requires the flat-buffer path and deterministic-simulation
    compile charges (there is no wall clock to measure)."""

    def __init__(self, *args, device=None, **kwargs):
        super().__init__(*args, device="meta" if device is None else device,
                         **kwargs)
        assert self.use_flat_buffers, \
            "sim-exec models the flat-buffer hot path only"
        assert self.sim_compile_seconds is not None, \
            "sim-exec needs sim_compile_seconds: compiles are not measured"
        self._opt_bytes_cache: Dict[int, int] = {}

    # -------------------------------------------------- symbolic state
    def _opt_bytes(self, stage: int) -> int:
        """Exact flat-optimizer-state bytes for a stage: the real
        init_flat_opt_state run over meta-device parameters (flat m, v
        and master in f32, and the step), so nothing is allocated."""
        if stage not in self._opt_bytes_cache:
            params = tree_map(
                lambda l: torch.empty(l.shape, dtype=l.dtype,
                                      device="meta"),
                self._stage_param_spec(stage))
            self._opt_bytes_cache[stage] = tree_bytes(
                opt_mod.init_flat_opt_state(self.flat_spec(stage), params))
        return self._opt_bytes_cache[stage]

    def _param_bytes(self, stage: int) -> int:
        return self.flat_spec(stage).nbytes

    def _sym_payload(self, stage: int, step: int) -> dict:
        return {"params": None,
                "param_segs": sym_bytes(self._param_bytes(stage)),
                "_seg_stage": stage,
                "opt": sym_bytes(self._opt_bytes(stage)),
                "step": int(step)}

    def _sim_loss(self, it: int) -> float:
        """Deterministic loss stamp: a pure function of the iteration
        index, so a rollback re-run commits bitwise-identical losses
        and the campaign's within-mode reference comparison stays
        exact."""
        return float(np.float32(np.log(float(self.cfg.vocab_size)))
                     * np.float32(0.97) ** np.int32(it))

    # ------------------------------------------------------------ setup
    def setup(self, machine_ids: List[int],
              full_params: Optional[dict] = None) -> None:
        """Place every rank with a symbolic state. `full_params` is
        taken, as the real engine takes it, and ignored: there are no
        weights."""
        assert len(machine_ids) >= self.dp * self.pp
        self.grid.clear()
        self._coords.clear()
        self.hosted.clear()
        it = iter(machine_ids)
        for d in range(self.dp):
            for s in range(self.pp):
                mid = next(it)
                self.grid[(d, s)] = mid
                self._coords[mid] = (d, s)
                m = self.cluster[mid]
                m.status = NodeStatus.TRAINING
                m.role = Role(d, s, self.pp)
                m.payload = self._sym_payload(s, 0)
                # same ledger math as real setup:
                # tree_bytes({"params": tree, "opt": flat_opt, "step": 0})
                # = param bytes + opt bytes + 8 (python-int step leaf)
                m.device.alloc(
                    self._param_bytes(s) + self._opt_bytes(s) + 8,
                    "train_state", self.clock.now)
                m.device.alloc(self.grad_buffer_bytes(s), "grad_buffer",
                               self.clock.now)
        self.groups = groups_mod.build_groups(
            self.dp, self.pp, self.grid,
            channels=self.cost.channels_per_group)
        for g in self.groups.values():
            g.establish_all()

    # --------------------------------------------------------- compiling
    def compile_role(self, stage: int, fresh: bool = False,
                     charge: Optional[str] = None) -> CompiledRole:
        """No programs: a stub role whose compile charge is the modeled
        constant — exactly what real-exec charges when
        sim_compile_seconds is set, so the ledgers agree."""
        if not fresh and stage in self._role_cache:
            return self._role_cache[stage]
        role = CompiledRole({}, self.sim_compile_seconds)
        if not fresh:
            self._role_cache[stage] = role
        if charge is not None:
            self.clock.advance(self.compile_charge(role), f"jit:{stage}",
                               lane=charge)
        return role

    # ----------------------------------------------------------- running
    def train_iteration(self, it: Optional[int] = None,
                        lane: str = "train") -> float:
        """Charge-identical mirror of the real flat-path iteration:
        same compute/backward-wave advances, same p2p and gradbucket
        channels in the same issue/wait order, same phase points and
        barrier — with symbolic payloads instead of tensors."""
        it = self.step_count if it is None else it
        comm = self.comm
        comm.reset_counters()
        losses: List[float] = []
        load: Dict[int, int] = {}
        for d in range(self.dp):
            for s in range(self.pp):
                mid = self._mid(d, s)
                load[mid] = load.get(mid, 0) + 1
        slow = max(self.cluster[mid].straggle_factor * n
                   for mid, n in load.items())
        t_comp = 3 * self._stage_flops * self.nmb * slow / \
            (FLOPS_PER_GPU * self.cluster[self._mid(0, 0)].gpus)
        # activation / activation-grad transfer unit: (B, S, d_model)
        # fp32, same as the real stage boundary
        act = np.broadcast_to(
            np.float32(0.0),
            (self.mb_size, self.seq_len, self.cfg.d_model))

        for d in range(self.dp):
            for mb in range(self.nmb):
                for s in range(self.pp):
                    m = self.machine(d, s)
                    if s > 0:
                        comm.p2p_recv(stage_role_key(s), "act",
                                      src=self._mid(d, s - 1),
                                      dst=m.mid, value=act, overlap=True)
                    if s < self.pp - 1:
                        comm.p2p_send(stage_role_key(s), "act", m.mid,
                                      self._mid(d, s + 1), act)
                for s in reversed(range(self.pp)):
                    m = self.machine(d, s)
                    if s == self.pp - 1:
                        losses.append(self._sim_loss(it))
                    else:
                        comm.p2p_recv(stage_role_key(s), "grad",
                                      src=self._mid(d, s + 1),
                                      dst=m.mid, value=act, overlap=True)
                    if s > 0:
                        comm.p2p_send(stage_role_key(s), "grad", m.mid,
                                      self._mid(d, s - 1), act)

        self._phase_point("pre_reduce", it)
        self._sim_reduce_and_update(it, t_comp, lane)
        self._phase_point("post_reduce", it)
        self.comm.barrier("iter")
        self.step_count = it + 1
        loss = float(np.mean(losses))
        self.losses.append(loss)
        return loss

    def _sim_reduce_and_update(self, it: int, t_comp: float,
                               lane: str) -> None:
        """The `_flat_reduce_and_update` charge sequence without the
        math: bulk compute, per-stage backward-wave slices, one
        gradbucket collective per dtype segment per stage (issued at
        the stage's slice, waited in issue order), payload step bump."""
        t_bwd = min((2.0 / 3.0) * t_comp / self.nmb, t_comp / self.pp)
        self.clock.advance(max(t_comp - self.pp * t_bwd, 0.0),
                           "compute", lane=lane)
        handles: Dict[int, List[Any]] = {}
        for s in reversed(range(self.pp)):
            self.clock.advance(t_bwd, f"compute:bwd_tail:{s}", lane=lane)
            phys = len({self._mid(d, s) for d in range(self.dp)})
            handles[s] = [
                self.comm.all_reduce_async(
                    stage_role_key(s), "gradbucket",
                    [sym_array(g.size, g.dtype)], participants=phys)
                for g in self.flat_spec(s).segments]
        for s in reversed(range(self.pp)):
            for h in handles[s]:
                self.comm.wait(h)
            for d in range(self.dp):
                m = self.machine(d, s)
                m.payload["params"] = None
                m.payload["_seg_stage"] = s
                m.payload["step"] = it + 1

    def shadow_iteration(self, machine, role_key, stage: int,
                         state: Optional[dict] = None,
                         lane: str = "overlap",
                         fresh_compile: bool = True) -> CompiledRole:
        """Warmup without replay: REPLAY-mode hooks charge nothing in
        real-exec, so only the compile/shadow-exec constant lands on
        the clock — charged here identically."""
        self.comm.reset_counters()
        role = self.compile_role(stage, fresh=fresh_compile)
        if state is None:
            state = {"params": sym_bytes(self._param_bytes(stage)),
                     "opt": sym_bytes(self._opt_bytes(stage)),
                     "step": 0}
        machine.warm_roles[role_key] = role
        machine.payload.setdefault("sandbox_state", state)
        self.clock.advance(self.compile_charge(role),
                           f"shadow:{role_key}", lane=lane)
        return role

    # ------------------------------------------------------- state moves
    def get_state(self, mid: int) -> dict:
        # the step passes through as stored: a python int normally
        # (8-byte leaf, as real-exec's), an int32 scalar after a
        # set_state restore (real set_state makes it a 0-d int32 tensor
        # — 4-byte leaf) — keeping re-saved checkpoint byte counts
        # identical between modes
        m = self.cluster[mid]
        return {"params": sym_bytes(m.payload["param_segs"].nbytes),
                "opt": sym_bytes(np.asarray(m.payload["opt"]).nbytes),
                "step": m.payload["step"]}

    def set_state(self, mid: int, state: dict) -> None:
        # byte sizes come from the state itself, so a fresh joiner (not
        # yet in the grid) restores without knowing its stage; other
        # payload keys (sandbox_state, _seg_stage) survive like the
        # real payload.update does
        m = self.cluster[mid]
        m.payload["param_segs"] = sym_bytes(tree_bytes(state["params"]))
        m.payload["params"] = None
        m.payload["opt"] = sym_bytes(tree_bytes(state["opt"]))
        m.payload["step"] = np.int32(np.asarray(state["step"]))

    def get_state_flat(self, mid: int) -> Tuple[np.ndarray, int]:
        _, s = self.coords_of(mid)
        m = self.cluster[mid]
        return (sym_bytes(self.state_spec(s).nbytes),
                int(m.payload["step"]))

    def set_state_flat(self, mid: int, stage: int, buf: np.ndarray,
                       step: int) -> None:
        # dict.update preserves unrelated keys (sandbox_state), same as
        # the real engine's targeted assignments
        self.cluster[mid].payload.update(self._sym_payload(stage, step))
