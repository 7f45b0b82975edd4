"""Real-execution DP x PP pipeline engine over cluster machines
(counterpart of `repro/core/engine.py`).

Each machine owns one pipeline stage of one data-parallel replica. All
cross-machine traffic flows through the CommHooks seam
(core/sandbox.py), so the same step code runs in NORMAL, RECORD and
REPLAY modes. Stage programs are eager PyTorch; causal attention inside
every `attn` and `attn_moe` block runs in the hand-written CUDA kernels
(kernels/flash_attention.py), and so do the MoE expert products
(kernels/moe_gmm.py). As in the reference, the MoE load-balance loss
that the blocks return is not trained on. Every SimClock charge is the
reference's, from the same byte sizes, so both engines keep identical
ledgers.

Updates are functional (new tensors, nothing written in place): DP
replicas share one bucket tuple, and recorded tape entries must not
change after the fact.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.cluster.costmodel import CostModel, DEFAULT
from repro_torch.cluster.node import Cluster, Machine, NodeStatus, Role
from repro_torch.cluster.simclock import SimClock
from repro_torch.core import flatbuf
from repro_torch.core import groups as groups_mod
from repro_torch.core.sandbox import CommHooks, CommMode, Tape
from repro_torch.device import deterministic_cuda, resolve_device
from repro_torch.kernels import _build
from repro_torch.models import backbone, blocks
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import to_host, tree_bytes
from repro_torch.tree import (ShapeDtype, shape_dtype, tree_flatten,
                              tree_leaves, tree_map)

# The simulator's modeled per-GPU compute rate (A100 bf16 at a realistic
# MFU), kept equal to the reference's so that both engines charge the
# same simulated compute seconds. It is no measurement of any chip.
FLOPS_PER_GPU = 125e12


class IterationInterrupt(Exception):
    """Raised by an armed interrupt hook at an iteration phase point.

    The aborted iteration commits nothing; `dirty` is True when machine
    payloads were already mutated (post_reduce)."""

    def __init__(self, phase: str, it: int, victim: Optional[int] = None):
        super().__init__(f"iteration {it} interrupted at {phase}")
        self.phase = phase
        self.it = it
        self.victim = victim
        self.dirty = phase == "post_reduce"


def stage_role_key(stage: int) -> int:
    return stage


def stage_type(stage: int, pp: int) -> str:
    if pp == 1:
        return "only"
    if stage == 0:
        return "first"
    if stage == pp - 1:
        return "last"
    return "middle"


# ---------------------------------------------------------------- stages
def split_stage_params(full_params: dict, stage: int, pp: int,
                       cfg: ArchConfig) -> dict:
    """Contiguous layer split; stage 0 carries the embedding, the last
    stage carries final_ln + head."""
    L = cfg.num_layers
    if len(cfg.block_pattern) != 1:
        raise ValueError("engine supports period-1 archs")
    if L % pp:
        raise ValueError(f"{L} layers do not split over pp={pp}")
    per = L // pp
    lo, hi = stage * per, (stage + 1) * per
    sl = tree_map(lambda x: x[lo:hi], full_params["stack"]["scan"])
    p = {"stack": {"scan": sl, "tail": ()}}
    if stage == 0:
        p["embed"] = full_params["embed"]
    if stage == pp - 1:
        p["final_ln"] = full_params["final_ln"]
        p["head"] = (full_params["head"] if "head" in full_params
                     else full_params["embed"].T)
    return p


def _with_grad(params, x):
    """Fresh leaves that require grad (x only when it is floating)."""
    leaves, td = tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    if x.is_floating_point():
        x = x.detach().requires_grad_(True)
    return td, leaves, x


def _grads(out, leaves, x, grad_out=None):
    inputs = leaves + ([x] if x.requires_grad else [])
    gs = torch.autograd.grad(out, inputs, grad_outputs=grad_out,
                             allow_unused=True)
    gs = [torch.zeros_like(i) if g is None else g
          for g, i in zip(gs, inputs)]
    dx = gs[len(leaves)] if x.requires_grad else None
    return gs[:len(leaves)], dx


def make_stage_fns(cfg: ArchConfig, stage: int, pp: int):
    """Stage programs: fwd / last_bwd / mid_bwd. Gradients come from
    torch.autograd; mid_bwd recomputes the forward with grad, as
    jax.vjp does in the reference."""
    first = stage == 0

    def fwd(params, x_or_tokens):
        x = params["embed"][x_or_tokens] if first else x_or_tokens
        B, S = x_or_tokens.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, _ = backbone.apply_stack(params["stack"], x, cfg, 1,
                                    positions=positions, impl="dense",
                                    remat=False)
        return x

    def head_loss(params, x, tokens):
        x = blocks.rmsnorm(x, params["final_ln"], cfg.norm_eps)
        logits = blocks.einsum("bsd,dv->bsv", x, params["head"]).float()
        return backbone.lm_loss(logits, tokens)

    def fwd_nograd(params, x_or_tokens):
        with torch.no_grad():
            return fwd(params, x_or_tokens)

    def last_bwd(params, x_or_tokens, tokens):
        td, leaves, x = _with_grad(params, x_or_tokens)
        with torch.enable_grad():
            p = td.unflatten(leaves)
            loss = head_loss(p, fwd(p, x), tokens)
            gs, dx = _grads(loss, leaves, x)
        return loss.detach(), td.unflatten(gs), dx

    def mid_bwd(params, x_or_tokens, dy):
        td, leaves, x = _with_grad(params, x_or_tokens)
        with torch.enable_grad():
            y = fwd(td.unflatten(leaves), x)
            gs, dx = _grads(y, leaves, x, grad_out=dy)
        return td.unflatten(gs), dx

    return {"fwd": fwd_nograd, "last_bwd": last_bwd, "mid_bwd": mid_bwd}


# ---------------------------------------------------------------- engine
@dataclass
class CompiledRole:
    fns: Dict[str, Any]
    compile_seconds: float


class PipelineEngine:
    def __init__(self, cfg: ArchConfig, dp: int, pp: int,
                 global_batch: int, seq_len: int, cluster: Cluster,
                 clock: SimClock, comm: CommHooks,
                 cost: CostModel = DEFAULT, micro_batches: int = 2,
                 seed: int = 0,
                 adam: Optional[opt_mod.AdamCfg] = None,
                 use_flat_buffers: bool = True,
                 param_dtype=torch.float32,
                 sim_compile_seconds: Optional[float] = None,
                 device=None):
        if global_batch % (dp * micro_batches):
            raise ValueError("global_batch must divide over dp x "
                             "micro_batches")
        self.device = resolve_device(device, "PipelineEngine")
        if self.device.type == "cuda":
            deterministic_cuda()
        self.cfg, self.dp, self.pp = cfg, dp, pp
        self.global_batch, self.seq_len = global_batch, seq_len
        self.nmb = micro_batches
        self.mb_size = global_batch // dp // micro_batches
        self.cluster, self.clock, self.comm, self.cost = \
            cluster, clock, comm, cost
        self.adam = adam or opt_mod.AdamCfg(lr=1e-3, warmup_steps=10)
        self.seed = seed
        # Flat-buffer hot path (per-stage per-dtype gradient buckets, one
        # async all-reduce per bucket, fully flat Adam state, one update
        # shared by the DP replicas); False keeps the per-leaf path.
        self.use_flat_buffers = use_flat_buffers
        # Mixed precision: stack weights in param_dtype; embedding /
        # final norm / head stay f32.
        self.param_dtype = param_dtype
        self.grid: Dict[Tuple[int, int], int] = {}
        self._coords: Dict[int, Tuple[int, int]] = {}
        # Degraded-mode rank hosting (dp_retire/dp_restaff): retired
        # logical (d, s) slots -> the same-stage replica serving them.
        self.hosted: Dict[Tuple[int, int], int] = {}
        self._flat_specs: Dict[int, flatbuf.SegmentedSpec] = {}
        self._state_specs: Dict[int, flatbuf.ByteSpec] = {}
        self._grad_bytes: Dict[int, int] = {}
        self._pspecs: Dict[int, Any] = {}
        # stage -> (bucket tuple, materialized params): DP replicas
        # share the broadcast buckets, so they share the unflatten too
        self._mat_cache: Dict[int, Tuple[Any, Any]] = {}
        self._batch_cache: Tuple[int, Optional[np.ndarray]] = (-1, None)
        self.groups: Dict[str, groups_mod.CommGroup] = {}
        self.stream = data_mod.SyntheticStream(
            data_mod.DataCfg(cfg.vocab_size, global_batch, seq_len,
                             seed=seed + 77))
        self._role_cache: Dict[int, CompiledRole] = {}
        # Deterministic-simulation mode: every clock charge that would
        # use a measured wall-clock duration uses this constant instead.
        self.sim_compile_seconds = sim_compile_seconds
        # phase -> callback(engine, phase, it) at named points inside
        # train_iteration ("pre_reduce", "post_reduce").
        self.interrupt_hooks: Dict[str, Any] = {}
        self.step_count = 0
        self.losses: List[float] = []
        self._stage_flops = self._estimate_stage_flops()

    # ------------------------------------------------------------ setup
    def _init_full(self) -> dict:
        gen = torch.Generator().manual_seed(self.seed)
        return backbone.init_params(self.cfg, gen, tp=1,
                                    dtype=torch.float32)

    def _stage_tensors(self, full: dict, stage: int) -> dict:
        params = self._cast_stage_params(
            split_stage_params(full, stage, self.pp, self.cfg))
        return tree_map(lambda t: t.to(self.device), params)

    def setup(self, machine_ids: List[int],
              full_params: Optional[dict] = None) -> None:
        """Place every (d, s) rank on a machine. `full_params` is a
        full parameter tree (e.g. from convert.params_from_numpy);
        without one, the weights are drawn from the engine's seed."""
        if len(machine_ids) < self.dp * self.pp:
            raise ValueError("not enough machines for the grid")
        self.grid.clear()
        self._coords.clear()
        self.hosted.clear()
        full = self._init_full() if full_params is None else full_params
        it = iter(machine_ids)
        for d in range(self.dp):
            for s in range(self.pp):
                mid = next(it)
                self.grid[(d, s)] = mid
                self._coords[mid] = (d, s)
                m = self.cluster[mid]
                m.status = NodeStatus.TRAINING
                m.role = Role(d, s, self.pp)
                params = self._stage_tensors(full, s)
                if self.use_flat_buffers:
                    spec = self.flat_spec(s)
                    m.payload = {
                        "params": params,
                        "param_segs": spec.flatten(params),
                        "_seg_stage": s,
                        "opt": opt_mod.init_flat_opt_state(spec, params),
                        "step": 0}
                else:
                    m.payload = {"params": params,
                                 "opt": opt_mod.init_opt_state(params),
                                 "step": 0}
                m.device.alloc(tree_bytes({"params": params,
                                           "opt": m.payload["opt"],
                                           "step": 0}), "train_state",
                               self.clock.now)
                m.device.alloc(self.grad_buffer_bytes(s), "grad_buffer",
                               self.clock.now)
        self.groups = groups_mod.build_groups(
            self.dp, self.pp, self.grid, channels=self.cost.channels_per_group)
        for g in self.groups.values():
            g.establish_all()

    def _mid(self, d: int, s: int) -> int:
        """Physical machine serving logical rank (d, s)."""
        key = (d, s)
        if key in self.grid:
            return self.grid[key]
        return self.hosted[key]

    def machine(self, d: int, s: int) -> Machine:
        return self.cluster[self._mid(d, s)]

    def coords_of(self, mid: int) -> Tuple[int, int]:
        return self._coords[mid]

    def _estimate_stage_flops(self) -> float:
        cfg = self.cfg
        per_layer = (12 * cfg.d_model ** 2 +
                     2 * cfg.d_model * cfg.d_ff * 3)
        tokens = self.mb_size * self.seq_len
        return 3 * per_layer * (cfg.num_layers / self.pp) * tokens

    # --------------------------------------------------------- compiling
    def _cast_stage_params(self, params: dict) -> dict:
        if self.param_dtype == torch.float32:
            return params
        out = dict(params)
        out["stack"] = tree_map(lambda x: x.to(self.param_dtype),
                                params["stack"])
        return out

    def _stage_param_spec(self, stage: int):
        """ShapeDtype tree of this stage's params (no data)."""
        if stage not in self._pspecs:
            full = backbone.init_params(self.cfg, None, tp=1,
                                        dtype=torch.float32, device="meta")
            self._pspecs[stage] = shape_dtype(self._cast_stage_params(
                split_stage_params(full, stage, self.pp, self.cfg)))
        return self._pspecs[stage]

    def flat_spec(self, stage: int) -> flatbuf.SegmentedSpec:
        if stage not in self._flat_specs:
            self._flat_specs[stage] = flatbuf.SegmentedSpec.from_tree(
                self._stage_param_spec(stage))
        return self._flat_specs[stage]

    def grad_buffer_bytes(self, stage: int) -> int:
        if self.use_flat_buffers:
            return self.flat_spec(stage).nbytes
        if stage not in self._grad_bytes:
            self._grad_bytes[stage] = flatbuf.ByteSpec.from_tree(
                self._stage_param_spec(stage)).nbytes
        return self._grad_bytes[stage]

    def bucket_reduce_fn(self, stage: int):
        """The whole DP reduction: leafwise adds in replica order, then
        ONE drain into the per-dtype buckets."""
        spec = self.flat_spec(stage)

        def bucket_reduce(*trees):
            acc = trees[0]
            for t in trees[1:]:
                acc = tree_map(torch.add, acc, t)
            return spec.flatten(acc)

        return bucket_reduce

    def compile_role(self, stage: int, fresh: bool = False,
                     charge: Optional[str] = None) -> CompiledRole:
        """Build the stage programs (and, on the card, load the kernel
        library), timing it as the role's compile seconds. fresh=True
        bypasses the engine cache (a cold machine)."""
        if not fresh and stage in self._role_cache:
            return self._role_cache[stage]
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            _build.libraries()
        out = dict(make_stage_fns(self.cfg, stage, self.pp))
        if stage == self.pp - 1:
            del out["mid_bwd"]
        else:
            del out["last_bwd"]
        if self.use_flat_buffers:
            spec = self.flat_spec(stage)
            out["flatten"] = spec.flatten
            out["unflatten"] = spec.unflatten

            def upd_flat(seg_grads, opt, n_avg):
                # average in the bucket's own dtype
                segs = tuple(g / n_avg.to(g.dtype) for g in seg_grads)
                return opt_mod.adam_update_flat(spec, segs, opt, self.adam)

            out["update"] = upd_flat
        else:
            def upd(grads, opt, n_avg):
                g = tree_map(lambda x: x / n_avg.to(x.dtype), grads)
                return opt_mod.adam_update(g, opt, self.adam,
                                           param_dtype=None)

            out["update"] = upd
        role = CompiledRole(out, time.perf_counter() - t0)
        if not fresh:
            self._role_cache[stage] = role
        if charge is not None:
            self.clock.advance(self.compile_charge(role), f"jit:{stage}",
                               lane=charge)
        return role

    def compile_charge(self, role: CompiledRole,
                       exec_seconds: float = 0.0) -> float:
        """Seconds to charge for building (and optionally
        shadow-executing) a role: measured, or the modeled constant in
        deterministic-simulation mode."""
        if self.sim_compile_seconds is not None:
            return self.sim_compile_seconds
        return role.compile_seconds + exec_seconds

    # ----------------------------------------------------------- running
    def _phase_point(self, phase: str, it: int) -> None:
        cb = self.interrupt_hooks.get(phase)
        if cb is not None:
            cb(self, phase, it)

    INTERRUPT_PHASES = ("pre_reduce", "post_reduce")

    def arm_interrupt(self, phase: str, victim: int) -> None:
        """One-shot: raise IterationInterrupt for `victim` the next
        time the iteration reaches `phase`."""
        if phase not in self.INTERRUPT_PHASES:
            raise ValueError(phase)

        def fire(engine, ph, it):
            engine.interrupt_hooks.pop(ph, None)
            raise IterationInterrupt(ph, it, victim)

        self.interrupt_hooks[phase] = fire

    def _dev(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def _mb_tokens(self, it: int, d: int, mb: int) -> torch.Tensor:
        if self._batch_cache[0] != it:
            self._batch_cache = (it, self.stream.batch(it)["tokens"])
        batch = self._batch_cache[1]
        per_d = batch.shape[0] // self.dp
        chunk = batch[d * per_d:(d + 1) * per_d]
        return torch.from_numpy(
            chunk[mb * self.mb_size:(mb + 1) * self.mb_size]).long() \
            .to(self.device)

    def _stage_params(self, m: Machine):
        """A machine's live params, materialized lazily as views over
        its flat segment buffers (cached per stage by bucket identity:
        DP replicas share one bucket tuple)."""
        p = m.payload.get("params")
        if p is None:
            s = m.payload["_seg_stage"]
            segs = m.payload["param_segs"]
            cached = self._mat_cache.get(s)
            if cached is not None and cached[0] is segs:
                p = cached[1]
            else:
                p = self.compile_role(s).fns["unflatten"](tuple(segs))
                self._mat_cache[s] = (segs, p)
            m.payload["params"] = p
        return p

    def _navg(self) -> torch.Tensor:
        return torch.tensor(float(self.dp * self.nmb), dtype=torch.float32,
                            device=self.device)

    def train_iteration(self, it: Optional[int] = None,
                        lane: str = "train") -> float:
        """One synchronous iteration across the whole grid, with the
        reference's overlap-aware charges. Every clock charge is a
        function of (config, CostModel, byte sizes), never of tensor
        values."""
        it = self.step_count if it is None else it
        comm = self.comm
        comm.reset_counters()
        losses = []
        grads_acc: Dict[Tuple[int, int], Any] = {}
        load: Dict[int, int] = {}
        for d in range(self.dp):
            for s in range(self.pp):
                mid = self._mid(d, s)
                load[mid] = load.get(mid, 0) + 1
        slow = max(self.cluster[mid].straggle_factor * n
                   for mid, n in load.items())
        t_comp = 3 * self._stage_flops * self.nmb * slow / \
            (FLOPS_PER_GPU * self.cluster[self._mid(0, 0)].gpus)
        overlap = self.use_flat_buffers
        if not overlap:
            self.clock.advance(t_comp, "compute", lane=lane)

        for d in range(self.dp):
            acts: Dict[Tuple[int, int], Any] = {}
            for mb in range(self.nmb):
                tokens = self._mb_tokens(it, d, mb)
                x = tokens
                for s in range(self.pp):
                    m = self.machine(d, s)
                    fns = self.compile_role(s).fns
                    if s > 0:
                        x = comm.p2p_recv(stage_role_key(s), "act",
                                          src=self._mid(d, s - 1),
                                          dst=m.mid, value=x,
                                          overlap=overlap)
                    acts[(s, mb)] = x
                    if s < self.pp - 1:
                        y = fns["fwd"](self._stage_params(m), x)
                        comm.p2p_send(stage_role_key(s), "act", m.mid,
                                      self._mid(d, s + 1), y)
                        x = y
                dy = None
                for s in reversed(range(self.pp)):
                    m = self.machine(d, s)
                    fns = self.compile_role(s).fns
                    if s == self.pp - 1:
                        loss, dp_, dx = fns["last_bwd"](
                            self._stage_params(m), acts[(s, mb)], tokens)
                        losses.append(float(loss))
                    else:
                        dy = comm.p2p_recv(stage_role_key(s), "grad",
                                           src=self._mid(d, s + 1),
                                           dst=m.mid, value=dy,
                                           overlap=overlap)
                        dp_, dx = fns["mid_bwd"](self._stage_params(m),
                                                 acts[(s, mb)], dy)
                    if s > 0:
                        comm.p2p_send(stage_role_key(s), "grad", m.mid,
                                      self._mid(d, s - 1), dx)
                        dy = dx
                    key = (d, s)
                    grads_acc[key] = dp_ if key not in grads_acc else \
                        tree_map(torch.add, grads_acc[key], dp_)

        self._phase_point("pre_reduce", it)
        navg = self._navg()
        if self.use_flat_buffers:
            self._flat_reduce_and_update(grads_acc, navg, it, t_comp,
                                         lane)
        else:
            self._leaf_reduce_and_update(grads_acc, navg, it)
        self._phase_point("post_reduce", it)
        self.comm.barrier("iter")
        self.step_count = it + 1
        loss = float(np.mean(losses))
        self.losses.append(loss)
        return loss

    def _flat_reduce_and_update(self, grads_acc, navg, it: int,
                                t_comp: float, lane: str) -> None:
        """Overlapped bucketed reduction + fully-flat Adam update, charged
        as the reference charges it: the bulk of the compute first, then
        the final microbatch's backward wave stage by stage, issuing each
        stage's bucket collectives right after its slice."""
        t_bwd = min((2.0 / 3.0) * t_comp / self.nmb, t_comp / self.pp)
        self.clock.advance(max(t_comp - self.pp * t_bwd, 0.0),
                           "compute", lane=lane)
        handles: Dict[int, List[Any]] = {}
        for s in reversed(range(self.pp)):
            self.clock.advance(t_bwd, f"compute:bwd_tail:{s}", lane=lane)
            stacked = [grads_acc[(d, s)] for d in range(self.dp)]
            segs = self.bucket_reduce_fn(s)(*stacked)
            phys = len({self._mid(d, s) for d in range(self.dp)})
            handles[s] = [
                self.comm.all_reduce_async(stage_role_key(s),
                                           "gradbucket", [seg],
                                           participants=phys)
                for seg in segs]
        for s in reversed(range(self.pp)):       # wait in issue order
            fns = self.compile_role(s).fns
            reduced = tuple(self.comm.wait(h) for h in handles[s])
            new_segs, new_opt, _ = fns["update"](
                reduced, self.machine(0, s).payload["opt"], navg)
            for d in range(self.dp):
                m = self.machine(d, s)
                m.payload["param_segs"] = new_segs
                m.payload["params"] = None      # lazy: next fwd/bwd
                m.payload["_seg_stage"] = s
                m.payload["opt"] = new_opt
                m.payload["step"] = it + 1

    def _leaf_reduce_and_update(self, grads_acc, navg, it: int) -> None:
        """Per-leaf reference path: one all_reduce per leaf, one Adam
        update per DP rank."""
        for s in range(self.pp):
            stacked = [grads_acc[(d, s)] for d in range(self.dp)]
            fns = self.compile_role(s).fns
            leaves0, tdef = tree_flatten(stacked[0])
            per_rank = [tree_leaves(t) for t in stacked]
            reduced = tdef.unflatten([
                self.comm.all_reduce(stage_role_key(s), f"grad{li}",
                                     [lv[li] for lv in per_rank])
                for li in range(len(leaves0))])
            for d in range(self.dp):
                m = self.machine(d, s)
                new_p, new_opt, _ = fns["update"](reduced,
                                                  m.payload["opt"], navg)
                m.payload["params"] = new_p
                m.payload["opt"] = new_opt
                m.payload["step"] = it + 1

    # ---------------------------------------------------- record / replay
    def record_iteration(self, it: Optional[int] = None) -> Tape:
        """First-iteration pre-record (§4.2): one normal iteration with
        the recording hook attached, then stage tapes aliased onto the
        general-standby role types."""
        prev = self.comm.mode
        self.comm.mode = CommMode.RECORD
        self.train_iteration(it)
        self.comm.mode = prev
        tape = self.comm.tape
        freed, fused = 0, 0
        for s in range(self.pp):
            rk = stage_role_key(s)
            df = tape.fuse_p2p_io(rk)
            if df >= 0:
                fused += 1
                freed += df
            else:
                freed += tape.coalesce_p2p(rk)
        tape.meta["p2p_fused_roles"] = fused
        tape.meta["p2p_bytes_freed"] = freed
        reps = {"first": 0, "last": self.pp - 1,
                "middle": 1 if self.pp > 2 else 0,
                "only": 0}
        for role_type in (("only",) if self.pp == 1
                          else ("first", "middle", "last")):
            tape.alias_role(stage_role_key(reps[role_type]), role_type)
        tape.meta["pp"] = self.pp
        tape.meta["recorded_step"] = self.step_count - 1
        return tape

    def shadow_iteration(self, machine: Machine, role_key,
                         stage: int, state: Optional[dict] = None,
                         lane: str = "overlap",
                         fresh_compile: bool = True) -> CompiledRole:
        """Sandboxed shadow iteration on a joiner/standby (§4.2 replay):
        builds the role's programs and runs one isolated iteration fed
        from the tape."""
        prev_mode, prev_members = self.comm.mode, self.comm.sandbox_members
        self.comm.mode = CommMode.REPLAY
        self.comm.sandbox_members = {machine.mid}
        self.comm.reset_counters()
        try:
            role = self.compile_role(stage, fresh=fresh_compile)
            if state is None:
                params = self._stage_tensors(self._init_full(), stage)
                opt = (opt_mod.init_flat_opt_state(self.flat_spec(stage),
                                                   params)
                       if self.use_flat_buffers
                       else opt_mod.init_opt_state(params))
                state = {"params": params, "opt": opt, "step": 0}
            t0 = time.perf_counter()
            tokens = self._mb_tokens(0, 0, 0)
            fused = self.comm.tape.has((role_key, "p2p", "io", 0))
            io = (self._dev(self.comm.p2p_recv(role_key, "io", src=-1,
                                               dst=machine.mid, value=None))
                  if fused else None)
            if stage == 0:
                x = tokens
            else:
                x = io[0] if fused else self._dev(self.comm.p2p_recv(
                    role_key, "act", src=-1, dst=machine.mid, value=None))
            if stage == self.pp - 1:
                _, dp_, _ = role.fns["last_bwd"](state["params"], x, tokens)
            else:
                role.fns["fwd"](state["params"], x)
                dy = io[1] if fused else self._dev(self.comm.p2p_recv(
                    role_key, "grad", src=-1, dst=machine.mid, value=None))
                dp_, _ = role.fns["mid_bwd"](state["params"], x, dy)
            navg = self._navg()
            if self.use_flat_buffers:
                buckets = role.fns["flatten"](dp_)
                reduced = tuple(
                    self._dev(self.comm.all_reduce(role_key, "gradbucket",
                                                   [b]))
                    for b in buckets)
            else:
                leaves, td = tree_flatten(dp_)
                reduced = td.unflatten([
                    self._dev(self.comm.all_reduce(role_key, f"grad{i}",
                                                   [g]))
                    for i, g in enumerate(leaves)])
            role.fns["update"](reduced, state["opt"], navg)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            shadow_exec = time.perf_counter() - t0
            machine.warm_roles[role_key] = role
            machine.payload.setdefault("sandbox_state", state)
            self.clock.advance(self.compile_charge(role, shadow_exec),
                               f"shadow:{role_key}", lane=lane)
            return role
        finally:
            self.comm.mode = prev_mode
            self.comm.sandbox_members = prev_members

    # ------------------------------------------------------- state moves
    def get_state(self, mid: int) -> dict:
        """Host copy of a machine's (params, opt, step)."""
        m = self.cluster[mid]
        if self.use_flat_buffers:
            self._stage_params(m)               # materialize if lazy
        return to_host({k: m.payload[k] for k in ("params", "opt", "step")})

    def _as_device(self, leaf) -> torch.Tensor:
        """A state leaf as a tensor on the engine's device. The step, an
        int, becomes a 0-d int32 tensor, as jnp.asarray makes it with
        64-bit types off, so that the restored state's tree_bytes are
        the reference's."""
        if isinstance(leaf, torch.Tensor):
            return self._dev(leaf)
        return torch.tensor(int(leaf), dtype=torch.int32,
                            device=self.device)

    def set_state(self, mid: int, state: dict) -> None:
        m = self.cluster[mid]
        m.payload.update(tree_map(self._as_device, state))
        if self.use_flat_buffers:
            # params arrived in tree form; buckets rebuilt on demand
            m.payload["param_segs"] = None

    def opt_state_tree(self, d: int, s: int) -> dict:
        """Optimizer state in per-leaf tree form."""
        opt = self.machine(d, s).payload["opt"]
        if not self.use_flat_buffers:
            return opt
        spec = self.flat_spec(s)
        return {k: spec.unflatten_master(opt[k])
                for k in ("m", "v", "master")} | {"step": opt["step"]}

    def state_spec(self, stage: int) -> flatbuf.ByteSpec:
        """Byte layout of a stage's full train state (params + opt),
        shared by every DP replica of that stage."""
        if stage not in self._state_specs:
            pspec = self._stage_param_spec(stage)
            f32 = lambda n: ShapeDtype((n,), torch.float32)
            step = ShapeDtype((), torch.int32)
            if self.use_flat_buffers:
                spec = self.flat_spec(stage)
                tree = {"param_segs": tuple(ShapeDtype((g.size,), g.dtype)
                                            for g in spec.segments),
                        "opt": {"m": f32(spec.size), "v": f32(spec.size),
                                "master": f32(spec.size), "step": step}}
            else:
                as_f32 = lambda t: ShapeDtype(t.shape, torch.float32)
                tree = {"params": pspec,
                        "opt": {"m": tree_map(as_f32, pspec),
                                "v": tree_map(as_f32, pspec),
                                "master": tree_map(as_f32, pspec),
                                "step": step}}
            self._state_specs[stage] = flatbuf.ByteSpec.from_tree(tree)
        return self._state_specs[stage]

    def get_state_flat(self, mid: int) -> Tuple[np.ndarray, int]:
        """(contiguous host uint8 state buffer, step): the §8.5 transfer
        unit."""
        d, s = self.coords_of(mid)
        m = self.cluster[mid]
        if self.use_flat_buffers:
            segs = m.payload.get("param_segs")
            if segs is None:                    # tree-form restore
                segs = self.flat_spec(s).flatten(m.payload["params"])
            buf = self.state_spec(s).pack(
                {"param_segs": tuple(segs), "opt": m.payload["opt"]})
        else:
            buf = self.state_spec(s).pack({"params": m.payload["params"],
                                           "opt": m.payload["opt"]})
        return buf, int(m.payload["step"])

    def set_state_flat(self, mid: int, stage: int, buf: np.ndarray,
                       step: int) -> None:
        tree = tree_map(self._dev, self.state_spec(stage).unpack(buf))
        m = self.cluster[mid]
        if self.use_flat_buffers:
            m.payload["param_segs"] = tuple(tree["param_segs"])
            m.payload["params"] = None          # lazy: next fwd/bwd
            m.payload["_seg_stage"] = stage
        else:
            m.payload["params"] = tree["params"]
        m.payload["opt"] = tree["opt"]
        m.payload["step"] = step

    def reshard_machine(self, mid: int) -> int:
        """Re-bucket a machine's state for an intra-machine re-shard (the
        bytes stay bitwise identical). Returns the bytes re-laid."""
        _, s = self.coords_of(mid)
        buf, step = self.get_state_flat(mid)
        self.set_state_flat(mid, s, buf, step)
        return buf.nbytes

    def epoch_signature(self) -> Dict[int, int]:
        """Per-machine committed step counter across the training grid."""
        return {mid: int(self.cluster[mid].payload["step"])
                for mid in self.grid.values()}

    def swap_machine(self, leaver: int, joiner: int) -> None:
        """Replace leaver with joiner in the grid + role bookkeeping."""
        d, s = self.coords_of(leaver)
        self.grid[(d, s)] = joiner
        self._coords.pop(leaver, None)
        self._coords[joiner] = (d, s)
        for k, h in list(self.hosted.items()):
            if h == leaver:                 # the joiner inherits the rank
                self.hosted[k] = joiner
        jm, lm = self.cluster[joiner], self.cluster[leaver]
        jm.role, lm.role = lm.role, None
        jm.status = NodeStatus.TRAINING
        if lm.status != NodeStatus.DEAD:
            lm.status = NodeStatus.IDLE

    def dp_retire(self, d_gone: int) -> List[int]:
        """Degraded-mode shrink: retire DP chain `d_gone`; each of its
        ranks is hosted by a surviving same-stage replica. Returns the
        chain's still-alive machines, released to IDLE."""
        if not 0 <= d_gone < self.dp:
            raise ValueError(d_gone)
        freed: List[int] = []
        for s in range(self.pp):
            host = None
            for d in range(self.dp):
                if d != d_gone and (d, s) in self.grid:
                    host = self.grid[(d, s)]
                    break
            if host is None:
                raise RuntimeError(f"no surviving replica for stage {s}")
            mid = self.grid.pop((d_gone, s), None)
            self.hosted[(d_gone, s)] = host
            hm = self.cluster[host]
            hm.device.alloc(self.grad_buffer_bytes(s),
                            f"hosted_grad:d{d_gone}", self.clock.now)
            if mid is not None:
                self._coords.pop(mid, None)
                m = self.cluster[mid]
                for k, h in list(self.hosted.items()):
                    if h == mid and k != (d_gone, s):
                        self.hosted[k] = host
                        hm.device.alloc(self.grad_buffer_bytes(s),
                                        f"hosted_grad:d{k[0]}",
                                        self.clock.now)
                        m.device.free(f"hosted_grad:d{k[0]}",
                                      self.clock.now)
                m.role = None
                if m.status != NodeStatus.DEAD:
                    m.status = NodeStatus.IDLE
                    m.device.free("grad_buffer", self.clock.now)
                    m.device.free("train_state", self.clock.now)
                    freed.append(mid)
        return freed

    def dp_restaff(self, d: int, stage_mids: Dict[int, int]) -> None:
        """Re-grow a retired DP chain with one machine per stage."""
        for s in range(self.pp):
            host = self.hosted.pop((d, s))
            self.cluster[host].device.free(f"hosted_grad:d{d}",
                                           self.clock.now)
            mid = stage_mids[s]
            self.grid[(d, s)] = mid
            self._coords[mid] = (d, s)
            m = self.cluster[mid]
            m.status = NodeStatus.TRAINING
            m.role = Role(d, s, self.pp)

    def state_bytes(self, mid: int) -> int:
        payload = self.cluster[mid].payload
        params = payload["params"]
        if params is None:                      # still in bucket form
            params = payload["param_segs"]
        return tree_bytes({"params": params, "opt": payload["opt"]})
