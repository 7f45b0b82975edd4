"""The dry-run family (`repro_torch.launch.{specs,op_analyzer,comm_stats,
dryrun}`) against the JAX package's (`repro.launch`), and the kernel
wrappers' `meta` branches.

(a), the whole leaves of `input_specs` against the reference's, is
tests/test_torch_dryrun_specs.py.
- (b) Rank 0's block of every argument equals the reference's
  `fit_sharding(...).shard_shape(...)` on both production meshes, uneven
  dimensions included (long_500k's batch of 1), for a subset of cells;
  the reference's side runs in one subprocess forced to 512 host
  devices, which builds specs and shardings only. The dry-run's
  `mem_argument` equals the bytes of those blocks.
- (c) The port's FLOPs for the reduced GPT train step equal the
  reference's `hlo_analyzer.analyze(...).dot_flops` exactly once the
  attention term is counted as the reference counts it.
- (d) The collectives of a tp-2 train and serve step over a 1x2 fake
  group: counts and bytes derived from the code.
- (e) Each kernel's `meta` branch allocates the shapes and dtypes of its
  plain version, launches nothing and tallies its work; the analyzer's
  pointwise results have torch's own meta shapes, strides and dtypes.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import gpt as jgpt
from repro.configs.base import ShapeCfg as JShapeCfg
from repro.launch import hlo_analyzer
from repro.train import step as jstep
from repro_torch.configs import gpt as tgpt
from repro_torch.configs.base import ShapeCfg
from repro_torch.kernels import flash_attention as fa, mlstm as ml, \
    moe_gmm as gm, rglru_scan as rg, work
from repro_torch.launch import dryrun, op_analyzer
from repro_torch.launch.specs import input_specs
from repro_torch.models import registry
from repro_torch.tree import tree_leaves
from test_torch_shardings import FakeMesh

ROOT = Path(__file__).resolve().parents[1]
PROD = {"16x16": ((16, 16), ("data", "model")),
        "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# --------------------------------------------- (b) blocks, one subprocess
SUBSET = [("qwen2-moe-a2.7b", "train_4k"), ("yi-34b", "decode_32k"),
          ("recurrentgemma-2b", "long_500k"),
          ("whisper-medium", "prefill_32k"), ("xlstm-350m", "train_4k"),
          ("stablelm-1.6b", "decode_32k"),
          ("deepseek-v2-lite-16b", "prefill_32k")]
REFERENCE_BLOCKS = textwrap.dedent("""
    import json, math, sys
    import jax
    import numpy as np
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs
    from repro.train import step
    memo, specs = {}, step.param_specs
    def param_specs(cfg, mesh=None):     # once per (config, tp)
        key = (cfg, step._tp(mesh))
        if key not in memo:
            memo[key] = specs(cfg, mesh)
        return memo[key]
    step.param_specs = param_specs
    out = {}
    for arch, shape in json.loads(sys.argv[1]):
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            spec = input_specs(arch, shape, mesh)
            blocks = []
            for a, sh in zip(spec["args"], spec["in_shardings"]):
                for s, h in zip(jax.tree.leaves(a), jax.tree.leaves(sh)):
                    blocks.append([list(h.shard_shape(s.shape)),
                                   np.dtype(s.dtype).itemsize])
            out[f"{arch} {shape} {int(multi)}"] = blocks
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_blocks():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", REFERENCE_BLOCKS,
                          json.dumps(SUBSET)], env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.splitlines()[-1])


def _port_blocks(arch, shape, mesh_name):
    spec = input_specs(arch, shape, FakeMesh(*PROD[mesh_name]))
    out = []
    for a, sh in zip(spec["args"], spec["in_shardings"]):
        for s, h in zip(tree_leaves(a), tree_leaves(sh)):
            out.append([list(h.local_shape(s.shape)), s.dtype.itemsize])
    return out


@pytest.mark.parametrize("arch,shape", SUBSET)
@pytest.mark.parametrize("mesh_name", PROD)
def test_rank_blocks_are_the_references(reference_blocks, arch, shape,
                                        mesh_name):
    multi = int(mesh_name == "2x16x16")
    assert _port_blocks(arch, shape, mesh_name) == \
        reference_blocks[f"{arch} {shape} {multi}"]


@pytest.mark.parametrize("arch,shape", [("recurrentgemma-2b", "long_500k"),
                                        ("stablelm-1.6b", "decode_32k")])
def test_mem_argument_is_the_blocks_bytes(reference_blocks, arch, shape):
    """The dry-run's record on both production meshes: status ok, and
    mem_argument the bytes of the reference's rank-0 blocks (long_500k's
    batch of 1 whole on every data rank, its step over `model` alone)."""
    for multi in (False, True):
        rec = dryrun.run_cell(arch, shape, multi, collect_hlo=False)
        assert rec["status"] == "ok", rec.get("trace")
        want = sum(math.prod(s) * n for s, n in
                   reference_blocks[f"{arch} {shape} {int(multi)}"])
        assert rec["mem_argument"] == want
        assert rec["devices"] == (512 if multi else 256)
        assert ("step_mesh" in rec) == (shape == "long_500k")
        assert rec["mem_peak_bytes"] >= rec["mem_argument"]


# -------------------------------------------------------- (c) GPT FLOPs
def test_gpt_flops_match_the_references_dot_flops():
    """Reduced GPT (2 layers, d 64, 4 heads, vocab 512), batch 2, seq 64,
    RunCfg's defaults (remat). The reference's chunked attention runs its
    dots over every (q, k) pair of its chunks: 4 S^2 d a head forward
    (q k^T, p v; the forward runs twice with remat) and 8 S^2 d backward;
    the kernels' tally counts the visible pairs only and its own
    recompute, so that term is taken as the reference counts it. What
    is left is the matmul family, which must match exactly."""
    L, D, H, V, B, S = 2, 64, 4, 512, 2, 64
    jcfg = jgpt.tiny_gpt(L, D, H, V)
    run = jstep.default_run_cfg()
    assert run.attention_impl == "chunked" and run.remat
    fn = jstep.make_train_step(jcfg, run, None)
    comp = jax.jit(fn).lower(
        jstep.state_specs(jcfg, run, None),
        jstep.batch_specs(jcfg, JShapeCfg("x", "train", S, B))).compile()
    want = hlo_analyzer.analyze(comp.as_text()).dot_flops
    rec = dryrun.analyze_cell(tgpt.tiny_gpt(L, D, H, V),
                              ShapeCfg("x", "train", S, B), None)
    k = rec["kernels"]
    assert k["flash_fwd"]["calls"] == 2 * L          # forward, recompute
    assert k["flash_bwd_dq"]["calls"] == k["flash_bwd_dkdv"]["calls"] == L
    dh = D // H
    attention = (k["flash_fwd"]["calls"] * 4 + k["flash_bwd_dq"]["calls"]
                 * 8) * B * H * S * S * dh
    assert rec["matmul_flops_per_device"] + attention == want
    assert rec["flops_per_device"] == rec["matmul_flops_per_device"] + \
        sum(v["flops"] for v in k.values())


# --------------------------------------------------- (d) collectives
B, S = 4, 16


def _stablelm():
    cfg = registry.reduced_config("stablelm-1.6b")
    assert set(cfg.block_pattern) == {"attn"} and not cfg.tie_embeddings
    return cfg


def test_tp2_train_step_collectives():
    """1x2, dp 1, tp 2, remat, L layers of attention and MLP: each
    layer's forward adds the attention's and the MLP's partial sums
    (`from_model`); the recompute in the backward adds the attention's
    again, but not the MLP's (torch's checkpoint stops recomputing once
    every tensor saved for the backward is rebuilt, and the period's
    output is not one); its backward sums the gradients of their inputs
    (`to_model`): 5 all-reduces of the (B, S, D) bf16 activations a
    layer. Besides: the embedding's blocks added
    (forward) and the head's input gradient (backward), two more;
    lm_loss's max, sum of exponentials and true logit over (B, S - 1)
    f32; the loss and total summed over the data ranks and the norm's
    partial sums, f32 scalars. ZeRO-1 over a data extent of 1: no
    reduce-scatter, and one all-gather of each new parameter block whose
    Adam leaves split over `data`, in bf16."""
    cfg = _stablelm()
    L, D = cfg.num_layers, cfg.d_model
    rec = dryrun.analyze_cell(cfg, ShapeCfg("x", "train", S, B), "1x2")
    act, row, scalar = B * S * D * 2, B * (S - 1) * 4, 4
    assert rec["per_collective"]["all-reduce"] == {
        "count": 5 * L + 2 + 3 + 3,
        "bytes": 2.0 * ((5 * L + 2) * act + 3 * row + 3 * scalar)}
    spec = input_specs(cfg.name, ShapeCfg("x", "train", S, B),
                       FakeMesh((1, 2), ("data", "model")), cfg=cfg)
    params, opt = spec["args"][0]["params"], spec["in_shardings"][0]
    p_sh, m_sh = tree_leaves(opt["params"]), tree_leaves(opt["opt"]["m"])
    gathered = [(s, h) for s, h, m in zip(tree_leaves(params), p_sh, m_sh)
                if "data" in str(m.spec)]
    assert rec["per_collective"]["all-gather"] == {
        "count": len(gathered),
        "bytes": float(sum(math.prod(h.local_shape(s.shape)) * 2
                           for s, h in gathered))}
    assert set(rec["per_collective"]) == {"all-reduce", "all-gather"}


def test_tp2_serve_step_collectives():
    """1x2 decode of one token: the embedding's blocks added and each
    layer's attention and MLP partial sums, (B, 1, D) bf16 each."""
    cfg = _stablelm()
    rec = dryrun.analyze_cell(cfg, ShapeCfg("x", "decode", S, B), "1x2")
    n = 2 * cfg.num_layers + 1
    assert rec["per_collective"] == {"all-reduce": {
        "count": n, "bytes": 2.0 * n * B * cfg.d_model * 2}}
    assert rec["collective_bytes_per_device"] == \
        rec["collective_bytes_bf16eq"] == 2.0 * n * B * cfg.d_model * 2
    assert rec["mem_alias"] > 0 and rec["mem_output"] >= rec["mem_alias"]


# ------------------------------------------------- (e) meta branches
def _pair(fn, *shapes_dtypes, seed=0):
    """fn on CPU tensors and on `meta` tensors of the same shapes."""
    gen = torch.Generator().manual_seed(seed)
    cpu = [torch.randn(s, generator=gen).to(d) for s, d in shapes_dtypes]
    meta = [t.to("meta") for t in cpu]
    return fn(*cpu), fn(*meta)


def _like(a, b) -> bool:
    a, b = ([a] if isinstance(a, torch.Tensor) else list(a),
            [b] if isinstance(b, torch.Tensor) else list(b))
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and y.device.type == "meta"
        for x, y in zip(a, b))


f32, bf16 = torch.float32, torch.bfloat16
KERNELS = {
    "flash_fwd": (lambda q, k, v: fa.flash_fwd(q, k, v, True, 0.25, 3),
                  ((2, 20, 16), bf16), ((2, 20, 16), bf16),
                  ((2, 20, 16), bf16)),
    "flash_bwd": (lambda q, k, v, o, lse, do: fa.flash_bwd(
        q, k, v, o, lse, do, True, 0.2), ((2, 20, 192), f32),
        ((2, 20, 192), f32), ((2, 20, 128), f32), ((2, 20, 128), f32),
        ((2, 20), f32), ((2, 20, 128), f32)),
    "gmm_fwd": (gm.gmm_fwd, ((3, 5, 8), bf16), ((3, 8, 6), bf16)),
    "gmm_bwd_dx": (gm.gmm_bwd_dx, ((3, 5, 6), f32), ((3, 8, 6), f32)),
    "gmm_bwd_dw": (gm.gmm_bwd_dw, ((3, 5, 8), f32), ((3, 5, 6), f32)),
    "rglru_fwd": (rg.rglru_fwd, ((2, 37, 8), f32), ((2, 37, 8), bf16)),
    "rglru_bwd": (rg.rglru_bwd, ((2, 37, 8), f32), ((2, 37, 8), bf16),
                  ((2, 37, 8), bf16)),
    "mlstm_fwd": (lambda q, k, v, li, lf: ml.mlstm_fwd(q, k, v, li, lf, 16),
                  ((2, 32, 64), f32), ((2, 32, 64), f32),
                  ((2, 32, 64), f32), ((2, 32), f32), ((2, 32), f32)),
}


@pytest.mark.parametrize("name", KERNELS)
def test_meta_branch_allocates_the_plain_versions_outputs(name):
    fn, *ins = KERNELS[name]
    mods = (fa, gm, rg, ml)
    for m in mods:
        m.reset_launches()
    work.reset()
    cpu, meta = _pair(fn, *ins)
    if name == "mlstm_fwd":
        assert _like(cpu[0], meta[0]) and _like(cpu[1], meta[1])
    else:
        assert _like(cpu, meta)
    assert all(n == 0 for m in mods for n in m.LAUNCHES.values())
    assert work.TALLY and all(t["calls"] == 1 for t in work.TALLY.values())


def test_mlstm_backward_meta_allocates_the_plain_versions():
    """mlstm_bwd_dqdk (dq, dk and the dC, dn workspace), mlstm_bwd_dv and
    mlstm_bwd on `meta` give the plain passes' shapes and dtypes; the
    tally holds each kernel's work at the shape."""
    bh, s, k, chunk = 2, 32, 64, 16
    gen = torch.Generator().manual_seed(1)
    q, kk, v = (torch.randn(bh, s, k, generator=gen) for _ in range(3))
    li = torch.randn(bh, s, generator=gen)
    lf = torch.nn.functional.logsigmoid(torch.randn(bh, s, generator=gen))
    h, aux = ml.mlstm_fwd(q, kk, v, li, lf, chunk)
    dh = torch.randn(bh, s, k, generator=gen)
    cpu = ml.mlstm_bwd_dqdk(q, kk, v, li, lf, h, dh, aux, chunk)
    meta_in = [t.to("meta") for t in (q, kk, v, li, lf, h, dh)]
    meta_aux = tuple(t.to("meta") for t in aux)
    work.reset()
    meta = ml.mlstm_bwd_dqdk(*meta_in, meta_aux, chunk)
    assert _like(cpu, meta)
    assert work.TALLY["mlstm_bwd_dqdk"]["flops"] == work.mlstm_work(
        "mlstm_bwd_dqdk", bh, s, k, chunk, f32)[0]
    assert _like(ml.mlstm_bwd(q, kk, v, li, lf, h, dh, aux, chunk),
                 ml.mlstm_bwd(*meta_in, meta_aux, chunk))
    assert work.TALLY["mlstm_bwd_dv"]["calls"] == 1
    assert all(n == 0 for n in ml.LAUNCHES.values())


def test_autograd_functions_on_meta():
    """Forward and backward of each autograd.Function on `meta`: the
    gradients have their inputs' shapes and dtypes, the tally counts one
    call of every kernel."""
    m = lambda *s, dt=f32: torch.empty(*s, device="meta", dtype=dt,
                                       requires_grad=True)
    work.reset()
    q, k, v = m(4, 24, 32), m(4, 24, 32), m(4, 24, 32)
    fa.flash_attention(q, k, v).sum().backward()
    x, w = m(3, 5, 8, dt=bf16), m(3, 8, 6, dt=bf16)
    gm.grouped_matmul(x, w).sum().backward()
    a, xs = m(2, 40, 8), m(2, 40, 8, dt=bf16)
    rg.rglru_scan(a, xs).sum().backward()
    qm, km, vm, li, lf = m(2, 64, 64), m(2, 64, 64), m(2, 64, 64), \
        m(2, 64), m(2, 64)
    ml.mlstm_chunkwise(qm, km, vm, li, lf, 32).sum().backward()
    for t in (q, k, v, x, w, a, xs, qm, km, vm, li, lf):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
    assert {n: t["calls"] for n, t in work.TALLY.items()} == {
        n: 1 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv",
                       "gmm_fwd", "gmm_bwd_dx", "gmm_bwd_dw", "rglru_fwd",
                       "rglru_bwd", "mlstm_fwd", "mlstm_bwd_dqdk",
                       "mlstm_bwd_dv")}
    assert work.TALLY["flash_fwd"]["flops"] == work.attention_work(
        "flash_fwd", 4, 24, 32, f32, True, 0)[0]


_m = lambda *s, dt=f32: torch.empty(*s, device="meta", dtype=dt)
_base = _m(4, 6, 8)
POINTWISE = [
    (torch.ops.aten.mul.Tensor, (_m(4, 6, 8), _m(4, 6, 8))),
    (torch.ops.aten.mul.Tensor, (_base.transpose(0, 1), _m(6, 4, 8))),
    (torch.ops.aten.mul.Tensor, (_m(6, 4, 8), _base.transpose(0, 1))),
    (torch.ops.aten.add.Tensor, (_base.transpose(1, 2),
                                 _base.transpose(1, 2))),
    (torch.ops.aten.add.Tensor, (_m(4, 1, 8), _m(1, 6, 1))),
    (torch.ops.aten.add.Tensor, (_m(8), _base)),
    (torch.ops.aten.add.Tensor, (_base[:, ::2], _m(4, 3, 8, dt=bf16))),
    (torch.ops.aten.exp.default, (_base.permute(2, 0, 1),)),
    (torch.ops.aten.exp.default, (_base[:, :, ::2],)),
    (torch.ops.aten.exp.default, (_m(3, 4, dt=torch.int64),)),
    (torch.ops.aten.div.Tensor, (_m(3, 4, dt=torch.int64),
                                 _m(3, 4, dt=torch.int64))),
    (torch.ops.aten.eq.Tensor, (_m(3, 4), _m(4))),
    (torch.ops.aten.where.self, (_m(3, 4, dt=torch.bool), _m(3, 4),
                                 _m(1))),
    (torch.ops.aten.mul.Scalar, (_base.transpose(0, 2), 2.0)),
    (torch.ops.aten.clamp.default, (_base.transpose(0, 2), 1.0)),
    (torch.ops.aten.maximum.default, (_m(2, 4, 8)[:, :, :4],
                                      _m(2, 4, 4))),
    (torch.ops.aten.mul.Tensor, (_m(5, 1, 8), _m(5, 3, 8).transpose(
        0, 1).contiguous().transpose(0, 1))),
]


@pytest.mark.parametrize("i", range(len(POINTWISE)))
def test_pointwise_results_are_torchs_meta_results(i):
    func, args = POINTWISE[i]
    want = func(*args)
    got = op_analyzer.Pointwise()(func, args, {},
                                  [a for a in args
                                   if isinstance(a, torch.Tensor)])
    assert (got.shape, got.stride(), got.dtype) == \
        (want.shape, want.stride(), want.dtype)


def test_pointwise_leaves_copies_and_in_place_ops_to_torch():
    pw = op_analyzer.Pointwise()
    x = _base.transpose(0, 1)
    assert pw(torch.ops.aten.clone.default, (x,),
              {"memory_format": torch.contiguous_format}, [x]) is None
    assert pw(torch.ops.aten.add_.Tensor, (_m(3), _m(3)), {},
              [_m(3), _m(3)]) is None
    assert pw(torch.ops.aten.mm.default, (_m(3, 4), _m(4, 5)), {},
              [_m(3, 4), _m(4, 5)]) is None


def test_peak_tracks_frees():
    """The live total follows each storage from the op that makes it to
    its last tensor's death, allocator-rounded."""
    arg = torch.empty(1000, device="meta")
    with op_analyzer.analyze([arg]) as an:
        a = torch.empty(300, device="meta")         # 1200 B -> 1536
        b = a[10:]                                  # a view: no storage
        del a
        c = torch.empty(2000, device="meta")        # 8000 B
        del b, c
        d = arg * 2.0
    assert an.argument_bytes == 4096
    assert an.peak_bytes == 4096 + 1536 + 8192
    assert d.shape == arg.shape
