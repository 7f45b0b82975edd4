"""Multi-pod dry-run (counterpart of `repro/launch/dryrun.py`): run each
(arch x shape x mesh) cell's real step function once, as rank 0 of a
fake process group the size of the production mesh, on `meta` tensors,
and record what one device would hold and do.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/

The reference lowers and compiles each cell over 512 forced host
devices; the port has no compiler to ask. Here one process, with no
card and no spawn, inits `torch.distributed` with the "fake" backend
(`torch.testing._internal.distributed.fake_pg`: collectives return at
once) at 256 or 512 ranks, makes the 16x16 or 2x16x16 mesh
(`launch/mesh.py`), builds rank 0's blocks of every argument directly
on `meta` (`specs.input_specs`, each leaf's fitted sharding's
`local_shape`; nothing whole is drawn) and runs the step once under
`op_analyzer.analyze` and `comm_stats.Collectives`. The kernel wrappers'
`meta` branches allocate what their CUDA paths allocate and launch
nothing. Running on `meta` is this tool's own device: every other entry
point runs on the card by default.

Where a cell's global batch does not split over the data ranks
(long_500k's batch of 1), the batch is whole on every data rank, as the
reference's fitted shardings leave it; the step then runs over the
mesh's `model` axis alone ("1xM", `step_mesh` in the record), which is
what each data rank of the production mesh does.

The record, one JSON line per cell. Each field is named for what it
counts; the reference's field it replaces is in brackets:
- status (ok | skipped | error), reason, error, trace; devices;
- build_s [lower_s]: specs, shardings, blocks and the step built;
  run_s [compile_s, analyze_s]: the step's one run under the analyzers;
- flops_per_device [xla_flops_per_device]: matmul_flops_per_device
  [hlo_dot_flops_per_device] (FlopCounterMode) plus
  kernel_flops_per_device (the kernels' tally, `kernels/work.py`);
- bytes_per_device_unfused [xla_bytes_per_device]: every computing op's
  operands and results once, no fusion, plus the kernels' bytes;
  kernels: each hand-written kernel's calls, FLOPs and bytes;
- mem_argument: the exact bytes of rank 0's blocks of every argument
  (the batch's: its rows); mem_output: of the step's results; mem_alias:
  of the results that are arguments updated in place (the train step's
  state, the serve step's cache); mem_temp: the tracked peak beyond the
  device-resident arguments (allocator-rounded); mem_peak_bytes: that
  peak, arguments included, plus the fixed cuBLAS workspace
  (CUBLAS_WORKSPACE_BYTES); mem_per_device_gib of it;
- fits_h100_hbm [fits_16g_hbm]: mem_peak_bytes within H100_HBM_BYTES;
- collective_bytes_per_device, per_collective: `comm_stats`, under the
  reference's kind names and multipliers; collective_bytes_bf16eq: the
  same number (the reference halves its f32 collectives fed by upcasts
  on XLA:CPU; the port's collectives run in their own dtype);
- the reference's while_trips has no counterpart (`op_analyzer`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, ShapeCfg, cell_supported
from repro_torch.launch import comm_stats, op_analyzer
from repro_torch.launch.mesh import make_mesh, parse_mesh
from repro_torch.launch.specs import input_specs, step_fn_for
from repro_torch.models import registry
from repro_torch.train import step as step_mod
from repro_torch.tree import ShapeDtype, tree_leaves, tree_map

# an NVIDIA H100 80GB HBM3's torch.cuda.get_device_properties(0)
# .total_memory, as chip_smoke.py's phase 15 reads it from the card
H100_HBM_BYTES = 85_017_493_504
# cuBLAS's fixed workspace under deterministic_cuda()'s
# CUBLAS_WORKSPACE_CONFIG=":4096:8": 8 buffers of 4096 KiB
CUBLAS_WORKSPACE_BYTES = 8 * 4096 * 1024
PRODUCTION = {False: "16x16", True: "2x16x16"}


@contextlib.contextmanager
def fake_process_group(world: int):
    """Rank 0 of a fake process group of `world` ranks, destroyed on
    the way out (a later caller gets no mesh of it: `make_mesh` keys
    its meshes by the live group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry-run runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _per_block(fn, specs, shardings):
    """fn(leaf, the shape of rank 0's block of it) at every leaf (the
    whole leaf where `shardings` is None)."""
    if shardings is None:
        return tree_map(lambda s: fn(s, s.shape), specs)
    return tree_map(lambda s, sh: fn(s, sh.local_shape(s.shape)), specs,
                    shardings)


def _blocks(specs, shardings):
    """Rank 0's block of every leaf, on `meta`."""
    return _per_block(lambda s, shape: torch.empty(
        shape, dtype=s.dtype, device="meta"), specs, shardings)


def _host(specs):
    """Host tensors of the whole leaves (the batch and tokens a caller
    hands the step; the step moves them to its device)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype), specs)


def _nbytes(specs, shardings) -> int:
    """Exact bytes of rank 0's blocks of a tree."""
    return sum(tree_leaves(_per_block(
        lambda s, shape: math.prod(shape) * s.dtype.itemsize, specs,
        shardings)))


def _with_dtype(specs, dtype):
    """The floating leaves of a ShapeDtype tree in `dtype`."""
    if dtype is None:
        return specs
    return tree_map(lambda s: ShapeDtype(s.shape, dtype)
                    if s.dtype.is_floating_point else s, specs)


def single_device_specs(cfg, shape: ShapeCfg) -> dict:
    """input_specs' kind, cfg, run, args and in_shardings (None) for one
    device with no mesh (the launcher's `--mesh none`, the serve path of
    one card)."""
    run = step_mod.default_run_cfg()
    if shape.kind == "train":
        return dict(kind="train", cfg=cfg, run=run,
                    args=(step_mod.state_specs(cfg, run),
                          step_mod.batch_specs(cfg, shape)),
                    in_shardings=None)
    params = step_mod.param_specs(cfg)
    if shape.kind == "prefill":
        return dict(kind="prefill", cfg=cfg, run=run,
                    args=(params, step_mod.batch_specs(cfg, shape)),
                    in_shardings=None)
    return dict(kind="decode", cfg=cfg, run=run,
                args=(params, step_mod.cache_specs(cfg, shape),
                      ShapeDtype((shape.global_batch, 1), torch.int32)),
                in_shardings=None)


def _run_step(spec: dict, mesh, collect: bool) -> dict:
    """The step once on `meta` under the analyzers; returns the record's
    measured fields."""
    from torch.distributed.tensor.debug import CommDebugMode
    t0 = time.perf_counter()
    kind, args = spec["kind"], spec["args"]
    shardings = spec["in_shardings"] or (None,) * len(args)
    # what lives on the device before the step: the state, the params,
    # the cache; the batch and tokens come from the host
    host = {"train": (1,), "prefill": (1,), "decode": (2,)}[kind]
    call = tuple(_host(a) if i in host else _blocks(a, sh)
                 for i, (a, sh) in enumerate(zip(args, shardings)))
    fn = step_fn_for(spec, mesh, device="meta")
    resident = [a for i, a in enumerate(call) if i not in host]
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    coll = comm_stats.Collectives()
    with contextlib.ExitStack() as stack:
        an = stack.enter_context(op_analyzer.analyze(resident))
        if collect:
            cdm = stack.enter_context(CommDebugMode())
            stack.enter_context(coll)
        out = fn(*call)
    run_s = time.perf_counter() - t0
    if collect:
        coll.check(cdm)
    argument_ids = {id(t.untyped_storage()) for t in tree_leaves(resident)}
    seen, mem_output, mem_alias = set(), 0, 0
    for t in tree_leaves(out):
        if not isinstance(t, torch.Tensor) or \
                id(t.untyped_storage()) in seen:
            continue
        seen.add(id(t.untyped_storage()))
        mem_output += t.untyped_storage().nbytes()
        if id(t.untyped_storage()) in argument_ids:
            mem_alias += t.untyped_storage().nbytes()
    peak = an.peak_bytes + CUBLAS_WORKSPACE_BYTES
    rec = dict(
        build_s=round(build_s, 2), run_s=round(run_s, 2),
        mem_argument=sum(_nbytes(a, sh) for a, sh in zip(args, shardings)),
        mem_output=mem_output, mem_temp=an.peak_bytes - an.argument_bytes,
        mem_alias=mem_alias, mem_peak_bytes=peak,
        mem_per_device_gib=round(peak / 2 ** 30, 3),
        fits_h100_hbm=bool(peak <= H100_HBM_BYTES))
    if collect:
        rec.update(
            flops_per_device=an.flops,
            matmul_flops_per_device=an.matmul_flops,
            kernel_flops_per_device=an.kernel_flops,
            bytes_per_device_unfused=an.bytes,
            kernels=an.kernels,
            collective_bytes_per_device=coll.total_bytes,
            collective_bytes_bf16eq=coll.total_bytes,
            per_collective={k: v for k, v in coll.stats.items()
                            if v["count"]})
    return rec


def step_mesh_name(shape: ShapeCfg, mesh_name: str) -> str:
    """The mesh the step runs over: the production mesh, or its `model`
    axis alone where the global batch does not split over the data
    ranks (see the module's docstring)."""
    dims, _ = parse_mesh(mesh_name)
    dp = math.prod(dims[:-1])
    return mesh_name if shape.global_batch % dp == 0 else f"1x{dims[-1]}"


def analyze_cell(cfg, shape: ShapeCfg, mesh_name, collect: bool = True,
                 param_dtype=None, cache_dtype=None) -> dict:
    """One cell's measured fields: `cfg` at `shape` on the mesh named
    `mesh_name` ("16x16", "2x16x16", any "DxT"), or on one device with
    no mesh (None). `param_dtype` and `cache_dtype` replace the
    parameters' and the decode cache's floating dtypes (bf16 by default,
    as in the reference's specs)."""
    def fix(spec):
        args = list(spec["args"])
        if spec["kind"] != "train":
            args[0] = _with_dtype(args[0], param_dtype)
        if spec["kind"] == "decode":
            args[1] = _with_dtype(args[1], cache_dtype)
        spec["args"] = tuple(args)
        return spec

    if mesh_name is None:
        return {"devices": 1, **_run_step(
            fix(single_device_specs(cfg, shape)), None, collect)}
    dims, axes = parse_mesh(mesh_name)
    rec = {"devices": math.prod(dims)}
    run_on = step_mesh_name(shape, mesh_name)
    with fake_process_group(rec["devices"]):
        mesh = make_mesh(dims, axes, device_type="cpu")
        spec = fix(input_specs(cfg.name, shape, mesh, cfg=cfg))
        mem_argument = sum(_nbytes(a, sh) for a, sh in
                           zip(spec["args"], spec["in_shardings"]))
        if run_on == mesh_name:
            rec.update(_run_step(spec, mesh, collect))
    if run_on != mesh_name:
        rec["step_mesh"] = run_on
        dims, axes = parse_mesh(run_on)
        with fake_process_group(math.prod(dims)):
            mesh = make_mesh(dims, axes, device_type="cpu")
            rec.update(_run_step(fix(input_specs(cfg.name, shape, mesh,
                                                 cfg=cfg)), mesh, collect))
    rec["mem_argument"] = mem_argument
    return rec


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             collect_hlo: bool = True) -> dict:
    """One cell's record on the 16x16 (or, with `multi_pod`, 2x16x16)
    mesh; `collect_hlo` False skips the op and comm analysis."""
    mesh_name = PRODUCTION[multi_pod]
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name}
    cfg = registry.get_config(arch_id)
    ok, why = cell_supported(cfg, SHAPES[shape_name])
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    try:
        rec.update(analyze_cell(cfg, SHAPES[shape_name], mesh_name,
                                collect=collect_hlo))
        rec["status"] = "ok"
    except Exception as e:                        # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-1800:])
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the op and comm analysis")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if (args.all or args.arch is None) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    n_ok = n_skip = n_err = 0
    t_all = time.perf_counter()
    with open(args.out, "a") as f:
        for a, s, m in cells:
            rec = run_cell(a, s, m, collect_hlo=not args.no_hlo)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            tag = rec["status"].upper()
            n_ok += tag == "OK"
            n_skip += tag == "SKIPPED"
            n_err += tag == "ERROR"
            extra = ""
            if rec["status"] == "ok":
                extra = (f" run={rec['run_s']}s "
                         f"mem={rec['mem_per_device_gib']}GiB "
                         f"TF={rec.get('flops_per_device', 0) / 1e12:.2f} "
                         f"collGB="
                         f"{rec.get('collective_bytes_per_device', 0) / 2 ** 30:.2f}")
            elif rec["status"] == "error":
                extra = " " + rec["error"][:160]
            print(f"[{tag:7s}] {a:22s} {s:12s} {rec['mesh']:8s}{extra}",
                  flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} error={n_err} in "
          f"{time.perf_counter() - t_all:.1f} s")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
