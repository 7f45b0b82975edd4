"""The ranks of tests/test_torch_mesh*.py: gloo meshes on the CPU, one
process per rank (it holds no tests and imports no JAX, so each rank
starts with torch alone).

`parity` runs the (case, mesh) runs that a test lists in
`<tmp>/inputs.pkl` beside the cases' weights and batches (written while
the ranks start), one gloo world over a FileStore per mesh size. The
`launcher` ranks (f32 parameters) check what a mesh refuses (prefill,
serving and decoding; MLA at a tp that does not divide its heads) and
that every architecture's train step builds under one, the launcher's resume
from a (2, 1) checkpoint onto (1, 2), FSDP (REPRO_FSDP=1) at (2, 1),
the loss over split rows and a split vocabulary, and that a mesh of one
shape is made once per process group. Each rank pickles what it found
into `<tmp>/rank<world>_<rank>.pkl`; `start` and `finish` are the
test's side.
"""
import dataclasses
import math
import os
import pickle
import time

import torch
import torch.distributed as dist

from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import backbone, registry
from repro_torch.models.shardings import (resolve, shard, sum_over_batch,
                                          whole)
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import step
from repro_torch.tree import tree_leaves

ADAM = dict(lr=1e-3, warmup_steps=2)


def config(cfg, cuts=None):
    """`cfg` (the JAX package's or the port's) with the fields of its
    sub-configs that `cuts` names replaced, e.g. {"moe": {"num_experts":
    7}}."""
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v)
                          for k, v in (cuts or {}).items()})


def _case(inputs: dict, name: str, mesh) -> dict:
    """One model on one mesh, from the reference's weights: the forward's
    whole logits, one train step's stats (the loss with the aux loss)
    and whole parameters, and the local blocks' shapes against
    state_shardings'."""
    case = inputs[name]
    cfg = config(registry.reduced_config(case["arch"]), case["cuts"])
    tp = mesh.shape[-1]
    params = params_from_numpy(case["params"], "cpu")
    run = step.RunCfg(adam=step.AdamCfg(**ADAM), param_dtype=torch.float32)
    whole_state = {"params": params, "opt": opt_mod.init_opt_state(params)}
    state = step.shard_state(whole_state, cfg, mesh, "cpu")
    batch = {k: case[k] for k in ("tokens", "frames") if k in case}
    rows = {k: shard(torch.from_numpy(v), ("batch",) + (None,) *
                     (v.ndim - 1), mesh) for k, v in batch.items()}
    logits, _ = backbone.forward(state["params"], rows.pop("tokens").long(),
                                 cfg, tp, mesh, **rows)
    logits = whole(logits, resolve(("batch", None, "vocab"), mesh), mesh)
    state, stats = step.make_train_step(cfg, run, mesh, device="cpu")(
        state, batch)
    sh = step.state_shardings(cfg, mesh)
    specs = step.state_specs(cfg, run, mesh)
    blocks = {}
    for part in ("params", "m", "v", "master"):
        tree = state["params"] if part == "params" else state["opt"][part]
        s_tree = sh["params"] if part == "params" else sh["opt"][part]
        p_tree = specs["params"] if part == "params" else \
            specs["opt"][part]
        got = [tuple(t.shape) for t in tree_leaves(tree)]
        want = [s.local_shape(p.shape) for s, p in
                zip(tree_leaves(s_tree), tree_leaves(p_tree))]
        blocks[part] = (got == want, sum(map(math.prod, got)),
                        sum(math.prod(p.shape) for p in tree_leaves(p_tree)))
    new = [s.whole(t).numpy() for t, s in
           zip(tree_leaves(state["params"]), tree_leaves(sh["params"]))]
    return {"logits": logits.detach().numpy(),
            "loss": float(stats["total_loss"]),
            "grad_norm": float(stats["grad_norm"]), "blocks": blocks,
            "params": new}


def _refusals(world: int) -> dict:
    """What a mesh refuses: a size other than the world's, prefill,
    serving and decoding (NotImplementedError), MLA at a tp that does
    not divide its heads and a batch that the data ranks do not divide
    (ValueError); and under "trains" the architectures whose train step
    builds under a mesh."""
    out = {}
    try:
        launch.main(LAUNCHER + ["--mesh", f"{world}x1", "--steps", "1",
                                "--batch", str(world + 1)])
        out["batch"] = None
    except ValueError as e:
        out["batch"] = str(e)
    try:
        make_production_mesh(f"1x{world // 2}", "cpu")
        out["size"] = None
    except ValueError as e:
        out["size"] = str(e)
    mesh = make_production_mesh(f"1x{world}", "cpu")
    run = step.RunCfg()
    cfg = registry.reduced_config("whisper-medium")
    calls = {
        "make_prefill_step": lambda: step.make_prefill_step(
            cfg, run, mesh, device="cpu"),
        "make_serve_step": lambda: step.make_serve_step(cfg, mesh,
                                                        device="cpu"),
        "decode_step": lambda: backbone.decode_step(None, None, None, cfg,
                                                    mesh=mesh),
        "setup_cross_cache": lambda: backbone.setup_cross_cache(
            None, None, None, cfg, mesh=mesh)}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    mla = registry.reduced_config("deepseek-v2-lite-16b").replace(
        num_heads=world + 1)
    try:
        step.make_train_step(mla, run, mesh, device="cpu")
        out["mla"] = None
    except ValueError as e:
        out["mla"] = str(e)
    out["trains"] = [arch for arch in TRAINS if step.make_train_step(
        registry.reduced_config(arch), run, mesh, device="cpu")]
    return out


# an architecture of each block type
TRAINS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "xlstm-350m",
          "whisper-medium", "recurrentgemma-2b", "stablelm-1.6b")


LAUNCHER = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--log-every", "1"]


def f32_run_cfg() -> step.RunCfg:
    """The launcher's run config with f32 parameters (the tests' runs
    put it in place of `step.default_run_cfg`)."""
    return step.RunCfg(param_dtype=torch.float32)


def _stats(history) -> list:
    return [(h["loss"], h["grad_norm"]) for h in history]


def _launcher(tmp: str) -> list:
    """Two steps at --mesh 2x1 with a checkpoint, then resumed to four at
    --mesh 1x2: every step's loss and grad norm."""
    ckpt = ["--ckpt-every", "2", "--ckpt-dir", os.path.join(tmp, "ck")]
    first = launch.main(LAUNCHER + ckpt + ["--mesh", "2x1", "--steps", "2"])
    second = launch.main(LAUNCHER + ckpt + ["--mesh", "1x2", "--steps", "4",
                                            "--resume"])
    return _stats(first + second)


def _fsdp() -> dict:
    """With REPRO_FSDP=1 at --mesh 2x1: two launcher steps, and whether
    every parameter's block is its FSDP sharding's (split over data)."""
    os.environ["REPRO_FSDP"] = "1"
    try:
        history = launch.main(LAUNCHER + ["--mesh", "2x1", "--steps", "2"])
        mesh = make_production_mesh("2x1", "cpu")
        cfg = registry.reduced_config("stablelm-1.6b")
        state = step.init_state(cfg, step.RunCfg(), mesh=mesh, device="cpu")
        sh = step.state_shardings(cfg, mesh)["params"]
        specs = step.param_specs(cfg, mesh)
        got = [tuple(t.shape) for t in tree_leaves(state["params"])]
        want = [s.local_shape(p.shape) for s, p in
                zip(tree_leaves(sh), tree_leaves(specs))]
        whole_numel = sum(math.prod(p.shape) for p in tree_leaves(specs))
    finally:
        del os.environ["REPRO_FSDP"]
    return {"stats": _stats(history), "blocks": got == want,
            "local": sum(map(math.prod, got)), "whole": whole_numel}


def _masked_loss() -> dict:
    """lm_loss on every split of a world of two, with a mask whose counts
    differ between the ranks' rows: by mesh, the ranks' shares summed
    over the data axes, the loss of the whole batch with no mesh, and
    the mean of per-rank means (what the shares must not be)."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 8, 16, generator=g)
    tokens = torch.randint(0, 16, (4, 8), generator=g)
    mask = torch.zeros(4, 8, dtype=torch.bool)
    mask[:2] = True
    mask[2:, :3] = True
    out = {"plain": float(backbone.lm_loss(logits, tokens, mask)),
           "means": float((backbone.lm_loss(logits[:2], tokens[:2],
                                            mask[:2]) +
                           backbone.lm_loss(logits[2:], tokens[2:],
                                            mask[2:])) / 2)}
    for name in ("2x1", "1x2"):
        mesh = make_production_mesh(name, "cpu")
        rows = lambda t: shard(t, ("batch",) + (None,) * (t.dim() - 1),
                               mesh)
        share = backbone.lm_loss(
            shard(logits, ("batch", None, "vocab"), mesh), rows(tokens),
            rows(mask), mesh)
        out[name] = float(sum_over_batch(share, mesh))
    return out


def _world(tmp: str, rank: int, world: int, work) -> None:
    """`work(world)` in a gloo world of `world` ranks; its dict pickled."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"),
                                     world), rank=rank, world_size=world)
    try:
        out = work(world)
        with open(os.path.join(tmp, f"rank{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _inputs(tmp: str, timeout: float = 300.0) -> dict:
    """The test's weights and batches, once it has written them."""
    path = os.path.join(tmp, "inputs.pkl")
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(path)
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def parity(rank: int, tmp: str) -> None:
    """One rank of tests/test_torch_mesh*.py: the runs that
    `<tmp>/inputs.pkl` lists as (case, mesh), world by world from the
    largest, each world on as many of the spawned ranks as it needs."""
    torch.set_num_threads(1)
    inputs = _inputs(tmp)
    worlds = {}
    for name, mesh in inputs["runs"]:
        worlds.setdefault(math.prod(map(int, mesh.split("x"))), []).append(
            (name, mesh))
    for world in sorted(worlds, reverse=True):
        if rank < world:
            _world(tmp, rank, world, lambda w: {
                f"{name} {mesh}": _case(inputs, name,
                                        make_production_mesh(mesh, "cpu"))
                for name, mesh in worlds[w]})


def _meshes() -> dict:
    """Whether a second mesh of one shape in the process group is the
    first (its process groups made once), and one of another shape is
    not."""
    one = make_production_mesh("1x2", "cpu")
    return {"same": make_production_mesh("1x2", "cpu") is one,
            "other": make_production_mesh("2x1", "cpu") is not one}


def launcher(rank: int, tmp: str) -> None:
    """One rank of tests/test_torch_mesh_launcher.py."""
    torch.set_num_threads(1)
    step.default_run_cfg = f32_run_cfg
    _world(tmp, rank, 2, lambda world: {"refusals": _refusals(world),
                                        "launcher": _launcher(tmp),
                                        "fsdp": _fsdp(),
                                        "loss": _masked_loss(),
                                        "meshes": _meshes()})


# ------------------------------------------------------ the test's side
def start(fn, tmp, nprocs: int):
    """`fn(rank, tmp)` started on `nprocs` spawned ranks."""
    import torch.multiprocessing as mp
    return mp.start_processes(fn, args=(str(tmp),), nprocs=nprocs,
                              start_method="spawn", join=False)


def finish(ctx, tmp, worlds, timeout: float = 300.0) -> dict:
    """Wait for the ranks (a rank's failure raises here), stop any left,
    and read what each rank of each world size in `worlds` pickled."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError("mesh ranks timed out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    got = {}
    for world in worlds:
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{world}_{rank}.pkl"),
                      "rb") as f:
                got[world, rank] = pickle.load(f)
    return got
