"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. card: name and power limit, torch and CUDA versions, kernel build;
  2. kernels: every CUDA kernel of the main path against its plain
     PyTorch version on the card (tolerances below), bitwise repeats,
     and times: the kernel, the plain version, and
     scaled_dot_product_attention as a yardstick only (the port never
     calls it);
  3. reference: the engine on the card against the same engine on the
     CPU (plain versions) at the campaign's tiny GPT;
  4. slice: PipelineEngine trains GPT-medium at full width (24 layers,
     d_model 1024, 16 x 64 heads, d_ff 4096, vocab 50304, f32 params)
     over dp=2 x pp=2, 2 micro-batches, global batch 8, seq 2048:
     setup, record_iteration, 3 x train_iteration, twice with the same
     seed (losses must be bitwise equal), with the kernels' launch
     counts zeroed just before the first run and read just after it.
The last lines are a JSON line per kernel result, the card line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch

ROOT = Path(__file__).resolve().parent
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:24"
F32_FWD_TOL, F32_GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# the main path's attention: GPT-medium, micro-batch 2, seq 2048
SLICE = dict(bh=2 * 16, s=2048, d=64, dtype=torch.float32, causal=True)
KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median of `reps` launches, each between two CUDA events, after
    two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_work(name, bh, s, d, dtype, causal):
    """(FLOPs, bytes) the function needs at this shape: only the
    unmasked (q, k) pairs count; each input read once, each output
    written once."""
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    el = torch.tensor([], dtype=dtype).element_size()
    tile = bh * s * d * el
    lse = bh * s * 4
    if name == "flash_fwd":          # QK^T, PV; reads q,k,v; writes o,lse
        return 4 * d * pairs, 3 * tile + tile + lse
    if name == "flash_bwd_dkdv":     # S, dP, dV, dK; reads q,k,v,o,dO,lse
        return 8 * d * pairs + 2 * bh * s * d, 5 * tile + lse + 2 * tile
    return 6 * d * pairs + 2 * bh * s * d, 5 * tile + lse + tile   # dq


def bound(name, **shape):
    flops, nbytes = attention_work(name, **shape)
    t_ops = flops / PEAK_FLOPS[shape["dtype"]]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(fa):
    """Every kernel against its plain version; returns the slice-shape
    results by kernel name."""
    cases = [dict(SLICE),
             dict(bh=8, s=256, d=16, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=32, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=128, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=64, dtype=torch.float32, causal=False),
             dict(bh=4, s=200, d=64, dtype=torch.float32, causal=True),
             dict(bh=8, s=32, d=16, dtype=torch.float32, causal=True),
             dict(SLICE, dtype=torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for c in cases:
        bh, s, d, dt, causal = c["bh"], c["s"], c["d"], c["dtype"], \
            c["causal"]
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .to(dt) for _ in range(4))
        sc = d ** -0.5
        o, lse = fa.flash_fwd(q, k, v, causal, sc)
        grads = fa.flash_bwd(q, k, v, o, lse, do, causal, sc)
        torch.cuda.synchronize()
        ro, rlse = fa.attention_fwd_ref(q, k, v, causal, sc)
        rgrads = fa.attention_bwd_ref(q, k, v, o, lse, do, causal, sc)
        err = lambda a, b: (a.float() - b.float()).abs().max().item()
        errs = {"flash_fwd": max(err(o, ro), err(lse, rlse)),
                "flash_bwd_dkdv": max(err(grads[1], rgrads[1]),
                                      err(grads[2], rgrads[2])),
                "flash_bwd_dq": err(grads[0], rgrads[0])}
        o2, lse2 = fa.flash_fwd(q, k, v, causal, sc)
        grads2 = fa.flash_bwd(q, k, v, o, lse, do, causal, sc)
        repeat = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
            torch.equal(a, b) for a, b in zip(grads, grads2))
        f32 = dt == torch.float32
        tols = {"flash_fwd": F32_FWD_TOL if f32 else BF16_TOL,
                "flash_bwd_dkdv": F32_GRAD_TOL if f32 else BF16_TOL,
                "flash_bwd_dq": F32_GRAD_TOL if f32 else BF16_TOL}
        ok = repeat and all(errs[n] <= tols[n] for n in KERNELS)
        label = (f"bh={bh} s={s} d={d} {str(dt)[6:]} "
                 f"{'causal' if causal else 'full'}")
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (tol {tols[n]:g})" for n in KERNELS)
            + f", bitwise repeat {repeat}", flush=True)
        if not ok:
            raise SystemExit(f"kernel check failed at {label}")
        if c == SLICE:
            results = {n: {"max_abs_err": errs[n]} for n in KERNELS}
            time_slice(fa, results, q, k, v, do, o, lse, sc)
    return results


def time_slice(fa, results, q, k, v, do, o, lse, sc):
    causal, reps = SLICE["causal"], 10
    fwd = lambda: fa.flash_fwd(q, k, v, causal, sc)
    dkdv_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr())
    dk, dv, dq = (torch.empty_like(q) for _ in range(3))
    common = (SLICE["bh"], SLICE["s"], SLICE["d"], 0, int(causal), sc)
    results["flash_fwd"]["ms"] = time_ms(fwd, reps)
    results["flash_bwd_dkdv"]["ms"] = time_ms(lambda: fa.launch(
        "flash_bwd_dkdv", *dkdv_args, dk.data_ptr(), dv.data_ptr(),
        *common, device=q.device), reps)
    results["flash_bwd_dq"]["ms"] = time_ms(lambda: fa.launch(
        "flash_bwd_dq", *dkdv_args, dq.data_ptr(), *common,
        device=q.device), reps)
    results["flash_fwd"]["plain_ms"] = time_ms(
        lambda: fa.attention_fwd_ref(q, k, v, causal, sc), reps)
    plain_bwd = time_ms(
        lambda: fa.attention_bwd_ref(q, k, v, o, lse, do, causal, sc), reps)
    # the plain backward computes dq, dk and dv in one pass
    results["flash_bwd_dkdv"]["plain_ms"] = plain_bwd
    results["flash_bwd_dq"]["plain_ms"] = plain_bwd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["flash_fwd"]["library_ms"] = time_ms(
        lambda: sdpa(q, k, v, is_causal=causal, scale=sc), reps)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = sdpa(ql, kl, vl, is_causal=causal, scale=sc)
    # SDPA's backward yields dq, dk and dv from one call
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do, retain_graph=True), reps)
    results["flash_bwd_dkdv"]["library_ms"] = lib_bwd
    results["flash_bwd_dq"]["library_ms"] = lib_bwd
    for n in KERNELS:
        results[n]["bound_ms"], results[n]["bound_by"] = bound(n, **SLICE)
        print(f"  {n} at the slice shape: {results[n]['ms']:.3f} ms, "
              f"plain {results[n]['plain_ms']:.3f} ms, library "
              f"{results[n]['library_ms']:.3f} ms, bound "
              f"{results[n]['bound_ms']:.3f} ms ({results[n]['bound_by']})",
              flush=True)


def ptxas_summary(log: str):
    """One line per kernel instance: registers and spill bytes (ptxas
    prints the spill line of an entry before its register count)."""
    name, spills, out = None, "?", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(fwd_kernel|bwd_dkdv_kernel|bwd_dq_kernel)I"
                      r"(f|13__nv_bfloat16)Li(\d+)E", line)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)}<{dt}, {m.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, spill stores/"
                       f"loads {spills}")
            name = None
    return out


def profile_step(eng, step_s: float):
    """Device time by kernel over one train_iteration, from the
    profiler's CUDA events. The idle share is taken against `step_s`,
    the same step's wall time measured without the profiler (its host
    overhead stretches the profiled wall, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.train_iteration()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    busy = sum(by_name.values())
    if not busy:
        print("  profiler: no device time recorded; breakdown not "
              "measured", flush=True)
        return
    groups = {"attention kernels": 0.0, "matmul (cuBLAS)": 0.0,
              "other": 0.0}
    for n, us in by_name.items():
        if re.search(r"fwd_kernel|bwd_dkdv_kernel|bwd_dq_kernel", n):
            groups["attention kernels"] += us
        elif re.search(r"gemm|sm90_xmma|cutlass", n, re.I):
            groups["matmul (cuBLAS)"] += us
        else:
            groups["other"] += us
    print(f"  profiled train_iteration: device busy {busy / 1e3:.1f} ms; "
          f"wall {wall_us / 1e3:.1f} ms with the profiler on, "
          f"{step_s * 1e3:.1f} ms without; idle share "
          f"{1 - busy / (step_s * 1e6):.3f}", flush=True)
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.1f} ms ({us / busy:.3f} of busy)")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {us / 1e3:9.1f} ms  {n[:110]}")


def build_engine(cfg, device, seed=0, dp=2, pp=2, batch=8, seq=32):
    from repro_torch.cluster.node import Cluster
    from repro_torch.cluster.simclock import SimClock
    from repro_torch.core.engine import PipelineEngine
    from repro_torch.core.sandbox import CommHooks
    clock = SimClock()
    eng = PipelineEngine(cfg, dp, pp, batch, seq,
                         Cluster(dp * pp, device_capacity=80 * 2 ** 30),
                         clock, CommHooks(clock), micro_batches=2,
                         seed=seed, sim_compile_seconds=1.0, device=device)
    eng.setup(list(range(dp * pp)))
    return eng


def check_reference():
    """The card's engine (kernels) against the CPU engine (plain
    versions) at the campaign's tiny GPT: same seed, same weights."""
    from repro_torch.configs.gpt import tiny_gpt
    cfg = tiny_gpt(layers=4, d=64, heads=4, vocab=256)
    losses = {}
    for dev in ("cuda", "cpu"):
        eng = build_engine(cfg, dev)
        eng.record_iteration()
        for _ in range(2):
            eng.train_iteration()
        losses[dev] = eng.losses
    diff = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"  tiny GPT losses cuda {losses['cuda']} cpu {losses['cpu']} "
          f"max diff {diff:.3e} (tol 1e-4)", flush=True)
    if not (all(map(math.isfinite, losses["cuda"])) and diff <= 1e-4):
        raise SystemExit("card engine disagrees with the CPU engine")


def run_slice(fa, layers: int, count: bool):
    from repro_torch.configs.gpt import GPT_MEDIUM
    cfg = GPT_MEDIUM.replace(num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    if count:
        fa.reset_launches()
    t0 = time.perf_counter()
    eng = build_engine(cfg, "cuda", dp=2, pp=2, batch=8, seq=2048)
    torch.cuda.synchronize()
    print(f"  setup {time.perf_counter() - t0:.2f} s", flush=True)
    steps = []
    for i in range(4 if count else 3):
        t0 = time.perf_counter()
        if i == 0:
            eng.record_iteration()
        else:
            eng.train_iteration()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    if not count:       # the last iteration of the repeat run, profiled
        profile_step(eng, steps[-1])
    print(f"  step wall s (record, then train): "
          f"{[round(t, 4) for t in steps]}", flush=True)
    print(f"  losses {eng.losses}", flush=True)
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"SimClock train lane {eng.clock.lane_total('train')} s",
          flush=True)
    losses = list(eng.losses)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return losses, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.libraries()
    print(f"[card] kernel library built in {libs.seconds:.2f} s "
          f"(loaded after {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in ptxas_summary(libs.log.get("flash_attention", "")):
        print(f"  ptxas: {line}")

    print("[kernels] against the plain versions", flush=True)
    results = check_kernels(fa)

    print("[reference] card engine against the CPU engine", flush=True)
    check_reference()

    layers = 24
    print(f"[slice] GPT-medium, {layers} layers, dp=2 pp=2 mb=2 "
          f"batch 8 seq 2048", flush=True)
    losses, launches = run_slice(fa, layers, count=True)
    print(f"  launches in the main path: {launches}", flush=True)
    per = layers // 2           # layers per stage, pp=2
    # per (replica, micro-batch): stage 0 fwd + its mid_bwd recompute,
    # stage 1 once in last_bwd; 4 iterations x 2 replicas x 2 mbs
    calls = 4 * 2 * 2
    want = {"flash_fwd": calls * 3 * per,
            "flash_bwd_dkdv": calls * 2 * per,
            "flash_bwd_dq": calls * 2 * per}
    if not all(map(math.isfinite, losses)) or launches != want:
        raise SystemExit(f"slice failed: losses {losses}, launches "
                         f"{launches} (want {want})")
    print("[slice] second run, same seed", flush=True)
    again, _ = run_slice(fa, layers, count=False)
    same = again == losses
    print(f"  losses bitwise equal across same-seed runs: {same}",
          flush=True)
    if not same:
        raise SystemExit("same-seed runs disagree")

    print("kernels: " + ", ".join(f"{n} ok" for n in KERNELS))
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES, "launches": launches[n],
         **{k: results[n][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
        for n in KERNELS]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
