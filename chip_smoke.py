"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. card: name and power limit, torch and CUDA versions, kernel build;
  2. kernels: every CUDA kernel of the main paths against its plain
     PyTorch version on the card (tolerances below), bitwise repeats,
     and times: the kernel, the plain version, and one PyTorch call as
     a yardstick only, never called by the port
     (scaled_dot_product_attention for attention, torch.bmm for the
     grouped expert matmul);
  3. reference: the engine on the card against the same engine on the
     CPU (plain versions) at the campaign's tiny GPT and at the reduced
     Qwen1.5-MoE config;
  4. slice, GPT: PipelineEngine trains GPT-medium at full width (24
     layers, d_model 1024, 16 x 64 heads, d_ff 4096, vocab 50304, f32
     params) over dp=2 x pp=2, 2 micro-batches, global batch 8, seq
     2048;
  5. slice, MoE: PipelineEngine trains Qwen1.5-MoE-A2.7B at full width
     (d_model 2048, 16 x 128 heads, 60 experts top-4 plus 4 shared,
     d_expert 1408, vocab 151936), depth cut to 2 layers, over dp=1 x
     pp=2, 2 micro-batches, global batch 4, seq 2048, with the layer
     weights stored in bf16 (the engine's param_dtype; embedding, head,
     activations and optimizer state stay f32).
Each slice runs setup, record_iteration and 3 x train_iteration twice
with the same seed (losses must be bitwise equal), with every kernel's
launch count zeroed just before its first run and read just after it.
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
F32_FWD_TOL, F32_GRAD_TOL, BF16_TOL = 2e-5, 1e-4, 2e-2
# grouped matmul: max |kernel - plain| over max |plain| (f32 sums of up
# to 2048 products in another order; bf16 outputs round to 8 bits)
GMM_F32_TOL, GMM_BF16_TOL = 1e-4, 2e-2
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor
# cores, bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# the main paths' attention: micro-batch 2, seq 2048; GPT-medium 16 x 64
# heads (timed for the JSON line), Qwen1.5-MoE 16 x 128 heads
SLICE = dict(bh=2 * 16, s=2048, d=64, dtype=torch.float32, causal=True)
MOE_ATTN = dict(SLICE, d=128)
# the MoE path's expert products: 60 experts, B*C = 2 * 171 tokens;
# gate/up (E, M, K) @ (E, K, N), down with K and N swapped
GMM_SLICE = dict(e=60, m=342, k=2048, n=1408, dtype=torch.float32)
GMM_DOWN = dict(GMM_SLICE, k=1408, n=2048)
FLASH = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
GMM = ("gmm_fwd", "gmm_bwd_dx", "gmm_bwd_dw")
SOURCES = {**{n: ("src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:24")
              for n in FLASH},
           **{n: ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                  "src/repro/kernels/moe_gmm.py:19") for n in GMM}}


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


def gmm_work(e, m, k, n, dtype):
    """(FLOPs, bytes) of one grouped product at this shape, the same for
    all three kernels: 2*E*M*K*N FLOPs; two of x (E,M,K), w (E,K,N) and
    dy (E,M,N) read once, the third written once."""
    el = torch.tensor([], dtype=dtype).element_size()
    return 2 * e * m * k * n, (e * m * k + e * k * n + e * m * n) * el


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(fa):
    """Every attention kernel against its plain version; returns the
    GPT-shape results by kernel name."""
    cases = [dict(SLICE),
             dict(bh=8, s=256, d=16, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=32, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=128, dtype=torch.float32, causal=True),
             dict(bh=8, s=256, d=64, dtype=torch.float32, causal=False),
             dict(bh=4, s=200, d=64, dtype=torch.float32, causal=True),
             dict(bh=8, s=32, d=16, dtype=torch.float32, causal=True),
             dict(MOE_ATTN),
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
        ok = repeat and all(errs[n] <= tols[n] for n in FLASH)
        label = (f"bh={bh} s={s} d={d} {str(dt)[6:]} "
                 f"{'causal' if causal else 'full'}")
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (tol {tols[n]:g})" for n in FLASH)
            + f", bitwise repeat {repeat}", flush=True)
        if not ok:
            raise SystemExit(f"kernel check failed at {label}")
        if c in (SLICE, MOE_ATTN):
            timed = {n: {"max_abs_err": errs[n]} for n in FLASH}
            time_attention(fa, timed, c, q, k, v, do, o, lse, sc)
            if c == SLICE:
                results = timed
    return results


def time_attention(fa, results, shape, q, k, v, do, o, lse, sc):
    causal, reps = shape["causal"], 10
    fwd = lambda: fa.flash_fwd(q, k, v, causal, sc)
    dkdv_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr())
    dk, dv, dq = (torch.empty_like(q) for _ in range(3))
    common = (shape["bh"], shape["s"], shape["d"], 0, int(causal), sc)
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
    for n in FLASH:
        results[n]["bound_ms"], results[n]["bound_by"] = bound(
            *attention_work(n, **shape), shape["dtype"])
        print(f"  {n} at d={shape['d']}: {results[n]['ms']:.4f} ms, "
              f"plain {results[n]['plain_ms']:.4f} ms, library "
              f"{results[n]['library_ms']:.4f} ms, bound "
              f"{results[n]['bound_ms']:.4f} ms ({results[n]['bound_by']})",
              flush=True)


def check_gmm(gm):
    """The three grouped-matmul kernels against their plain versions at
    the MoE path's gate/up and down shapes and at ragged small shapes;
    returns the gate/up-shape results by kernel name."""
    cases = [dict(GMM_SLICE), dict(GMM_DOWN),
             dict(e=3, m=5, k=33, n=17, dtype=torch.float32),
             dict(e=8, m=20, k=64, n=96, dtype=torch.float32),
             dict(e=2, m=130, k=70, n=65, dtype=torch.float32),
             dict(GMM_SLICE, dtype=torch.bfloat16),
             dict(e=3, m=5, k=33, n=17, dtype=torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for c in cases:
        e, m, k, n, dt = c["e"], c["m"], c["k"], c["n"], c["dtype"]
        rnd = lambda *sh, sc=1.0: (torch.randn(
            *sh, device="cuda", generator=gen) * sc).to(dt)
        x, w, dy = rnd(e, m, k), rnd(e, k, n, sc=k ** -0.5), rnd(e, m, n)
        run = lambda: (gm.gmm_fwd(x, w), gm.gmm_bwd_dx(dy, w),
                       gm.gmm_bwd_dw(x, dy))
        got = run()
        torch.cuda.synchronize()
        want = (gm.gmm_fwd_ref(x, w), gm.gmm_bwd_dx_ref(dy, w),
                gm.gmm_bwd_dw_ref(x, dy))
        again = run()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        tol = GMM_F32_TOL if dt == torch.float32 else GMM_BF16_TOL
        errs, rels = {}, {}
        for name, g, r in zip(GMM, got, want):
            if g.shape != r.shape or g.dtype != r.dtype:
                raise SystemExit(f"{name}: {tuple(g.shape)} {g.dtype} "
                                 f"against {tuple(r.shape)} {r.dtype}")
            errs[name] = (g.float() - r.float()).abs().max().item()
            rels[name] = errs[name] / max(r.float().abs().max().item(),
                                          1e-30)
        label = f"E={e} M={m} K={k} N={n} {str(dt)[6:]}"
        print(f"  {label}: " + ", ".join(
            f"{nm} err {errs[nm]:.3e} (rel {rels[nm]:.2e}, tol {tol:g})"
            for nm in GMM) + f", bitwise repeat {repeat}", flush=True)
        if not repeat or any(rels[nm] > tol for nm in GMM):
            raise SystemExit(f"grouped matmul check failed at {label}")
        if c in (GMM_SLICE, GMM_DOWN):
            timed = {nm: {"max_abs_err": errs[nm]} for nm in GMM}
            time_gmm(gm, timed, c, x, w, dy)
            if c == GMM_SLICE:
                results = timed
    return results


def time_gmm(gm, results, shape, x, w, dy):
    reps = 10
    calls = {
        "gmm_fwd": (lambda: gm.gmm_fwd(x, w), lambda: gm.gmm_fwd_ref(x, w),
                    lambda: torch.bmm(x, w)),
        "gmm_bwd_dx": (lambda: gm.gmm_bwd_dx(dy, w),
                       lambda: gm.gmm_bwd_dx_ref(dy, w),
                       lambda: torch.bmm(dy, w.transpose(1, 2))),
        "gmm_bwd_dw": (lambda: gm.gmm_bwd_dw(x, dy),
                       lambda: gm.gmm_bwd_dw_ref(x, dy),
                       lambda: torch.bmm(x.transpose(1, 2), dy))}
    work = gmm_work(**shape)
    for name, (kern, plain, lib) in calls.items():
        r = results[name]
        r["ms"] = time_ms(kern, reps)
        r["plain_ms"] = time_ms(plain, reps)
        r["library_ms"] = time_ms(lib, reps)
        r["bound_ms"], r["bound_by"] = bound(*work, shape["dtype"])
        print(f"  {name} at E={shape['e']} M={shape['m']} K={shape['k']} "
              f"N={shape['n']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{work[0] / r['ms'] / 1e9:.2f} TFLOP/s", flush=True)


def ptxas_summary(log: str):
    """One line per kernel instance: registers, shared memory and spill
    bytes (ptxas prints the spill line of an entry before its register
    count)."""
    name, spills, out = None, "?", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?"
                      r"(fwd_kernel|bwd_dkdv_kernel|bwd_dq_kernel|"
                      r"gmm_kernel)I(f|13__nv_bfloat16)((?:L[ib]\d+E)*)E",
                      line)
        if m:
            dt = "f32" if m.group(2) == "f" else "bf16"
            args = re.findall(r"L[ib](\d+)E", m.group(3))
            name = f"{m.group(1)}<{', '.join([dt] + args)}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers{m.group(2)}, "
                       f"spill stores/loads {spills}")
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
    groups = {"attention kernels": 0.0, "grouped matmul kernels": 0.0,
              "matmul (cuBLAS)": 0.0, "other": 0.0}
    for n, us in by_name.items():
        if re.search(r"fwd_kernel|bwd_dkdv_kernel|bwd_dq_kernel", n):
            groups["attention kernels"] += us
        elif re.search(r"gmm_kernel", n):
            groups["grouped matmul kernels"] += us
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
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.1f} ms  {n[:110]}")


def build_engine(cfg, device, seed=0, dp=2, pp=2, batch=8, seq=32,
                 param_dtype=torch.float32):
    from repro_torch.cluster.node import Cluster
    from repro_torch.cluster.simclock import SimClock
    from repro_torch.core.engine import PipelineEngine
    from repro_torch.core.sandbox import CommHooks
    clock = SimClock()
    eng = PipelineEngine(cfg, dp, pp, batch, seq,
                         Cluster(dp * pp, device_capacity=80 * 2 ** 30),
                         clock, CommHooks(clock), micro_batches=2,
                         seed=seed, sim_compile_seconds=1.0,
                         param_dtype=param_dtype, device=device)
    eng.setup(list(range(dp * pp)))
    return eng


def check_reference():
    """The card's engine (kernels) against the CPU engine (plain
    versions) at the campaign's tiny GPT and the reduced Qwen1.5-MoE:
    same seed, same weights."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.configs.gpt import tiny_gpt
    for cfg in (tiny_gpt(layers=4, d=64, heads=4, vocab=256),
                qwen2_moe_a2_7b.reduced()):
        losses = {}
        for dev in ("cuda", "cpu"):
            eng = build_engine(cfg, dev)
            eng.record_iteration()
            for _ in range(2):
                eng.train_iteration()
            losses[dev] = eng.losses
        diff = max(abs(a - b) for a, b in zip(losses["cuda"],
                                              losses["cpu"]))
        print(f"  {cfg.name} losses cuda {losses['cuda']} cpu "
              f"{losses['cpu']} max diff {diff:.3e} (tol 1e-4)", flush=True)
        if not (all(map(math.isfinite, losses["cuda"])) and diff <= 1e-4):
            raise SystemExit(f"card engine disagrees with the CPU engine "
                             f"at {cfg.name}")


def run_slice(mods, cfg, dp: int, batch: int, param_dtype, count: bool):
    """setup, record_iteration and 3 x train_iteration at seq 2048 over
    dp x pp=2. With `count`, every kernel's launch count is zeroed just
    before and read just after; without, the last iteration is
    profiled."""
    torch.cuda.reset_peak_memory_stats()
    if count:
        for mod in mods:
            mod.reset_launches()
    t0 = time.perf_counter()
    eng = build_engine(cfg, "cuda", dp=dp, pp=2, batch=batch, seq=2048,
                       param_dtype=param_dtype)
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
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    if not count:       # the last iteration of the repeat run, profiled
        profile_step(eng, steps[-1])
    print(f"  step wall s (record, then train): {steps}", flush=True)
    print(f"  losses {eng.losses}", flush=True)
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
          f"SimClock train lane {eng.clock.lane_total('train')} s",
          flush=True)
    losses = list(eng.losses)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return losses, launches


def expected_launches(cfg, dp: int, moe: bool):
    """Launches over record + 3 train iterations (4 x dp replicas x 2
    micro-batches): every stage-0 layer runs forward twice (fwd, then
    the mid_bwd recompute) and the last stage's once; every layer runs
    backward once. An attn_moe layer makes three expert products in each
    direction."""
    per = cfg.num_layers // 2                  # layers per stage, pp=2
    calls = 4 * dp * 2
    fwd, bwd = calls * 3 * per, calls * 2 * per
    want = {"flash_fwd": fwd, "flash_bwd_dkdv": bwd, "flash_bwd_dq": bwd}
    products = 3 if moe else 0
    want.update(gmm_fwd=products * fwd, gmm_bwd_dx=products * bwd,
                gmm_bwd_dw=products * bwd)
    return want


def drive(mods, label, cfg, dp, batch, moe, param_dtype=torch.float32):
    print(f"[slice] {label}", flush=True)
    losses, launches = run_slice(mods, cfg, dp, batch, param_dtype,
                                 count=True)
    print(f"  launches in the main path: {launches}", flush=True)
    want = expected_launches(cfg, dp, moe)
    if not all(map(math.isfinite, losses)) or launches != want:
        raise SystemExit(f"slice failed: losses {losses}, launches "
                         f"{launches} (want {want})")
    print(f"[slice] {label}: second run, same seed", flush=True)
    again, _ = run_slice(mods, cfg, dp, batch, param_dtype, count=False)
    same = again == losses
    print(f"  losses bitwise equal across same-seed runs: {same}",
          flush=True)
    if not same:
        raise SystemExit("same-seed runs disagree")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.configs.gpt import GPT_MEDIUM
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gmm as gm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.libraries()
    print(f"[card] kernel libraries built in {libs.seconds:.2f} s "
          f"(loaded after {time.perf_counter() - t0:.2f} s)", flush=True)
    for lib in ("flash_attention", "moe_gmm"):
        for line in ptxas_summary(libs.log.get(lib, "")):
            print(f"  ptxas: {line}")

    print("[kernels] against the plain versions", flush=True)
    results = check_kernels(fa)
    results.update(check_gmm(gm))

    print("[reference] card engine against the CPU engine", flush=True)
    check_reference()

    mods = (fa, gm)
    gpt = GPT_MEDIUM
    launches = drive(mods, f"GPT-medium, {gpt.num_layers} layers, dp=2 "
                     f"pp=2 mb=2 batch 8 seq 2048", gpt, 2, 8, moe=False)
    # 1.76 G parameters at 2 layers: with f32 layer weights the first
    # Adam update needs more than the card's 80 GB (flat m, v and master
    # beside the weights, their buckets, the gradients and the update's
    # temporaries), so the layer weights are stored in bf16
    qwen = qwen2_moe_a2_7b.CONFIG.replace(num_layers=2)
    moe_launches = drive(mods, f"{qwen.name}, {qwen.num_layers} layers, "
                         f"dp=1 pp=2 mb=2 batch 4 seq 2048, bf16 layer "
                         f"weights", qwen, 1, 4, moe=True,
                         param_dtype=torch.bfloat16)
    by_path = {n: {gpt.name: launches[n], qwen.name: moe_launches[n]}
               for n in FLASH + GMM}

    print("kernels: " + ", ".join(f"{n} ok" for n in FLASH + GMM))
    print(f"whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": sum(by_path[n].values()),
         "launches_by_path": by_path[n],
         **{k: results[n][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")}}
        for n in FLASH + GMM]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
