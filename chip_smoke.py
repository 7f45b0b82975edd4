"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. card: name and power limit, torch and CUDA versions, kernel build,
     each kernel instance's registers and spills (ptxas); every
     attention instance (forward, dq, dkdv), every grouped matmul
     instance (gmm_mma_kernel: three products, wide and narrow) and
     every instance of the mLSTM kernels' passes with products (state
     walks, output, dq/dk and dv passes) must issue tensor-core
     instructions (HMMA in its SASS), no instance of those three
     libraries may spill, and no other kernel may be in them (the
     mLSTM's scalar passes have no HMMA); no instance of the RG-LRU
     scan's passes may spill either;
  2. kernels: every CUDA kernel of the main paths against its plain
     PyTorch version on the card (tolerances below; the kernels' outputs
     are allocated filled with NaN, so one left unwritten fails),
     bitwise repeats, and times: the kernel, the plain version, and one
     PyTorch call as a yardstick only, never called by the port
     (scaled_dot_product_attention for attention, with the window as a
     mask where there is one, whose forward flash_fwd must beat at the
     three paths' shapes; torch.bmm for the grouped expert matmul, which
     each of its three kernels must beat at both of the MoE path's
     shapes; both timed in turns with the kernel; none for the RG-LRU
     scan and the chunkwise mLSTM); the mLSTM's dq/dk kernel's dC
     workspace against its plain reverse pass, the dv kernel on that
     workspace against its plain pass on the same dC, dq and dk, and
     the device time of each pass of the three mLSTM kernels; the
     RG-LRU scan also at chunk edges of the chunk length its wrapper
     picks (S a multiple of it, S one step past it, ragged S with B > 1
     and a D no multiple of the 4 lanes a thread takes where it can),
     its workspace (each
     chunk's product and carry) against its plain passes, and the
     device time of each of its passes;
  3. reference: the engine on the card against the same engine on the
     CPU (plain versions) at the campaign's tiny GPT and at the reduced
     Qwen1.5-MoE config, and make_train_step on the card against the
     CPU at the reduced RecurrentGemma config cut to 5 layers (window
     16 below seq 64) and the reduced xLSTM config at 4 layers (seq
     200: three chunks of 64 and a padded fourth);
  4. slice, GPT: PipelineEngine trains GPT-medium at full width (24
     layers, d_model 1024, 16 x 64 heads, d_ff 4096, vocab 50304, f32
     params) over dp=2 x pp=2, 2 micro-batches, global batch 8, seq
     2048;
  5. slice, MoE: PipelineEngine trains Qwen1.5-MoE-A2.7B at full width
     (d_model 2048, 16 x 128 heads, 60 experts top-4 plus 4 shared,
     d_expert 1408, vocab 151936), depth cut to 2 layers, over dp=1 x
     pp=2, 2 micro-batches, global batch 4, seq 2048, with the layer
     weights stored in bf16 (the engine's param_dtype; embedding, head,
     activations and optimizer state stay f32);
  6. slice, RecurrentGemma: the launcher (`repro_torch.launch.train`,
     make_train_step) trains RecurrentGemma-2B at full width and depth
     (26 layers: 8 x (rglru, rglru, local_attn) + 2 rglru; d_model
     2560, 10 x 256 heads on one kv head, window 2048, d_ff 7680, vocab
     256000, tied embedding) for 3 steps at global batch 1, seq 4096,
     with RunCfg's defaults (bf16 parameters, remat, grad_accum 1);
     the profiled step must show device time in the RG-LRU scan's
     kernels;
  7. slice, xLSTM: the launcher trains xLSTM-350M at full width and
     depth (24 layers: 12 x (mlstm, slstm); d_model 1024, 4 heads of
     512 in the mLSTM, vocab 50304, untied head) for XL_STEPS steps at
     global batch 4, seq XL_SEQ, with RunCfg's defaults;
  8. slice, migration (run right after phase 4, once its engines are
     freed): the Controller drives GPT-medium with phase 4's engine
     arguments on a cluster of dp x pp + 2 + 1 machines with one
     general standby: bootstrap_job (setup, record_iteration, a
     checkpoint tick, the standby warmed for the first and last roles),
     train(1), an expected migration of grid[(1, 1)], train(1), an
     unexpected failure of grid[(0, 0)] (a first stage: the standby's
     promotion takes the role-delta path), train(1). The three losses
     must equal the last three of phase 4's first run bit for bit (the
     paper's contract), and the launches the count derived from the
     script. Per event it prints the MigrationReport, the SimClock's
     downtime and overlap lanes (simulated, the cost model), the wall
     seconds the card took (measured), the bytes each state copy moved,
     each checkpoint tick's wall seconds and bytes, and the peak device
     memory.
Each engine slice runs setup, record_iteration and 3 x train_iteration
twice with the same seed; the launcher slices run the launcher twice.
Losses must be bitwise equal across the two runs, and the GPT and MoE
slices' first losses equal the pinned ones (GPT_FIRST_LOSS,
MOE_FIRST_LOSS). Every
kernel's launch count is zeroed just before a path's first run and read
just after it, and must equal the count derived from the config. The
last lines are a JSON line per kernel result, the card line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
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
# attention: f32 max |kernel - plain|; bf16 that and also max |kernel -
# plain| over max |plain| per output (both round to 8 bits: one bf16 step
# at the top of the range is 2^-8 to 2^-7 of max |plain|, and a dropped
# kv tile of the window-2048 case moves the output by far more)
F32_FWD_TOL, F32_GRAD_TOL, BF16_TOL, BF16_REL_TOL = 2e-5, 1e-4, 2e-2, 1e-2
# grouped matmul: max |kernel - plain| over max |plain| (f32 sums of up
# to 2048 products in another order; bf16 outputs round to 8 bits)
GMM_F32_TOL, GMM_BF16_TOL = 1e-4, 2e-2
# RG-LRU scan: max |kernel - plain| over max |plain| (the kernel fuses
# each step's multiply-add, the plain version rounds twice; bf16 outputs
# round to 8 bits)
SCAN_F32_TOL, SCAN_BF16_TOL = 1e-5, 2e-2
# the scan kernels' medians in their first design (a thread per (b, d)
# lane walking all of S) at RG_SCAN on an NVIDIA H100 80GB HBM3 at
# 700 W, printed beside this run's
RGLRU_FIRST_MS = {"rglru_fwd": 0.5789, "rglru_bwd": 0.6186}
# make_train_step, card against CPU at the reduced RecurrentGemma and
# xLSTM: losses and grad norms (f32; sums in other orders over two
# steps)
STEP_REF_TOL = 1e-4
# first loss of the GPT-medium slice, pinned to the attention forward
# on the tensor cores (fwd_kernel, d 64 f32)
GPT_FIRST_LOSS = 11.067411184310913
# first loss of the Qwen MoE slice, pinned to the grouped matmul's
# gmm_fwd (gmm_mma_kernel, 128 x 64 tiles) and the attention forward
# (fwd_kernel, d 128 f32), both on the tensor cores
MOE_FIRST_LOSS = 12.318589687347412
# H100 SXM peaks (NVIDIA data sheet, dense), HBM3 bandwidth. f32: the
# TF32 tensor-core rate of 495 TFLOP/s over the three products that keep
# f32 accuracy (3xTF32, as the attention backward runs), the card's
# fastest route at f32 accuracy; the 67 TFLOP/s of the CUDA cores would
# be a bound that such a kernel can beat, which is no bound. bf16: the
# tensor cores.
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# the main paths' attention: micro-batch 2, seq 2048; GPT-medium 16 x 64
# heads (timed for the JSON line), Qwen1.5-MoE 16 x 128 heads
SLICE = dict(bh=2 * 16, s=2048, d=64, dtype=torch.float32, causal=True,
             window=0)
MOE_ATTN = dict(SLICE, d=128)
# RecurrentGemma-2B's local attention: batch 1 x 10 q heads (the one kv
# head expanded), seq 4096, head dim 256, window 2048, bf16 activations
RG_ATTN = dict(bh=10, s=4096, d=256, dtype=torch.bfloat16, causal=True,
               window=2048)
# its RG-LRU scans: batch 1, seq 4096, width 2560, f32 gates
RG_SCAN = dict(b=1, s=4096, d=2560, a_dtype=torch.float32,
               x_dtype=torch.float32)
# the MoE path's expert products: 60 experts, B*C = 2 * 171 tokens;
# gate/up (E, M, K) @ (E, K, N), down with K and N swapped
GMM_SLICE = dict(e=60, m=342, k=2048, n=1408, dtype=torch.float32)
GMM_DOWN = dict(GMM_SLICE, k=1408, n=2048)
# chunkwise mLSTM: max |kernel - plain| over max |plain| per output (f32
# sums over K = 512 and the chunk in other orders; bf16 h rounds to 8
# bits, the gradients are f32 from the same bf16 inputs)
MLSTM_F32_TOL, MLSTM_BF16_TOL = 1e-4, 1e-2
# the mLSTM kernels' medians in their first design (plain FMA loops, one
# block per (head, 64 columns of C), every chunk in order) at XL_MLSTM on
# an NVIDIA H100 80GB HBM3 at 700 W, printed beside this run's
MLSTM_FIRST_MS = {"mlstm_fwd": 6.5571, "mlstm_bwd_dqdk": 9.8827,
                  "mlstm_bwd_dv": 7.1825}
# the xLSTM-350M slice: steps per launcher run and sequence length
XL_STEPS, XL_SEQ = 2, 2048
# its mLSTM cells: batch 4 x 4 heads, seq XL_SEQ, head dim 512, chunk
# 64, f32 q, k, v and log gates
XL_MLSTM = dict(bh=16, s=XL_SEQ, k=512, chunk=64, dtype=torch.float32)
FLASH = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
GMM = ("gmm_fwd", "gmm_bwd_dx", "gmm_bwd_dw")
SCAN = ("rglru_fwd", "rglru_bwd")
# the scan library's kernels: the passes of both exports
SCAN_PASSES = ("rglru_fwd_reduce_kernel", "rglru_fwd_out_kernel",
               "rglru_bwd_reduce_kernel", "rglru_bwd_out_kernel",
               "rglru_carry_kernel")
MLSTM = ("mlstm_fwd", "mlstm_bwd_dqdk", "mlstm_bwd_dv")
# the mLSTM library's kernels, with and without tensor-core products
MLSTM_TC = ("mlstm_fwd_state_kernel", "mlstm_fwd_out_kernel",
            "mlstm_bwd_dqdk_state_kernel", "mlstm_bwd_dqdk_grad_kernel",
            "mlstm_bwd_dv_grad_kernel")
MLSTM_NO_TC = ("mlstm_fwd_scalars_kernel", "mlstm_bwd_dqdk_scalars_kernel",
               "mlstm_bwd_dv_scalars_kernel")
SOURCES = {**{n: ("src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:24")
              for n in FLASH},
           **{n: ("src/repro_torch/kernels/csrc/moe_gmm.cu",
                  "src/repro/kernels/moe_gmm.py:19") for n in GMM},
           **{n: ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                  "src/repro/kernels/rglru_scan.py:20") for n in SCAN},
           **{n: ("src/repro_torch/kernels/csrc/mlstm.cu",
                  "src/repro/kernels/mlstm.py:22") for n in MLSTM}}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def unwritten_is_nan():
    """Every new tensor from torch.empty comes filled with NaN (the
    check deterministic mode has for reads of memory never written), so
    an output element a kernel leaves unwritten fails its comparison and
    its bitwise repeat; warn_only keeps ops that lack a deterministic
    version running. The timed calls run outside, without the fill."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]


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


def time_pair_ms(fa, fb, reps: int):
    """Medians of `reps` launches each of fa and fb, taken in turns (fa,
    fb, fa, ...) so that a drift of the card's clock falls on both."""
    times = ([], [])
    for fn in (fa, fb, fa, fb):
        fn()
    for _ in range(reps):
        for fn, out in zip((fa, fb), times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def visible_pairs(s, causal, window):
    """(q, k) pairs the mask keeps: k <= q when causal, q - k < window
    when window > 0."""
    q = torch.arange(s)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    hi = q + 1 if causal else torch.full_like(q, s)
    return int((hi - lo).clamp(min=0).sum())


def attention_work(name, bh, s, d, dtype, causal, window):
    """(FLOPs, bytes) the function needs at this shape: only the
    unmasked (q, k) pairs count; each input read once, each output
    written once."""
    pairs = bh * visible_pairs(s, causal, window)
    el = torch.tensor([], dtype=dtype).element_size()
    tile = bh * s * d * el
    row = bh * s * 4                 # one f32 value a row: lse, delta
    if name == "flash_fwd":          # QK^T, PV; reads q,k,v; writes o,lse
        return 4 * d * pairs, 3 * tile + tile + row
    if name == "flash_bwd_dkdv":     # S, dP, dV, dK; reads q,k,v,dO,lse,D
        return 8 * d * pairs, 4 * tile + 2 * row + 2 * tile
    # dq: D = rowsum(dO O), S, dP, dQ; reads q,k,v,o,dO,lse; writes dq,D
    return 6 * d * pairs + 2 * bh * s * d, 5 * tile + row + tile + row


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
    GPT-shape results by kernel name, each with the times at every
    path's shape under "shapes"."""
    f32 = dict(dtype=torch.float32, window=0)
    bf16 = dict(dtype=torch.bfloat16, window=0)
    cases = [dict(SLICE),
             dict(bh=8, s=256, d=16, causal=True, **f32),
             dict(bh=8, s=256, d=32, causal=True, **f32),
             dict(bh=8, s=256, d=128, causal=True, **f32),
             dict(bh=8, s=256, d=64, causal=False, **f32),
             dict(bh=4, s=200, d=64, causal=True, **f32),
             dict(bh=8, s=32, d=16, causal=True, **f32),
             dict(MOE_ATTN),
             dict(SLICE, dtype=torch.bfloat16),
             # windows that are no multiple of the tile, ragged S
             dict(bh=3, s=200, d=256, causal=True, dtype=torch.float32,
                  window=45),
             dict(bh=2, s=77, d=256, causal=True, dtype=torch.bfloat16,
                  window=33),
             dict(bh=2, s=96, d=256, causal=False, dtype=torch.float32,
                  window=40),
             dict(bh=4, s=130, d=64, causal=True, dtype=torch.float32,
                  window=50),
             dict(RG_ATTN, dtype=torch.float32),
             dict(RG_ATTN),
             # the backward's tile edges: bf16 with S no multiple of 64
             # (nor of the 32-row walked tiles at d 128), S below one
             # tile, windows no multiple of the tile at d 64 and 128
             dict(bh=3, s=130, d=16, causal=True, **bf16),
             dict(bh=3, s=77, d=32, causal=True, **bf16),
             dict(bh=2, s=130, d=128, causal=True, **bf16),
             dict(bh=2, s=77, d=128, causal=True, **bf16),
             dict(bh=4, s=20, d=64, causal=True, **f32),
             dict(bh=4, s=12, d=128, causal=False, **f32),
             dict(bh=4, s=20, d=64, causal=True, **bf16),
             dict(bh=2, s=10, d=256, causal=True, **bf16),
             dict(bh=3, s=300, d=128, causal=True, dtype=torch.float32,
                  window=70),
             dict(bh=3, s=300, d=128, causal=True, dtype=torch.bfloat16,
                  window=70),
             dict(bh=3, s=250, d=64, causal=True, dtype=torch.bfloat16,
                  window=45),
             dict(bh=2, s=200, d=128, causal=False, dtype=torch.float32,
                  window=90)]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results, shapes = {}, {n: [] for n in FLASH}
    for c in cases:
        bh, s, d, dt, causal, win = c["bh"], c["s"], c["d"], c["dtype"], \
            c["causal"], c["window"]
        q, k, v, do = (torch.randn(bh, s, d, device="cuda", generator=gen)
                       .to(dt) for _ in range(4))
        sc = d ** -0.5
        with unwritten_is_nan():
            o, lse = fa.flash_fwd(q, k, v, causal, sc, win)
            *grads, delta = fa.flash_bwd(q, k, v, o, lse, do, causal, sc,
                                         win)
        torch.cuda.synchronize()
        ro, rlse = fa.attention_fwd_ref(q, k, v, causal, sc, win)
        rgrads = fa.attention_bwd_ref(q, k, v, o, lse, do, causal, sc, win)
        err = lambda a, b: (a.float() - b.float()).abs().max().item()
        rel = lambda a, b: err(a, b) / max(b.float().abs().max().item(),
                                           1e-30)
        # D = rowsum(dO * O) as flash_bwd_dq wrote it, against the plain
        # f32 sum, relative to its largest value (sums of up to 256 f32
        # products in two orders)
        delta_rel = rel(delta, (do.float() * o.float()).sum(-1))
        pairs = {"flash_fwd": ((o, ro), (lse, rlse)),
                 "flash_bwd_dkdv": ((grads[1], rgrads[1]),
                                    (grads[2], rgrads[2])),
                 "flash_bwd_dq": ((grads[0], rgrads[0]),)}
        errs = {n: max(err(*ab) for ab in pairs[n]) for n in FLASH}
        rels = {n: max(rel(*ab) for ab in pairs[n]) for n in FLASH}
        del pairs
        del ro, rlse, rgrads
        with unwritten_is_nan():
            o2, lse2 = fa.flash_fwd(q, k, v, causal, sc, win)
            grads2 = fa.flash_bwd(q, k, v, o, lse, do, causal, sc, win)
        repeat = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
            torch.equal(a, b) for a, b in zip(grads + [delta], grads2))
        f32 = dt == torch.float32
        tols = {"flash_fwd": F32_FWD_TOL if f32 else BF16_TOL,
                "flash_bwd_dkdv": F32_GRAD_TOL if f32 else BF16_TOL,
                "flash_bwd_dq": F32_GRAD_TOL if f32 else BF16_TOL}
        rel_tol = math.inf if f32 else BF16_REL_TOL
        ok = repeat and delta_rel <= F32_FWD_TOL and all(
            errs[n] <= tols[n] and rels[n] <= rel_tol for n in FLASH)
        label = (f"bh={bh} s={s} d={d} {str(dt)[6:]} "
                 f"{'causal' if causal else 'full'}"
                 + (f" window={win}" if win else ""))
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (tol {tols[n]:g}; rel {rels[n]:.2e}, "
            f"tol {rel_tol:g})" for n in FLASH)
            + f", delta rel {delta_rel:.2e} (tol {F32_FWD_TOL:g}), bitwise "
            f"repeat {repeat}", flush=True)
        if not ok:
            raise SystemExit(f"kernel check failed at {label}")
        if c in (SLICE, MOE_ATTN, RG_ATTN):
            timed = {n: {"max_abs_err": errs[n]} for n in FLASH}
            time_attention(fa, timed, c, q, k, v, do, o, lse, sc)
            for n in FLASH:
                shapes[n].append({"shape": label, **timed[n]})
            if c == SLICE:
                results = timed
        del q, k, v, do, o, lse, grads, delta, o2, lse2, grads2
    for n in FLASH:
        results[n]["shapes"] = shapes[n]
    return results


def time_attention(fa, results, shape, q, k, v, do, o, lse, sc):
    """Times of the three kernels, the plain versions and SDPA at one of
    the paths' shapes; flash_fwd and SDPA's forward are timed in turns,
    and the kernel must be faster."""
    causal, win, reps = shape["causal"], shape["window"], 10
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    common = (shape["bh"], shape["s"], shape["d"],
              0 if shape["dtype"] == torch.float32 else 1, int(causal),
              win, sc)
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the window as a boolean mask (True = visible); no mask when causal
    # alone says it all
    mask = None
    if win:
        mask = fa._mask(shape["s"], shape["s"], causal, win, q.device)
    lib = lambda a, b, c: sdpa(a, b, c, attn_mask=mask,
                               is_causal=causal and mask is None, scale=sc)
    results["flash_fwd"]["ms"], results["flash_fwd"]["library_ms"] = \
        time_pair_ms(lambda: fa.flash_fwd(q, k, v, causal, sc, win),
                     lambda: lib(q, k, v), 2 * reps)
    # in the order flash_bwd runs them: dq writes the delta dkdv reads
    results["flash_bwd_dq"]["ms"] = time_ms(lambda: fa.launch(
        "flash_bwd_dq", *ptr(q, k, v, o, lse, do, dq, delta), *common,
        device=q.device), reps)
    results["flash_bwd_dkdv"]["ms"] = time_ms(lambda: fa.launch(
        "flash_bwd_dkdv", *ptr(q, k, v, delta, lse, do, dk, dv), *common,
        device=q.device), reps)
    results["flash_fwd"]["plain_ms"] = time_ms(
        lambda: fa.attention_fwd_ref(q, k, v, causal, sc, win), reps)
    plain_bwd = time_ms(
        lambda: fa.attention_bwd_ref(q, k, v, o, lse, do, causal, sc, win),
        reps)
    # the plain backward computes dq, dk and dv in one pass
    results["flash_bwd_dkdv"]["plain_ms"] = plain_bwd
    results["flash_bwd_dq"]["plain_ms"] = plain_bwd
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = lib(ql, kl, vl)
    # SDPA's backward yields dq, dk and dv from one call
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do, retain_graph=True), reps)
    results["flash_bwd_dkdv"]["library_ms"] = lib_bwd
    results["flash_bwd_dq"]["library_ms"] = lib_bwd
    for n in FLASH:
        results[n]["bound_ms"], results[n]["bound_by"] = bound(
            *attention_work(n, **shape), shape["dtype"])
        print(f"  {n} at d={shape['d']}"
              + (f" window={win}" if win else "")
              + f": {results[n]['ms']:.4f} ms, "
              f"plain {results[n]['plain_ms']:.4f} ms, library "
              f"{results[n]['library_ms']:.4f} ms, bound "
              f"{results[n]['bound_ms']:.4f} ms ({results[n]['bound_by']})",
              flush=True)
    pair = results["flash_bwd_dq"]["ms"] + results["flash_bwd_dkdv"]["ms"]
    print(f"  backward pair at d={shape['d']}: flash_bwd_dq + "
          f"flash_bwd_dkdv {pair:.4f} ms, SDPA backward {lib_bwd:.4f} ms, "
          f"ratio {pair / lib_bwd:.3f}", flush=True)
    fwd = results["flash_fwd"]
    print(f"  forward at d={shape['d']}: flash_fwd / SDPA forward "
          f"{fwd['ms'] / fwd['library_ms']:.3f}", flush=True)
    if fwd["ms"] >= fwd["library_ms"]:
        raise SystemExit(f"flash_fwd not faster than SDPA's forward at "
                         f"{shape}")


def gmm_wide(a, b, a_row: int, b_row: int) -> bool:
    """Whether moe_gmm.cu's host code picks the wide (16-byte copy)
    instance of gmm_mma_kernel: both operands' stored rows (a_row, b_row
    elements) a multiple of 16 bytes and both bases 16-byte aligned."""
    el = a.element_size()
    return (a_row * el % 16 == 0 and b_row * el % 16 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def gmm_instances(fn, tries: int = 3):
    """The grouped-matmul kernel instances `fn` launches, in launch
    order, named as instance_name names them (`gmm_mma_kernel<dtype, TA,
    TB, WIDE>`), from the profiler's kernel names, mangled or not. The
    profiler has come back with no device event at all for three
    launches of a few microseconds, so an empty profile is taken again,
    up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile
    words = {"float": "f32", "__nv_bfloat16": "bf16", "false": "0",
             "true": "1"}
    out = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for name, _ in device_kernels(prof):
            inst = instance_name(name)
            m = re.search(r"(gmm(?:_mma)?_kernel)<([^>]*)>", name)
            if inst is None and m:
                args = [words.get(a.strip(), a.strip())
                        for a in m.group(2).split(",")]
                inst = f"{m.group(1)}<{', '.join(args)}>"
            if inst and inst.startswith("gmm"):
                out.append(inst)
        if out:
            break
    return out


def check_gmm(gm):
    """The three grouped-matmul kernels against their plain versions at
    the MoE path's gate/up and down shapes and at ragged small shapes
    that cut every edge of gmm_mma_kernel's tile (rows no multiple of
    MMA_BM = 128, reductions no multiple of the 32 f32 / 64 bf16 R tile,
    columns no multiple of 8), with the wide and the narrow copies;
    each kernel must run the instance the host's rule picks. Returns
    the gate/up-shape results by kernel name, the down shape's under
    "shapes"."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(GMM_SLICE), dict(GMM_DOWN),
             dict(e=3, m=5, k=33, n=17, dtype=f32),
             dict(e=8, m=20, k=64, n=96, dtype=f32),
             dict(e=2, m=130, k=70, n=65, dtype=f32),
             dict(GMM_SLICE, dtype=bf16),
             dict(e=3, m=5, k=33, n=17, dtype=bf16),
             # wide in f32 (rows of 48 and 20 f32), narrow in bf16 (20
             # bf16 is 40 bytes): M 150 = 128 + 22, K 48 = 32 + 16, N 20
             dict(e=4, m=150, k=48, n=20, dtype=f32),
             dict(e=4, m=150, k=48, n=20, dtype=bf16),
             # wide bf16: K 72 = 64 + 8, N 136 = 128 + 8, M 200
             dict(e=3, m=200, k=72, n=136, dtype=bf16),
             # the path's 342 tokens with K and N short of the tiles
             dict(e=2, m=342, k=40, n=24, dtype=f32)]
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results, shapes = {}, {n: [] for n in GMM}
    for c in cases:
        e, m, k, n, dt = c["e"], c["m"], c["k"], c["n"], c["dtype"]
        rnd = lambda *sh, sc=1.0: (torch.randn(
            *sh, device="cuda", generator=gen) * sc).to(dt)
        x, w, dy = rnd(e, m, k), rnd(e, k, n, sc=k ** -0.5), rnd(e, m, n)
        run = lambda: (gm.gmm_fwd(x, w), gm.gmm_bwd_dx(dy, w),
                       gm.gmm_bwd_dw(x, dy))
        with unwritten_is_nan():
            got = run()
        torch.cuda.synchronize()
        want = (gm.gmm_fwd_ref(x, w), gm.gmm_bwd_dx_ref(dy, w),
                gm.gmm_bwd_dw_ref(x, dy))
        with unwritten_is_nan():
            again = run()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ran = gmm_instances(run)
        # (TA, TB, wide) of each product, in launch order
        inst = ((0, 0, gmm_wide(x, w, k, n)), (0, 1, gmm_wide(dy, w, n, n)),
                (1, 0, gmm_wide(x, dy, k, n)))
        want_ran = [f"gmm_mma_kernel<{'f32' if dt == f32 else 'bf16'}, {ta}, "
                    f"{tb}, {int(wide)}>" for ta, tb, wide in inst]
        tol = GMM_F32_TOL if dt == f32 else GMM_BF16_TOL
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
            for nm in GMM) + f", bitwise repeat {repeat}; ran "
            + ", ".join(ran), flush=True)
        if not repeat or not all(rels[nm] <= tol for nm in GMM):
            raise SystemExit(f"grouped matmul check failed at {label}")
        if ran != want_ran:
            raise SystemExit(f"grouped matmul at {label} ran {ran}, not "
                             f"{want_ran}")
        if c in (GMM_SLICE, GMM_DOWN):
            timed = {nm: {"max_abs_err": errs[nm]} for nm in GMM}
            time_gmm(gm, timed, c, x, w, dy)
            for nm in GMM:
                shapes[nm].append({"shape": label, **timed[nm]})
            if c == GMM_SLICE:
                results = timed
        del x, w, dy, got, want
    for nm in GMM:
        results[nm]["shapes"] = shapes[nm]
    return results


def time_gmm(gm, results, shape, x, w, dy):
    """Times of the three kernels, their plain versions and torch.bmm at
    one of the path's shapes, each kernel and torch.bmm in turns; each
    kernel must be faster than torch.bmm."""
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
        r["ms"], r["library_ms"] = time_pair_ms(kern, lib, 2 * reps)
        r["plain_ms"] = time_ms(plain, reps)
        r["bound_ms"], r["bound_by"] = bound(*work, shape["dtype"])
        print(f"  {name} at E={shape['e']} M={shape['m']} K={shape['k']} "
              f"N={shape['n']}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} "
              f"ms (kernel / bmm {r['ms'] / r['library_ms']:.3f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{work[0] / r['ms'] / 1e9:.2f} TFLOP/s", flush=True)
    slow = [n for n in GMM if results[n]["ms"] >= results[n]["library_ms"]]
    if slow:
        raise SystemExit(f"{slow} not faster than torch.bmm at {shape}")


def scan_work(name, b, s, d, a_dtype, x_dtype):
    """(FLOPs, bytes) of one scan at this shape: forward reads a and x
    and writes h (a multiply and an add a step); backward reads a, h and
    g and writes da and dx (three operations a step)."""
    n = b * s * d
    el = lambda dt: torch.tensor([], dtype=dt).element_size()
    if name == "rglru_fwd":
        return 2 * n, n * (el(a_dtype) + 2 * el(x_dtype))
    return 3 * n, n * (2 * el(a_dtype) + 3 * el(x_dtype))


# the chunk edges check_rglru adds, at the chunk length L the wrapper
# picks: whether (b, s, d, L) is the case it stands for
SCAN_EDGES = {
    "S a multiple of L": lambda b, s, d, L: s % L == 0 and s > L,
    "S = L + 1": lambda b, s, d, L: s == L + 1,
    # one lane a thread (the kernels take 4 where D is a multiple of 4),
    # the last block's lanes masked, and a short last chunk
    "B > 1, D no multiple of 4, ragged S":
        lambda b, s, d, L: b > 1 and d % 4 != 0 and s % L != 0}


def check_rglru(rg):
    """Both scan kernels against their plain versions at the
    RecurrentGemma path's shape, at ragged small shapes and at the edges
    of the chunk length rg.chunk_len picks (SCAN_EDGES); the workspace
    each leaves (each chunk's product and carry) against the plain
    passes. Returns the path-shape results by kernel name."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(RG_SCAN),
             dict(RG_SCAN, a_dtype=bf16, x_dtype=bf16),
             dict(b=3, s=37, d=50, a_dtype=f32, x_dtype=f32),
             dict(b=2, s=130, d=65, a_dtype=f32, x_dtype=f32),
             dict(b=3, s=37, d=50, a_dtype=bf16, x_dtype=bf16),
             dict(b=2, s=130, d=65, a_dtype=f32, x_dtype=bf16),
             dict(b=2, s=130, d=65, a_dtype=bf16, x_dtype=f32),
             dict(b=2, s=256, d=96, a_dtype=f32, x_dtype=f32,
                  edge="S a multiple of L"),
             dict(b=2, s=17, d=96, a_dtype=bf16, x_dtype=f32,
                  edge="S = L + 1"),
             dict(b=4, s=1000, d=2570, a_dtype=f32, x_dtype=f32,
                  edge="B > 1, D no multiple of 4, ragged S"),
             dict(b=3, s=300, d=130, a_dtype=f32, x_dtype=bf16,
                  edge="B > 1, D no multiple of 4, ragged S")]
    gen = torch.Generator(device="cuda").manual_seed(2468)
    results = {}
    rel = lambda g, w: ((g.float() - w.float()).abs().max()
                        / w.float().abs().max().clamp(min=1e-30)).item()
    for c in cases:
        b, s, d, adt, xdt = (c[k] for k in ("b", "s", "d", "a_dtype",
                                            "x_dtype"))
        L = rg.chunk_len(b, s, d)
        if "edge" in c and not SCAN_EDGES[c["edge"]](b, s, d, L):
            raise SystemExit(f"B={b} S={s} D={d} at chunk {L} is not the "
                             f"case {c['edge']!r}")
        # the model's decays: a in [0.9, 1), long memories
        a = (0.9 + 0.1 * torch.rand(b, s, d, device="cuda",
                                    generator=gen)).to(adt)
        x = torch.randn(b, s, d, device="cuda", generator=gen).to(xdt)
        g = torch.randn(b, s, d, device="cuda", generator=gen).to(xdt)
        with unwritten_is_nan():
            h = rg.rglru_fwd(a, x)
            da, dx = rg.rglru_bwd(a, h, g)
        torch.cuda.synchronize()
        want = {"rglru_fwd": [rg.rglru_fwd_ref(a, x)],
                "rglru_bwd": list(rg.rglru_bwd_ref(a, h, g))}
        got = {"rglru_fwd": [h], "rglru_bwd": [da, dx]}
        with unwritten_is_nan():
            h2 = rg.rglru_fwd(a, x)
            da2, dx2 = rg.rglru_bwd(a, h, g)
        repeat = torch.equal(h, h2) and torch.equal(da, da2) and \
            torch.equal(dx, dx2)
        errs, rels = {}, {}
        for n in SCAN:
            for gt, w in zip(got[n], want[n]):
                if gt.shape != w.shape or gt.dtype != w.dtype:
                    raise SystemExit(f"{n}: {tuple(gt.shape)} {gt.dtype} "
                                     f"against {tuple(w.shape)} {w.dtype}")
            errs[n] = max((gt.float() - w.float()).abs().max().item()
                          for gt, w in zip(got[n], want[n]))
            rels[n] = max(rel(gt, w) for gt, w in zip(got[n], want[n]))
        # the workspaces: products and carries against the plain passes
        with unwritten_is_nan():
            ws_f = rg._launch_fwd(a, x, L)[1]
            ws_b = rg._launch_bwd(a, h, g, L)[2]
        torch.cuda.synchronize()
        A, X = rg.rglru_fwd_reduce_ref(a, x, L)
        P, G = rg.rglru_bwd_reduce_ref(a, g, L)
        ws_rel = max(rel(gt, w) for gt, w in (
            (ws_f[0], A), (ws_f[1], rg.rglru_carry_ref(A, X)),
            (ws_b[0], P), (ws_b[1], rg.rglru_carry_ref(P, G, reverse=True))))
        del ws_f, ws_b, A, X, P, G
        tol = SCAN_F32_TOL if bf16 not in (adt, xdt) else SCAN_BF16_TOL
        label = (f"B={b} S={s} D={d} a {str(adt)[6:]} x {str(xdt)[6:]}, "
                 f"chunk {L}" + (f" ({c['edge']})" if "edge" in c else ""))
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (rel {rels[n]:.2e}, tol {tol:g})"
            for n in SCAN) + f", workspace rel {ws_rel:.2e}, bitwise "
            f"repeat {repeat}", flush=True)
        if not repeat or ws_rel > tol or \
                not all(rels[n] <= tol for n in SCAN):
            raise SystemExit(f"RG-LRU scan check failed at {label}")
        if c == RG_SCAN:
            results = {n: {"max_abs_err": errs[n]} for n in SCAN}
            time_rglru(rg, results, c, a, x, h, g)
        del a, x, g, h, da, dx, h2, da2, dx2, want, got
    return results


def time_rglru(rg, results, shape, a, x, h, g):
    calls = {"rglru_fwd": (lambda: rg.rglru_fwd(a, x),
                           lambda: rg.rglru_fwd_ref(a, x)),
             "rglru_bwd": (lambda: rg.rglru_bwd(a, h, g),
                           lambda: rg.rglru_bwd_ref(a, h, g))}
    # device time of each pass: the median over five calls of each
    # kernel in one profiler run
    from torch.profiler import ProfilerActivity, profile
    for name, (kern, _) in calls.items():
        kern()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kern()
            torch.cuda.synchronize()
        passes = {}
        for n, us in device_kernels(prof):
            if "rglru" in n:
                passes.setdefault(re.search(r"rglru_\w+?_kernel", n)
                                  .group(0), []).append(us)
        print(f"  {name} passes (device ms, median of the calls "
              f"recorded): " + (", ".join(
                  f"{n} {statistics.median(us) / 1e3:.4f} ({len(us)})"
                  for n, us in passes.items()) or "not measured"),
              flush=True)
    for name, (kern, plain) in calls.items():
        r = results[name]
        r["ms"] = time_ms(kern, 20)
        r["plain_ms"] = time_ms(plain, 3)
        # no single PyTorch call computes a linear recurrence
        r["library_ms"] = None
        work = scan_work(name, **shape)
        r["bound_ms"], r["bound_by"] = bound(*work, shape["a_dtype"])
        first = RGLRU_FIRST_MS[name]
        print(f"  {name} at B={shape['b']} S={shape['s']} D={shape['d']}, "
              f"chunk {rg.chunk_len(shape['b'], shape['s'], shape['d'])}: "
              f"{r['ms']:.4f} ms (first design {first:.4f} ms, "
              f"{first / r['ms']:.2f}x), plain {r['plain_ms']:.4f} ms, "
              f"library none, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); {work[1] / r['ms'] / 1e9:.2f} TB/s",
              flush=True)


def mlstm_work(name, bh, s, k, chunk, dtype):
    """(FLOPs, bytes) one mLSTM kernel needs at this shape, per (head,
    chunk) summed: products over the causal pairs s <= t only; each
    input read once, each output written once (the forward's outputs
    include the per-chunk states and each row's m_loc and den)."""
    nc, L = s // chunk, chunk
    pairs = L * (L + 1) // 2
    el = torch.tensor([], dtype=dtype).element_size()
    row = bh * s * k                       # elements of one (BH, S, K)
    gates = bh * s * 4                     # one (BH, S) f32 array
    states = bh * nc * (k * k + k + 1) * 4
    if name == "mlstm_fwd":    # q C, C update; q k^T, (D * qk) v; q.n, n
        flops = bh * nc * (4 * L * k * k + 4 * k * pairs + 4 * L * k)
        return flops, 4 * row * el + 2 * gates + states + 2 * gates
    if name == "mlstm_bwd_dqdk":
        # C dnum, dC v, dC update; v dnum^T, dP k, dP^T q; dh.h, n, dn
        flops = bh * nc * (6 * L * k * k + 6 * k * pairs + 6 * L * k)
        return flops, (5 * row * el + 4 * gates + states
                       + 2 * row * 4)
    # dv: k dC; q k^T, P'^T dh; q.dq, k.dk. Reads q, k, dh, dq, dk, the
    # dC workspace once, log_i, m_loc and the workspace's F, w and
    # denominator; writes dv, dlog_i, dlog_f
    flops = bh * nc * (2 * L * k * k + 4 * k * pairs + 4 * L * k)
    return flops, (3 * row * el + 2 * row * 4 + bh * nc * k * k * 4
                   + 5 * gates + row * 4 + 2 * gates)


def mlstm_inputs(gen, bh, s, k, dtype):
    """q, k, v ~ N(0, 1) in `dtype`; log_i ~ N(1, 1), log_f =
    log_sigmoid(N(3, 1)) (the model's forget bias is 3), f32: the floor
    exp(-m_loc) wins on some rows and |den| on the others."""
    rnd = lambda *sh: torch.randn(*sh, device="cuda", generator=gen)
    q, kk, v = (rnd(bh, s, k).to(dtype) for _ in range(3))
    li = rnd(bh, s) + 1.0
    lf = torch.nn.functional.logsigmoid(rnd(bh, s) + 3.0)
    return q, kk, v, li, lf


def check_mlstm(ml):
    """The three mLSTM kernels against their plain versions at the
    xLSTM-350M path's shape, at seq 4096, at a bf16 shape and at short
    shapes with chunks below 64 (the path's apply_mlstm passes min(64,
    S)). The backward kernels run twice: on the plain forward's outputs,
    which the plain backward reads too, and on the forward kernel's own,
    as in training; both are held against the plain backward. Returns
    the path-shape results."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(XL_MLSTM), dict(XL_MLSTM, s=4096),
             dict(bh=4, s=1024, k=512, chunk=64, dtype=bf16),
             dict(bh=3, s=96, k=128, chunk=32, dtype=f32),
             dict(bh=2, s=120, k=64, chunk=40, dtype=f32),
             dict(bh=2, s=60, k=192, chunk=20, dtype=f32),
             dict(bh=2, s=96, k=64, chunk=16, dtype=bf16)]
    gen = torch.Generator(device="cuda").manual_seed(1357)
    results = {}
    for c in cases:
        bh, s, k, chunk, dt = (c[x] for x in ("bh", "s", "k", "chunk",
                                               "dtype"))
        ins = mlstm_inputs(gen, bh, s, k, dt)
        dh = torch.randn(bh, s, k, device="cuda", generator=gen).to(dt)
        rh, raux = ml.mlstm_fwd_ref(*ins, chunk)
        with unwritten_is_nan():
            h, aux = ml.mlstm_fwd(*ins, chunk)
            grads = ml.mlstm_bwd(*ins, rh, dh, raux, chunk)
            own = ml.mlstm_bwd(*ins, h, dh, aux, chunk)
        torch.cuda.synchronize()
        rgrads = ml.mlstm_bwd_ref(*ins, rh, dh, raux, chunk)
        floor = float((raux[4].abs() < torch.exp(-raux[3])).float().mean())
        C_st, n_st, m_st, m_loc, den = aux
        rC, rn, rm, rml, rd = raux
        # every chunk's m after the first, which both start at -1e30
        if not torch.equal(m_st[:, 0], rm[:, 0]):
            raise SystemExit("mlstm_fwd: the first chunk's m is not -1e30")
        got = {"mlstm_fwd": [h, C_st, n_st, m_st[:, 1:], m_loc, den],
               "mlstm_bwd_dqdk": list(grads[:2]) + list(own[:2]),
               "mlstm_bwd_dv": list(grads[2:]) + list(own[2:])}
        want = {"mlstm_fwd": [rh, rC, rn, rm[:, 1:], rml, rd],
                "mlstm_bwd_dqdk": list(rgrads[:2]) * 2,
                "mlstm_bwd_dv": list(rgrads[2:]) * 2}
        errs, rels = {}, {}
        for n in MLSTM:
            for g, w in zip(got[n], want[n]):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise SystemExit(f"{n}: {tuple(g.shape)} {g.dtype} "
                                     f"against {tuple(w.shape)} {w.dtype}")
            errs[n] = max((g.float() - w.float()).abs().max().item()
                          for g, w in zip(got[n], want[n]))
            rels[n] = max(((g.float() - w.float()).abs().max()
                           / w.float().abs().max().clamp(min=1e-30)).item()
                          for g, w in zip(got[n], want[n]))
        del rgrads, want, own
        # the dq/dk kernel's workspace, dC and dn at each chunk's end,
        # against the plain reverse pass; the dv kernel, from that dC and
        # its row workspace, against its plain pass on the same dC, dq, dk
        rel = lambda g, w: ((g - w).abs().max()
                            / w.abs().max().clamp(min=1e-30)).item()
        with unwritten_is_nan():
            dq, dk, dC, dn, ws = ml._launch_dqdk(*ins, rh, dh, raux, chunk)
            dv_pass = ml.mlstm_bwd_dv(ins[0], ins[1], ins[3], ins[4], rh, dh,
                                      raux, dC, dq, dk, chunk, ws=ws)
        torch.cuda.synchronize()
        rdC, rdn = ml.mlstm_bwd_dC_ref(ins[0], ins[3], ins[4], rh, dh, raux,
                                       chunk)
        dC_rel = max(rel(g, w) for g, w in ((dC, rdC), (dn, rdn)))
        del rdC, rdn
        dv_rel = max(rel(g, w) for g, w in zip(dv_pass, ml.mlstm_bwd_dv_ref(
            ins[0], ins[1], ins[3], ins[4], rh, dh, raux, dC, dq, dk, chunk)))
        del dq, dk, dC, dn, ws, dv_pass
        with unwritten_is_nan():
            h2, aux2 = ml.mlstm_fwd(*ins, chunk)
            grads2 = ml.mlstm_bwd(*ins, rh, dh, raux, chunk)
        repeat = torch.equal(h, h2) and all(
            torch.equal(a, b) for a, b in zip(aux + grads, aux2 + grads2))
        del h2, aux2, grads2
        tol = MLSTM_F32_TOL if dt == f32 else MLSTM_BF16_TOL
        label = (f"BH={bh} S={s} K={k} chunk={chunk} {str(dt)[6:]} "
                 f"(floor wins on {floor:.3f} of rows)")
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (rel {rels[n]:.2e}, tol {tol:g})"
            for n in MLSTM) + f", dC workspace rel {dC_rel:.2e}, dv pass "
            f"on it rel {dv_rel:.2e}, bitwise repeat {repeat}", flush=True)
        if not repeat or dC_rel > tol or dv_rel > tol or \
                not all(rels[n] <= tol for n in MLSTM):
            raise SystemExit(f"mLSTM check failed at {label}")
        if c == XL_MLSTM:
            results = {n: {"max_abs_err": errs[n]} for n in MLSTM}
            time_mlstm(ml, results, c, ins, rh, dh, raux)
        del ins, dh, h, aux, rh, raux, grads, got
    return results


def time_mlstm(ml, results, shape, ins, h, dh, aux):
    bh, s, k, chunk = shape["bh"], shape["s"], shape["k"], shape["chunk"]
    q, kk, v, li, lf = ins
    dq, dk, dv = (torch.empty(bh, s, k, device="cuda") for _ in range(3))
    dli, dlf = (torch.empty(bh, s, device="cuda") for _ in range(2))
    dC = torch.empty(bh, s // chunk, k, k, device="cuda")
    dn = torch.empty(bh, s // chunk, k, device="cuda")
    ws = torch.empty(ml.WS_ROWS, bh, s, device="cuda")
    dims = (bh, s, k, chunk, 0, k ** -0.5)
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    kern = {
        "mlstm_fwd": lambda: ml.mlstm_fwd(*ins, chunk),
        "mlstm_bwd_dqdk": lambda: ml.launch(
            "mlstm_bwd_dqdk", *ptr(q, kk, v, li, lf, h, dh, *aux, dq, dk, dC,
                                   dn, ws), *dims, device=q.device),
        "mlstm_bwd_dv": lambda: ml.launch(
            "mlstm_bwd_dv", *ptr(q, kk, li, dh, aux[3], dC, ws, dq, dk, dv,
                                 dli, dlf), *dims, device=q.device)}
    # device time of each pass of one call of each kernel, in this order:
    # mlstm_bwd_dv reads what mlstm_bwd_dqdk wrote
    from torch.profiler import ProfilerActivity, profile
    for name in MLSTM:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern[name]()
            torch.cuda.synchronize()
        passes = [(re.search(r"mlstm_\w+?_kernel", n).group(0), us)
                  for n, us in device_kernels(prof) if "mlstm" in n]
        print(f"  {name} passes (device ms): " + ", ".join(
            f"{n} {us / 1e3:.4f}" for n, us in passes), flush=True)
    plain_fwd = time_ms(lambda: ml.mlstm_fwd_ref(*ins, chunk), 3)
    # the plain backward computes all five gradients in one pass
    plain_bwd = time_ms(lambda: ml.mlstm_bwd_ref(*ins, h, dh, aux, chunk),
                        3)
    for name, fn in kern.items():
        r = results[name]
        r["ms"] = time_ms(fn, 5)
        r["plain_ms"] = plain_fwd if name == "mlstm_fwd" else plain_bwd
        # no single PyTorch call computes a chunkwise mLSTM
        r["library_ms"] = None
        work = mlstm_work(name, **shape)
        r["bound_ms"], r["bound_by"] = bound(*work, shape["dtype"])
        first = MLSTM_FIRST_MS[name]
        print(f"  {name} at BH={bh} S={s} K={k} chunk={chunk}: "
              f"{r['ms']:.4f} ms (first design {first:.4f} ms, "
              f"{first / r['ms']:.2f}x), plain {r['plain_ms']:.4f} ms, "
              f"library none, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); {work[0] / r['ms'] / 1e9:.2f} TFLOP/s",
              flush=True)


# a kernel's name, then its template arguments: types (f32, bf16, or a
# substitution S<n>_, which in these kernels' argument lists only ever
# repeats __nv_bfloat16: float is never substituted) and ints or bools
KERNEL_RE = re.compile(r"((?:rglru_|mlstm_)?(?:fwd|bwd)"
                       r"(?:_dkdv|_dqdk|_dq|_dv)?"
                       r"(?:_scalars|_state|_out|_grad|_reduce)?_kernel"
                       r"|rglru_carry_kernel|gmm(?:_mma)?_kernel)"
                       r"(?:I((?:f|13__nv_bfloat16|S\d*_)+)"
                       r"((?:L[ib]\d+E)*)E|(?=E))")


def instance_name(mangled: str):
    """`kernel<dtypes, template ints>` of a mangled kernel instance, or
    None for any other symbol."""
    m = KERNEL_RE.search(mangled)
    if not m:
        return None
    dts = ["f32" if t == "f" else "bf16" for t in
           re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(2) or "")]
    args = re.findall(r"L[ib](\d+)E", m.group(3) or "")
    return f"{m.group(1)}<{', '.join(dts + args)}>"


def ptxas_summary(log: str):
    """(name, spill bytes, line) per kernel instance: ptxas prints the
    spill line of an entry before its register count."""
    name, spills, out = None, (0, 0), []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = instance_name(line)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            out.append((name, sum(spills),
                        f"{name}: {m.group(1)} registers{m.group(2)}, "
                        f"spill stores/loads {spills[0]}/{spills[1]} B"))
            name, spills = None, (0, 0)
    return out


def hmma_counts(lib: Path):
    """Tensor-core instructions (HMMA) per kernel instance in the SASS of
    a built library (cuobjdump --dump-sass)."""
    from torch.utils.cpp_extension import CUDA_HOME
    sass = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"),
                           "--dump-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = instance_name(line)
            if name:
                counts[name] = 0
        elif name and re.search(r"\bHMMA\b", line):
            counts[name] += 1
    return counts


def tensor_core_instances(libs, lib: str, kernels, want: int,
                          without=()) -> None:
    """Fails unless the library `lib` holds exactly `want` kernel
    instances, all of the kernels named in `kernels`, each with HMMA in
    its SASS (but those named in `without`) and no spill bytes."""
    from repro_torch.kernels import _build
    hmma = hmma_counts(_build._target(lib))
    for n, c in sorted(hmma.items()):
        print(f"  sass: {n}: {c} HMMA")
    spilled = [n for n, sp, _ in ptxas_summary(libs.log.get(lib, ""))
               if sp]
    others = [n for n in hmma if n.split("<")[0] not in kernels]
    bare = [n for n, c in hmma.items()
            if not c and n.split("<")[0] not in without]
    if len(hmma) != want or bare or spilled or others:
        raise SystemExit(f"{lib}: HMMA counts {hmma} (want {want} "
                         f"instances of {kernels}, each with HMMA but "
                         f"{without}), spilling {spilled}, others {others}")


# device-time groups of a step's breakdown, matched in this order
GROUPS = (("mLSTM kernels",
           r"mlstm_(fwd|bwd_dqdk|bwd_dv)(_scalars|_state|_out|_grad)?_kernel"),
          ("RG-LRU scan kernels",
           r"rglru_(fwd_reduce|fwd_out|bwd_reduce|bwd_out|carry)_kernel"),
          ("attention kernels", r"\bfwd_kernel|bwd_dkdv_kernel|"
                                r"bwd_dq_kernel"),
          ("grouped matmul kernels", r"gmm_mma_kernel"),
          ("matmul (cuBLAS)", r"gemm|sm90_xmma|cutlass|nvjet"))
# device activity only: the breakdown reads kernels, and a launch-bound
# step (the sLSTM loop) records millions of host events besides
ACTIVITIES = ("CUDA",)


SMALL_US = 10.0
SMALL = f"small kernels (< {SMALL_US:g} us each, as the sLSTM's per-step ops)"
OTHER = "other (elementwise, reductions, copies)"


def device_kernels(prof):
    """(name, microseconds) of every device event of a finished
    torch.profiler run, read from its raw kineto results: building the
    profiler's Python event list takes minutes at millions of launches.
    A scheduled profiler also marks its step on the device's timeline
    ("ProfilerStep#N"): a span, not a kernel, so it is left out."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith("ProfilerStep")]


def breakdown(kernels, label: str, wall_us: float, step_s: float):
    """Device time by kernel and by group from the (name, us) device
    events of one step (device_kernels): the named kernel groups first,
    then any other kernel shorter than SMALL_US (launch-bound work such
    as the sLSTM recurrence's per-step ops on (heads, batch, 256)
    tensors), then cuBLAS, then the rest. The idle share is taken
    against `step_s`, the same step's wall time measured without the
    profiler (its host overhead stretches the profiled wall, not the
    kernels). Returns the device microseconds by group, or None when
    no device time was recorded."""
    by_name, groups = {}, {g: 0.0 for g, _ in GROUPS}
    groups.update({SMALL: 0.0, OTHER: 0.0})
    cublas = GROUPS[-1]
    named = {}                  # kernel name -> its named group, or None
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
        if name not in named:
            named[name] = next((g for g, pat in GROUPS[:-1]
                                if re.search(pat, name, re.I)), None)
        g = named[name]
        if g is None:
            g = (SMALL if us < SMALL_US else cublas[0]
                 if re.search(cublas[1], name, re.I) else OTHER)
        groups[g] += us
    busy = sum(by_name.values())
    if not busy:
        print("  profiler: no device time recorded; breakdown not "
              "measured", flush=True)
        return None
    print(f"  profiled {label}: device busy {busy / 1e3:.1f} ms over "
          f"{len(kernels)} device events; wall {wall_us / 1e3:.1f} ms with "
          f"the profiler on, {step_s * 1e3:.1f} ms without; idle share "
          f"{1 - busy / (step_s * 1e6):.3f}", flush=True)
    for g, us in groups.items():
        print(f"    {g}: {us / 1e3:.1f} ms ({us / busy:.3f} of busy)")
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {us / 1e3:9.1f} ms  {n[:110]}")
    return groups


def profile_step(eng, step_s: float):
    """The breakdown of one train_iteration of the engine."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[getattr(ProfilerActivity, a)
                             for a in ACTIVITIES]) as prof:
        eng.train_iteration()
        torch.cuda.synchronize()
    breakdown(device_kernels(prof), "train_iteration",
              (time.perf_counter() - t0) * 1e6, step_s)


def build_engine(cfg, device, seed=0, dp=2, pp=2, batch=8, seq=32,
                 param_dtype=torch.float32, machines=None, setup=True):
    """The engine every slice drives: a cluster of `machines` (dp * pp
    unless given), set up on the first dp * pp of them unless `setup`
    is False (the Controller's bootstrap_job sets it up itself)."""
    from repro_torch.cluster.node import Cluster
    from repro_torch.cluster.simclock import SimClock
    from repro_torch.core.engine import PipelineEngine
    from repro_torch.core.sandbox import CommHooks
    clock = SimClock()
    eng = PipelineEngine(cfg, dp, pp, batch, seq,
                         Cluster(machines or dp * pp,
                                 device_capacity=80 * 2 ** 30),
                         clock, CommHooks(clock), micro_batches=2,
                         seed=seed, sim_compile_seconds=1.0,
                         param_dtype=param_dtype, device=device)
    if setup:
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


def check_step_reference(cfg, seq: int):
    """make_train_step on the card (kernels) against the CPU (plain
    versions) for two steps at `cfg`, batch 2, f32 parameters: same
    seed, same weights, same batches; losses and grad norms within
    STEP_REF_TOL."""
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.train import data as data_mod
    from repro_torch.train import step as step_mod
    from repro_torch.train.optimizer import AdamCfg
    run = step_mod.RunCfg(adam=AdamCfg(lr=1e-3, warmup_steps=2),
                          param_dtype=torch.float32)
    stream = data_mod.stream_for(cfg, ShapeCfg("ref", "train", seq, 2))
    cpu_state = step_mod.init_state(cfg, run, device="cpu")
    states = {"cuda": step_mod.state_to(cpu_state, "cuda"),
              "cpu": cpu_state}
    stats = {}
    for dev, state in states.items():
        fn = step_mod.make_train_step(cfg, run, device=dev)
        stats[dev] = []
        for i in range(2):
            state, st = fn(state, stream.batch(i))
            stats[dev] += [float(st["loss"]), float(st["grad_norm"])]
    diff = max(abs(a - b) for a, b in zip(stats["cuda"], stats["cpu"]))
    print(f"  {cfg.name} x {cfg.num_layers} layers, seq {seq} (loss, "
          f"grad norm) x 2 steps: cuda {stats['cuda']} cpu {stats['cpu']} "
          f"max diff {diff:.3e} (tol {STEP_REF_TOL:g})", flush=True)
    if not (all(map(math.isfinite, stats["cuda"]))
            and diff <= STEP_REF_TOL):
        raise SystemExit("card train step disagrees with the CPU at "
                         f"{cfg.name}")


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
    want.update({n: 0 for n in SCAN + MLSTM})
    return want


def drive(mods, label, cfg, dp, batch, moe, first_loss,
          param_dtype=torch.float32):
    """The slice twice with one seed: launches as derived, the first loss
    bitwise `first_loss`."""
    print(f"[slice] {label}", flush=True)
    losses, launches = run_slice(mods, cfg, dp, batch, param_dtype,
                                 count=True)
    print(f"  launches in the main path: {launches}", flush=True)
    want = expected_launches(cfg, dp, moe)
    if not all(map(math.isfinite, losses)) or launches != want:
        raise SystemExit(f"slice failed: losses {losses}, launches "
                         f"{launches} (want {want})")
    print(f"  first loss {losses[0]!r}, pinned {first_loss!r}: bitwise "
          f"equal {losses[0] == first_loss}", flush=True)
    if losses[0] != first_loss:
        raise SystemExit(f"{label}: first loss {losses[0]!r} is not the "
                         f"pinned {first_loss!r}")
    print(f"[slice] {label}: second run, same seed", flush=True)
    again, _ = run_slice(mods, cfg, dp, batch, param_dtype, count=False)
    same = again == losses
    print(f"  losses bitwise equal across same-seed runs: {same}",
          flush=True)
    if not same:
        raise SystemExit("same-seed runs disagree")
    return launches, losses


def migration_expected_launches(cfg, dp: int):
    """Launches over phase 8's script at pp=2: four iterations as in
    expected_launches (record and three train calls), plus the shadow
    iterations, each on one micro-batch: the standby's for the first
    role (stage 0: forward, then mid_bwd's recompute and backward) and
    the last (stage 1: last_bwd, forward and backward once), and the
    migration joiner's for the last role. The failure's promotion and
    every state copy launch nothing."""
    per = cfg.num_layers // 2
    want = expected_launches(cfg, dp, moe=False)
    shadow_fwd, shadow_bwd = 2 * per + per + per, per + per + per
    want["flash_fwd"] += shadow_fwd
    want["flash_bwd_dq"] += shadow_bwd
    want["flash_bwd_dkdv"] += shadow_bwd
    return want


def drive_migration(mods, cfg, dp: int, batch: int, card: str, unbroken):
    """Phase 8: the Controller's bootstrap, an expected migration and
    an unexpected failure of GPT-medium on the card, with phase 4's
    engine arguments; its three train(1) losses must be `unbroken`,
    the last three losses of phase 4's first run, bit for bit."""
    from repro_torch.core.controller import Controller
    print(f"[slice] {cfg.name} migration: Controller over dp={dp} pp=2, "
          f"{dp * 2 + 2 + 1} machines, one general standby", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launches()
    eng = build_engine(cfg, "cuda", dp=dp, pp=2, batch=batch, seq=2048,
                       machines=dp * 2 + 2 + 1, setup=False)
    clock = eng.clock
    ctl = Controller(eng, standby_count=1)
    ticks = []
    tick = ctl._tick_checkpoints

    def timed_tick():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0, sum(
            ctl.imc.bytes_for(m) for m in ctl.engine.grid.values())))

    ctl._tick_checkpoints = timed_tick
    script = [
        ("bootstrap_job", lambda: ctl.bootstrap_job(list(range(dp * 2)))),
        ("train(1)", lambda: ctl.train(1)),
        ("expected_migration(grid[(1, 1)])",
         lambda: ctl.expected_migration([eng.grid[(1, 1)]])),
        ("train(1)", lambda: ctl.train(1)),
        ("unexpected_failure(grid[(0, 0)])",
         lambda: ctl.unexpected_failure(eng.grid[(0, 0)])),
        ("train(1)", lambda: ctl.train(1))]
    losses, events = [], []
    for name, fn in script:
        lanes = {ln: clock.lane_total(ln) for ln in ("downtime", "overlap")}
        n_ticks = len(ticks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim = {ln: clock.lane_total(ln) - v for ln, v in lanes.items()}
        tick_s = sum(t for t, _ in ticks[n_ticks:])
        print(f"  {name}: measured {wall:.4f} s wall on the card ({card}), "
              f"between torch.cuda.synchronize() calls, of it "
              f"{tick_s:.4f} s in {len(ticks) - n_ticks} checkpoint "
              f"tick(s); simulated (cost model): downtime lane "
              f"+{sim['downtime']:.6f} s, overlap lane "
              f"+{sim['overlap']:.6f} s", flush=True)
        event = {"event": name, "measured_wall_s": wall,
                 "measured_tick_s": tick_s,
                 "simulated_downtime_lane_s": sim["downtime"],
                 "simulated_overlap_lane_s": sim["overlap"]}
        if isinstance(out, list):
            losses += out
            event["losses"] = out
        elif out is not None:
            rep = {k: getattr(out, k) for k in (
                "downtime", "overlap", "state_path", "promote_s",
                "lost_iterations", "mem_overhead_bytes", "state_bytes",
                "state_transfer_s")}
            print(f"    MigrationReport (simulated, cost model): "
                  + ", ".join(f"{k}={v!r}" for k, v in rep.items()),
                  flush=True)
            how = ("leaver_to_joiner, one packed buffer"
                   if name.startswith("expected") else
                   f"recover_state, path {out.state_path}")
            print(f"    state copy moved {out.state_bytes} B ({how})",
                  flush=True)
            event["report"] = rep
        events.append(event)
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated()
    for i, (t, nbytes) in enumerate(ticks):
        print(f"  checkpoint tick {i}: measured {t:.4f} s wall ({card}), "
              f"{nbytes} B device to host", flush=True)
    print(f"  max_memory_allocated {peak} B ({card})", flush=True)
    print(f"  SimClock totals (simulated, cost model): downtime "
          f"{clock.lane_total('downtime')} s, overlap "
          f"{clock.lane_total('overlap')} s, train "
          f"{clock.lane_total('train')} s", flush=True)
    print(f"  launches in the path: {launches}", flush=True)
    print("  migration: " + json.dumps({
        "card": card, "events": events, "ticks": [
            {"measured_s": t, "bytes": b} for t, b in ticks],
        "max_memory_allocated": peak, "launches": launches}), flush=True)
    want = migration_expected_launches(cfg, dp)
    same = losses == unbroken
    print(f"  losses {losses}, unbroken run's {unbroken}: bitwise equal "
          f"{same}", flush=True)
    del ctl, eng, tick
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        raise SystemExit(f"migration slice: losses {losses} are not the "
                         f"unbroken run's {unbroken}")
    if launches != want:
        raise SystemExit(f"migration slice: launches {launches} (want "
                         f"{want})")
    return launches


# the kernels one layer of each type launches (forward, backward) on the
# launcher's paths
LAYER_KERNELS = {"rglru": (SCAN[:1], SCAN[1:]),
                 "local_attn": (FLASH[:1], FLASH[1:]),
                 "mlstm": (MLSTM[:1], MLSTM[1:])}


def launcher_expected_launches(cfg, steps: int):
    """Launches over `steps` train steps with remat: a period's layers
    run forward twice (the forward, then the recompute in the backward),
    tail layers once; every layer runs backward once."""
    from repro_torch.models.backbone import scan_layout
    period, n_periods, _ = scan_layout(cfg)
    want = {n: 0 for n in FLASH + GMM + SCAN + MLSTM}
    for i, t in enumerate(cfg.layer_types()):
        fwd, bwd = LAYER_KERNELS.get(t, ((), ()))
        for n in fwd:
            want[n] += 2 if i < period * n_periods else 1
        for n in bwd:
            want[n] += 1
    return {n: steps * c for n, c in want.items()}


def run_launcher(mods, argv, count: bool):
    """The launcher's main over `argv`. With `count`, every kernel's
    launch count is zeroed just before and read just after; without,
    the last step is profiled."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.launch import train as launch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if count:
        for mod in mods:
            mod.reset_launches()
    steps = int(argv[argv.index("--steps") + 1])
    traces, on_step, prof = [], None, None
    if not count:
        prof = profile(activities=[getattr(ProfilerActivity, a)
                                   for a in ACTIVITIES],
                       schedule=schedule(wait=steps - 1, warmup=0,
                                         active=1),
                       on_trace_ready=lambda p: traces.append(
                           device_kernels(p)))
        prof.start()
        on_step = lambda step, stats: prof.step()
    t0 = time.perf_counter()
    hist = launch.main(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
    print(f"  launcher wall {wall:.2f} s (init, count_params and steps, "
          f"profiler included); step wall s "
          f"{[h['seconds'] for h in hist]}", flush=True)
    print(f"  losses {[h['loss'] for h in hist]}, grad norms "
          f"{[h['grad_norm'] for h in hist]}", flush=True)
    print(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} B",
          flush=True)
    return hist, launches, traces


def drive_launcher(mods, cfg, argv, label, busy_groups=()):
    """The launcher twice over `argv` with one seed: counted launches
    against the config's, then the last step of the second run
    profiled, in which each group of `busy_groups` must show device
    time; losses bitwise equal across the runs."""
    steps = int(argv[argv.index("--steps") + 1])
    print(f"[slice] {cfg.name}, {cfg.num_layers} layers, {label}",
          flush=True)
    hist, launches, _ = run_launcher(mods, argv, count=True)
    want = launcher_expected_launches(cfg, steps)
    print(f"  launches in the main path: {launches} (want {want})",
          flush=True)
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses)) or launches != want:
        raise SystemExit(f"slice failed: losses {losses}, launches "
                         f"{launches} (want {want})")
    print(f"[slice] {cfg.name}: second run, same seed, last step "
          f"profiled", flush=True)
    again, _, traces = run_launcher(mods, argv, count=False)
    groups = None
    if traces:
        t0 = time.perf_counter()
        groups = breakdown(traces[-1], f"train step {steps}",
                           again[-1]["seconds"] * 1e6, hist[-1]["seconds"])
        print(f"  (breakdown read in {time.perf_counter() - t0:.1f} s)",
              flush=True)
    else:
        print("  profiler: no trace recorded; breakdown not measured",
              flush=True)
    idle = [g for g in busy_groups if not (groups or {}).get(g)]
    if idle:
        raise SystemExit(f"no device time in {idle} in the profiled step")
    same = [h["loss"] for h in again] == losses
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
    from repro_torch.configs import (qwen2_moe_a2_7b, recurrentgemma_2b,
                                     xlstm_350m)
    from repro_torch.configs.gpt import GPT_MEDIUM
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import rglru_scan as rg
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
    for lib in _build.SIGNATURES:
        for _, _, line in ptxas_summary(libs.log.get(lib, "")):
            print(f"  ptxas: {line}")
    # every attention instance (forward, dq, dkdv) and every grouped
    # matmul instance (three products, wide and narrow, f32 and bf16) is
    # built for the tensor cores: each issues HMMA and none spills
    tensor_core_instances(libs, "flash_attention",
                          ("fwd_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel"),
                          3 * len(fa.HEAD_DIMS) * len(fa._DTYPE_CODE))
    tensor_core_instances(libs, "moe_gmm", ("gmm_mma_kernel",),
                          3 * 2 * len(gm._DTYPE_CODE))
    # the mLSTM kernels' passes: their products on the tensor cores
    # (state walks, output, dq/dk and dv passes, f32 and bf16); the scalar
    # passes do no products (dq/dk's per dtype, the forward's and dv's
    # once: they read only f32)
    tensor_core_instances(libs, "mlstm", MLSTM_TC + MLSTM_NO_TC,
                          6 * len(ml._DTYPE_CODE) + 2,
                          without=MLSTM_NO_TC)
    # the scan's passes: four per (a, x) dtype pair and lane width (one
    # or four lanes a thread) and one carry pass, none spilling
    scan = ptxas_summary(libs.log.get("rglru_scan", ""))
    spilled = [n for n, sp, _ in scan if sp]
    others = [n for n, _, _ in scan if n.split("<")[0] not in SCAN_PASSES]
    if len(scan) != 4 * 2 * len(rg._DTYPE_CODE) ** 2 + 1 or spilled or \
            others:
        raise SystemExit(f"rglru_scan: instances {[n for n, _, _ in scan]}, "
                         f"spilling {spilled}, others {others}")

    print("[kernels] against the plain versions", flush=True)
    results = check_kernels(fa)
    results.update(check_gmm(gm))
    results.update(check_rglru(rg))
    results.update(check_mlstm(ml))

    print("[reference] card against the CPU", flush=True)
    check_reference()
    # RecurrentGemma: one period and a two-layer rglru tail, window 16
    # below seq 64; xLSTM: two (mlstm, slstm) periods, seq 200 = three
    # chunks of 64 and a padded fourth, so the state carries
    check_step_reference(recurrentgemma_2b.reduced().replace(num_layers=5),
                         64)
    check_step_reference(xlstm_350m.reduced().replace(num_layers=4), 200)

    mods = (fa, gm, rg, ml)
    gpt = GPT_MEDIUM
    launches, gpt_losses = drive(
        mods, f"GPT-medium, {gpt.num_layers} layers, dp=2 pp=2 mb=2 batch 8 "
        f"seq 2048", gpt, 2, 8, moe=False, first_loss=GPT_FIRST_LOSS)
    mig_launches = drive_migration(mods, gpt, 2, 8, card, gpt_losses[1:])
    # 1.76 G parameters at 2 layers: with f32 layer weights the first
    # Adam update needs more than the card's 80 GB (flat m, v and master
    # beside the weights, their buckets, the gradients and the update's
    # temporaries), so the layer weights are stored in bf16
    qwen = qwen2_moe_a2_7b.CONFIG.replace(num_layers=2)
    moe_launches, _ = drive(mods, f"{qwen.name}, {qwen.num_layers} "
                            f"layers, dp=1 pp=2 mb=2 batch 4 seq 2048, bf16 "
                            f"layer weights", qwen, 1, 4, moe=True,
                            first_loss=MOE_FIRST_LOSS,
                            param_dtype=torch.bfloat16)
    rgc = recurrentgemma_2b.CONFIG
    rg_launches = drive_launcher(mods, rgc, [
        "--arch", rgc.name, "--steps", "3", "--batch", "1", "--seq",
        "4096", "--log-every", "1", "--device", "cuda"],
        "batch 1 seq 4096, launcher defaults (bf16 params, remat)",
        busy_groups=("RG-LRU scan kernels",))
    xl = xlstm_350m.CONFIG
    xl_launches = drive_launcher(mods, xl, [
        "--arch", xl.name, "--steps", str(XL_STEPS), "--batch", "4",
        "--seq", str(XL_SEQ), "--log-every", "1", "--device", "cuda"],
        f"batch 4 seq {XL_SEQ}, launcher defaults (bf16 params, remat)")
    names = FLASH + GMM + SCAN + MLSTM
    by_path = {n: {gpt.name: launches[n],
                   f"{gpt.name} migration": mig_launches[n],
                   qwen.name: moe_launches[n], rgc.name: rg_launches[n],
                   xl.name: xl_launches[n]}
               for n in names}

    print("kernels: " + ", ".join(f"{n} ok" for n in names))
    print(f"whole run {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": sum(by_path[n].values()),
         "launches_by_path": by_path[n],
         **{k: results[n][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
         **({"shapes": results[n]["shapes"]} if "shapes" in results[n]
            else {})}
        for n in names]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
