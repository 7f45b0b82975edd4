"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero):
  1. card: name and power limit, torch and CUDA versions, kernel build,
     each kernel instance's registers and spills (ptxas); every
     attention instance (forward, dq, dkdv at each width pair: one
     width in 16-256, and q.k 192 with v 128), every grouped matmul
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
     (scaled_dot_product_attention for attention on 4-D views, with the
     window as a mask where there is one, run by the first of its fused
     backends that takes the shape (cuDNN, flash, mem-efficient; named,
     and none taking it fails), whose forward flash_fwd must beat at the
     four paths' shapes (at the fifth, Whisper's non-causal encoder at
     S 1500, f32 and bf16, the ratio is printed, not gated); torch.bmm
     for the
     grouped expert matmul, which each of its three kernels must beat at
     both shapes of each MoE path (at a rank's shapes of Qwen's at 1x4,
     f32 and bf16, the times are printed, not gated); both timed in
     turns with the kernel;
     none for the RG-LRU
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
     CPU (plain versions) at the campaign's tiny GPT, at the reduced
     Qwen1.5-MoE config and at the reduced DeepSeek-V2-Lite config with
     the full model's MLA widths, and make_train_step on the card
     against the CPU at the reduced RecurrentGemma config cut to 5
     layers (window 16 below seq 64) and the reduced xLSTM config at 4
     layers (seq 200: three chunks of 64 and a padded fourth);
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
  7. slice, xLSTM: the launcher trains xLSTM-350M at full width, its
     depth cut by --layers from 24 to XL_LAYERS (3 of its 12 (mlstm,
     slstm) periods; d_model 1024, 4 heads of 512 in the mLSTM, vocab
     50304, untied head) for XL_STEPS steps at global batch 4, seq XL_SEQ,
     with RunCfg's defaults;
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
     memory;
  9. campaign (run right after phase 8): the port's campaign harness
     (`core/campaign.py`) drives GPT-medium at full width and depth
     with phase 4's engine arguments (CAMPAIGN_CFG) on the card:
     `reference_run`, then three scenarios of `reduced_matrix(2, 2)`
     (CAMPAIGN_SCENARIOS: a mid-iteration abort with rollback and
     standby promotion, a GPU-granular fault re-sharded through the
     policy layer, a controller crash inside the switch adopted from
     the journal), one at a time, each freed before the next. The
     reference run's losses must equal phase 4's first run's bit for
     bit, every scenario's `loss_parity` must hold (bitwise against the
     card's reference run), its ledger fields (CAMPAIGN_KEYS) must equal
     the sim-exec engine's for the same config, run in this phase
     without a tensor, and each run must launch every attention kernel.
     Per run it prints the wall seconds the card took (measured), the
     seconds of it in checkpoint ticks, the simulated downtime, overlap
     and train lanes, the peak device memory and the launches;
 10. slice, DeepSeek-V2-Lite: PipelineEngine trains it at full
     width (d_model 2048, 16 heads of multi-head latent attention:
     kv_lora_rank 512, q.k 128 + 64 rotary, v 128; 64 experts top-6 plus
     2 shared, d_expert 1408; vocab 102400, untied head), depth cut to 2
     layers, with phase 5's engine arguments and bf16 layer weights;
 11. serve (run last): make_serve_step decodes from empty caches, f32
     weights from a seed: StableLM-2-1.6B at full width and depth (24
     layers, d_model 2048, 32 x 64 heads, vocab 100352) for 64 tokens
     of 8 sequences, caches of 2048 slots; RecurrentGemma-2B at
     full width cut to one period (rglru, rglru, local_attn) past its
     window of 2048 (the ring cache wraps); xLSTM-350M at full width and
     depth (the carried mLSTM and sLSTM states); DeepSeek-V2-Lite at full
     width cut to 2 layers (MLA's absorbed decode, decode_moe at E 64).
     Per model: the first decode runs under set_sync_debug_mode("error")
     (a host sync fails it), a second from slot buffers filled with NaN
     must equal it bit for bit (same seed, and no unwritten slot read),
     then make_prefill_step on the same tokens (the path's forward
     kernels); decode against prefill within SERVE_TOL, except
     DeepSeek's, where apply_moe drops tokens over capacity and
     decode_moe never does: its decode is held against the CPU's at the
     reduced config instead (SERVE_REF_TOL). StableLM also decodes a
     third time plainly (bitwise) and once with a bf16 cache (reported).
     Whisper-medium at full width and depth (24 + 24 layers, 448
     self-cache slots, batch 4, 32 tokens): setup_cross_cache runs the
     encoder (the kernels, non-causal) over seeded f32 frames and fills
     the cross K/V before each decode (the NaN-filled run's cross buffers
     are NaN until it), and the prefill takes the same frames.
     Printed: ms per token, tokens/s (B * N over the decode loop's wall
     time between synchronizations) and the peak device memory;
 12. slice, Whisper-medium (run after phase 10, before phase 11): the
     launcher trains it at full width and depth (24 enc_attn encoder
     layers over 1500 frames, 24 attn_cross decoder layers; d_model
     1024, 16 x 64 heads, d_ff 4096, vocab 51865, untied head;
     1,012,314,112 parameters) for 3 steps at global batch 8, seq 448
     (Whisper's text context), with RunCfg's defaults (bf16 parameters,
     remat) and train/data.py's f32 frames, so the encoder runs in f32;
     the profiled step must show device time in the encoder's
     non-causal flash_fwd (its f32 d-64 instance, which only the
     encoder launches: the bf16 decoder's causal self-attention runs
     the bf16 one);
 13. meshes (run after phase 12, before phase 11), one rank per card
     the script finds. On one card: the launcher trains each model of
     MESH_ONE at full width for MESH_STEPS steps (StableLM-2-1.6B 4
     layers, batch 4, seq 2048; Qwen1.5-MoE-A2.7B and DeepSeek-V2-Lite
     2 layers, batch 2, seq 2048; xLSTM-350M one (mlstm, slstm) period,
     batch 4, seq 256; Whisper-medium 2 encoder and 2 decoder layers,
     batch 8, seq 448), all with --mesh 1x1 over one NCCL process group
     (the launches counted), then all with --mesh none: each model's
     losses and grad norms must be bitwise equal. On N > 1 cards: one
     spawned rank per card (NCCL, the process group torchrun would give)
     runs `mesh_jobs(N)`, each job twice with one seed: StableLM-2-1.6B
     full on (N/2)x2, RecurrentGemma-2B full on 1xN (10 q / 1 kv heads
     padded to 12 / 4 slots at N = 4), Qwen1.5-MoE-A2.7B and
     DeepSeek-V2-Lite at full width and depth on 1xN (their experts
     split over the cards; no card holds either whole), the two at 2
     layers on 1xN and (N/2)x2, xLSTM-350M at 4 layers on 1xN and
     Whisper-medium full on 1xN. Then this process runs every job but
     the full MoE ones alone on one card in its mesh's tp layout with no
     mesh (--tp T; one run serves every job whose layout is the same).
     Every rank's launches must equal the config's count, every rank's
     losses and grad norms must be the same within each run and
     finite, the two same-seed runs bitwise equal, and the losses and
     grad norms within MESH_LOSS_TOL and MESH_GNORM_TOL of the
     one-process run's. Per rank it prints the peak memory and the step
     times. `python3 chip_smoke.py --only mesh` builds the kernels and
     runs this phase alone;
 14. serving under meshes (run after phase 13, before phase 11), one
     rank per card the script finds, f32 weights from seed 0. On one
     card: each model of SERVE_MESH at full width (StableLM-2-1.6B 4
     layers, Qwen1.5-MoE-A2.7B and DeepSeek-V2-Lite 2 layers,
     RecurrentGemma-2B one period past its window, xLSTM-350M one
     period, Whisper-medium 2 + 2 layers after setup_cross_cache) is
     served with no mesh, then with `--mesh 1x1` over one NCCL process
     group (make_serve_step under sync debug "error", then
     make_prefill_step; the prefill's kernel launches counted): the
     decode logits, the prefill logits and the cache after the last
     token (gathered through cache_shardings) must be bitwise equal,
     and the launches the config's count. On N > 1 cards: one spawned
     rank per card serves Yi-34B at full width and depth (60 layers,
     56 q / 8 kv heads of 128, d_ff 20480; about 140 GB in f32, which
     no card holds) on 1xN, YI_SERVE tokens: the f32 decode with no
     host sync, a rerun from NaN-filled slot buffers bitwise equal, the
     prefill on the same tokens, decode against prefill within
     SERVE_TOL, then bf16 weights and cache (finite, a same-seed rerun
     bitwise; against the f32 logits reported); ms per token, tokens/s
     and peak memory per rank. Then every SERVE_MESH model on 1xN and
     StableLM also on (N/2)x2, twice each: the ranks' gathered logits
     equal, the two runs bitwise, the launches the config's count, and
     the logits within SERVE_MESH_TOL of one process on one card in the
     same tp layout. `python3 chip_smoke.py --only serve-mesh` builds
     the kernels and runs this phase alone;
 15. dry-run (run last, after phase 11; `launch/dryrun.py`, the step
     run once on `meta` tensors as rank 0 of a fake process group, no
     kernel launched): the card's total_memory, which the dry-run's
     budget H100_HBM_BYTES must not exceed; `run_cell` for
     qwen2-moe-a2.7b train_4k on 16x16 and yi-34b decode_32k on
     2x16x16, each `ok`; the dry-run's predicted peak for phase 6's
     launcher run (RecurrentGemma-2B, batch 1, seq 4096, RunCfg's
     defaults, no mesh) and for phase 11's StableLM-2-1.6B decode (batch
     8, 2048 slots, f32 weights and cache), each within DRYRUN_PEAK_TOL
     of the max_memory_allocated those phases measured (phase 11's up to
     the end of its first decode run); phase 6's
     predicted FLOPs over its fastest measured step no more than the
     card's bf16 peak rate (PEAK_FLOPS); on N > 1 cards, phase 14's
     Yi-34B f32 on 1xN beside its prediction (printed, not gated). Under
     60 s.
Each engine slice runs setup, record_iteration and 3 x train_iteration
twice with the same seed; the launcher slices run the launcher twice.
Losses must be bitwise equal across the two runs, and the GPT, MoE and
DeepSeek slices' first losses equal the pinned ones (GPT_FIRST_LOSS,
MOE_FIRST_LOSS, DS_FIRST_LOSS). Every
kernel's launch count is zeroed just before a path's first run and read
just after it, and must equal the count derived from the config. The
last lines are a JSON line per kernel result, the card line, and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# first loss of the DeepSeek-V2-Lite slice, pinned to the attention
# forward at the width pair (fwd_kernel, q.k 192, v 128, f32) and gmm_fwd
DS_FIRST_LOSS = 11.909626483917236
# H100 SXM peaks (NVIDIA data sheet, dense), HBM3 bandwidth. f32: the
# TF32 tensor-core rate of 495 TFLOP/s over the three products that keep
# f32 accuracy (3xTF32, as the attention backward runs), the card's
# fastest route at f32 accuracy; the 67 TFLOP/s of the CUDA cores would
# be a bound that such a kernel can beat, which is no bound. bf16: the
# tensor cores.
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# the main paths' attention: micro-batch 2, seq 2048; GPT-medium 16 x 64
# heads (timed for the JSON line), Qwen1.5-MoE 16 x 128 heads;
# DeepSeek-V2-Lite's multi-head latent attention, 16 heads of q.k width
# 128 + 64 and v width 128 (`d` is the q.k width, `dv` the v width where
# it differs)
SLICE = dict(bh=2 * 16, s=2048, d=64, dtype=torch.float32, causal=True,
             window=0)
MOE_ATTN = dict(SLICE, d=128)
MLA_ATTN = dict(SLICE, d=192, dv=128)
# RecurrentGemma-2B's local attention: batch 1 x 10 q heads (the one kv
# head expanded), seq 4096, head dim 256, window 2048, bf16 activations
RG_ATTN = dict(bh=10, s=4096, d=256, dtype=torch.bfloat16, causal=True,
               window=2048)
# Whisper-medium's encoder: batch 8 x 16 heads of 64, non-causal over
# its 1500 frames (no multiple of any tile), f32 under the launcher's
# f32 frames and bf16 under bf16 frames; timed, not gated against SDPA
ENC_ATTN = dict(bh=8 * 16, s=1500, d=64, dtype=torch.float32,
                causal=False, window=0)
ENC_ATTN_BF16 = dict(ENC_ATTN, dtype=torch.bfloat16)
# its training slice: launcher steps, batch and text context
WH_STEPS, WH_BATCH, WH_SEQ = 3, 8, 448
# the kernel instance only its encoder launches in that slice: the f32
# forward at d 64 (f32 frames; the decoder's self-attention is bf16)
ENC_FWD_KERNEL = r"\bfwd_kernel<float, 64, 64,"
# its RG-LRU scans: batch 1, seq 4096, width 2560, f32 gates
RG_SCAN = dict(b=1, s=4096, d=2560, a_dtype=torch.float32,
               x_dtype=torch.float32)
# the MoE path's expert products: 60 experts, B*C = 2 * 171 tokens;
# gate/up (E, M, K) @ (E, K, N), down with K and N swapped
GMM_SLICE = dict(e=60, m=342, k=2048, n=1408, dtype=torch.float32)
GMM_DOWN = dict(GMM_SLICE, k=1408, n=2048)
# the DeepSeek path's: 64 experts, B*C = 2 * 240 tokens
GMM_DS = dict(GMM_SLICE, e=64, m=480)
GMM_DS_DOWN = dict(GMM_DS, k=1408, n=2048)
# a rank's expert products in phase 13's Qwen1.5-MoE-A2.7B at 1x4: 15
# of its 60 experts, B*C = 4 * 171 tokens, bf16 under the launcher (f32
# too, at the f32 tolerance); timed beside torch.bmm, not gated
GMM_RANK = [dict(GMM_SLICE, e=15, m=684, dtype=dt, **kn)
            for dt in (torch.float32, torch.bfloat16)
            for kn in ({}, dict(k=1408, n=2048))]
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
# its depth on that path: a quarter of its 24 layers, for the script's
# time limit (the sLSTM's Python loop holds a step at 61-89 s at full
# depth; at 12 layers the phase took 271 s and the script 1209 s on a
# slow host, PERF.md §6); phase 11 serves it at full depth
XL_LAYERS = 6
# phase 13, meshes: launcher steps; on one card (1x1 against none) each
# model at full width with its launcher arguments, depth and sequence
# cut for the script's time (the sLSTM's loop grows with the sequence)
MESH_STEPS = 3
MESH_ONE = (("stablelm-1.6b", ["--layers", "4", "--batch", "4", "--seq",
                               "2048"]),
            ("qwen2-moe-a2.7b", ["--layers", "2", "--batch", "2", "--seq",
                                 "2048"]),
            ("deepseek-v2-lite-16b", ["--layers", "2", "--batch", "2",
                                      "--seq", "2048"]),
            ("xlstm-350m", ["--layers", "2", "--batch", "4", "--seq",
                            "256"]),
            ("whisper-medium", ["--layers", "2", "--encoder-layers", "2",
                                "--batch", str(WH_BATCH), "--seq",
                                str(WH_SEQ)]))
MOE_ARGS = ["--batch", "4", "--seq", "2048"]


def mesh_jobs(n: int) -> list:
    """Phase 13's runs on n > 1 cards, (arch, mesh, launcher arguments,
    whether one process on one card runs it too for comparison): at 1xn
    a rank of Qwen1.5-MoE-A2.7B or DeepSeek-V2-Lite at full depth holds
    a quarter of its 14.3 G or 16.2 G parameters, and no card holds the
    whole with its Adam state."""
    moe = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
    # the full MoE models first, while the rank's allocator is fresh
    return [*[(arch, f"1x{n}", MOE_ARGS, False) for arch in moe],
            ("stablelm-1.6b", f"{n // 2}x2", ["--batch", "4", "--seq",
                                             "2048"], True),
            ("recurrentgemma-2b", f"1x{n}", ["--batch", "1", "--seq",
                                             "4096"], True),
            *[(arch, mesh, MOE_ARGS + ["--layers", "2"], True)
              for arch in moe
              for mesh in dict.fromkeys((f"1x{n}", f"{n // 2}x2"))],
            ("xlstm-350m", f"1x{n}", ["--layers", "4", "--batch", "4",
                                      "--seq", "512"], True),
            ("whisper-medium", f"1x{n}", ["--batch", str(WH_BATCH), "--seq",
                                          str(WH_SEQ)], True)]


# a mesh's losses and grad norms against one process in the same
# layout: |mesh - one| over max(1, |one|), and |mesh - one| over |one|.
# bf16 parameters and activations: the partial sums after wo, w_down and
# w_out are added over `model` in bf16, and the batch's gradients over
# `data` in f32 from bf16 halves, where one process sums each in one
# product. On four H100s (PERF.md §6) sound runs of every job of
# mesh_jobs(4) gave losses within 3.264e-05 and grad norms within
# 7.423e-04 (the embedding's rows summed in f32 on both sides: summed in
# bf16, one token at a time, a 2x2 run's grad norm was up to 8.342e-03
# off one process's);
# ZeRO-1 without the sum over `data` gave 8.747e-03 and 4.155e-01, and
# every data rank on one rank's rows 1.938e-02 and 2.363e-01. A norm
# that counts every copy of a leaf whole on each `model` rank moves by
# 2e-04 only: the CPU tests (f32, 1e-5) catch that one
MESH_LOSS_TOL, MESH_GNORM_TOL = 1e-3, 5e-3
# its mLSTM cells: batch 4 x 4 heads, seq XL_SEQ, head dim 512, chunk
# 64, f32 q, k, v and log gates
XL_MLSTM = dict(bh=16, s=XL_SEQ, k=512, chunk=64, dtype=torch.float32)
# phase 11, serving: per model (batch, decoded tokens, cache slots) and
# the depth it runs at (None: the config's). RecurrentGemma-2B decodes
# 64 tokens past its local attention's window of 2048. Decode is
# host-bound on that machine (about 150 torch ops a layer a token, at
# 2.5-4.6 ms a layer), so the tokens are cut to keep the phase near 60 s
SERVE = {"stablelm-1.6b": (8, 64, 2048, None),
         "recurrentgemma-2b": (2, 2112, 2112, 3),
         "xlstm-350m": (4, 64, 64, None),
         "deepseek-v2-lite-16b": (8, 64, 2048, 2),
         "whisper-medium": (4, 32, 448, None)}
# decode (the plain dense attention over the cache, products at B rows)
# against the prefill forward (the kernels, products at B x N rows) on
# the card, f32 weights and cache: max |decode - prefill| over max(1,
# max |prefill|). Both are f32, but every product sums in another order
# (other cuBLAS kernels at B and B x N rows; the attention kernel's
# 3xTF32 against the plain f32 softmax; the mLSTM's chunks of 64 against
# decode's chunks of 1), compounded over up to 24 layers; the reduced
# configs on the CPU agree to 5.5e-07. A wrong slot, position or mask
# moves the logits by O(0.1)
SERVE_TOL = 1e-3
# the reduced DeepSeek-V2-Lite (MLA's full widths) decoding on the card
# against the CPU: logits, f32 sums in other orders over two layers (the
# engine's bound in check_reference)
SERVE_REF_TOL = 1e-4
# phase 14, serving under meshes: per model (arch, config cuts, batch,
# decoded tokens, cache slots). Full width; depth cut as phase 13 cuts
# it, RecurrentGemma-2B to one period (rglru, rglru, local_attn) as
# phase 11 serves it, decoding 32 tokens past its window of 2048 (the
# ring wraps). Decode is host-bound (2.5-4.6 ms a layer a token, PERF.md
# §5), and each model is served twice on one card: the tokens are cut
# to keep the phase near 60 s, most of it RecurrentGemma's 2080
SERVE_MESH = (("stablelm-1.6b", {"num_layers": 4}, 8, 16, 64),
              ("qwen2-moe-a2.7b", {"num_layers": 2}, 8, 16, 64),
              ("deepseek-v2-lite-16b", {"num_layers": 2}, 8, 16, 64),
              ("recurrentgemma-2b", {"num_layers": 3}, 2, 2080, 2080),
              ("xlstm-350m", {"num_layers": 2}, 4, 16, 64),
              ("whisper-medium", {"num_layers": 2, "encoder_layers": 2},
               4, 16, 448))
# the split serve path's gathered logits against one process on one
# card in the same tp layout, f32 weights and cache: max |mesh - one|
# over max(1, max |one|) within the vocab. The same products, but every
# output projection's partial sums (heads, lanes, experts, the vocab's
# embedding blocks) added over `model` in NCCL's order where one
# process sums them in one GEMM, compounded over up to 4 layers; a
# wrong head, slot or row moves the logits by O(0.1) (PERF.md §6)
SERVE_MESH_TOL = 1e-4
# Yi-34B (arXiv:2403.04652) on N > 1 cards: batch, decoded tokens,
# cache slots. At 1x4 a rank holds 8.6 G of its 34.4 G f32 parameters
# (34 GB) and 2 of its 8 kv heads: 8 x 2048 x 60 x 2 x 2 x 128 x 4 B =
# 2.0 GB of f32 cache (computed from the config)
YI_SERVE = (8, 32, 2048)
# phase 15: a dry-run's predicted peak (the tracked live bytes of the
# step run on `meta`, allocator-rounded, plus cuBLAS's workspace) against
# the max_memory_allocated a phase measured: |predicted / measured - 1|
DRYRUN_PEAK_TOL = 0.10
# what the phases measured, for phase 15: by path, the peak (B) and the
# step times (s) of a launcher run, and the peak (B) up to the end of a
# serve run's first decode
MEASURED: dict = {}
# phase 9: the campaign at GPT-medium with phase 4's engine arguments,
# and the scenarios it drives after the reference run
CAMPAIGN_CFG = dict(arch="gpt-medium", dp=2, pp=2, global_batch=8,
                    seq_len=2048, micro_batches=2, warmup_iters=1,
                    total_iters=3, device_capacity_gb=80)
CAMPAIGN_SCENARIOS = ("fail-first-pre_reduce", "gpu-reshard-first",
                      "crash-mid-switchover")
# the ledger fields of a ScenarioResult that the real and the sim-exec
# engines must give bit for bit
CAMPAIGN_KEYS = ("events", "downtime_s", "overlap_s", "train_s",
                 "migrated_bytes", "delta_fraction", "lost_iterations",
                 "recovery_path", "steps", "resumes", "ckpt_fallbacks",
                 "degraded_events", "regrow_events", "loss_parity")
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
                  window=90),
             # the width pair (q.k 192, v 128): the DeepSeek path's shape,
             # bf16 at a smaller one, and the tiles' edges (S no multiple
             # of the 32- and 64-row tiles, below one tile, a window, no
             # mask)
             dict(MLA_ATTN),
             dict(MLA_ATTN, bh=8, s=512, dtype=torch.bfloat16),
             dict(bh=3, s=130, d=192, dv=128, causal=True, **f32),
             dict(bh=2, s=77, d=192, dv=128, causal=True, **bf16),
             dict(bh=4, s=20, d=192, dv=128, causal=True, **f32),
             dict(bh=2, s=96, d=192, dv=128, causal=False, **bf16),
             dict(bh=3, s=300, d=192, dv=128, causal=True,
                  dtype=torch.float32, window=70),
             dict(bh=2, s=200, d=192, dv=128, causal=True,
                  dtype=torch.bfloat16, window=45),
             # Whisper's encoder: non-causal at S 1500, f32 and bf16
             dict(ENC_ATTN), dict(ENC_ATTN_BF16)]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results, shapes = {}, {n: [] for n in FLASH}
    for c in cases:
        bh, s, d, dt, causal, win = c["bh"], c["s"], c["d"], c["dtype"], \
            c["causal"], c["window"]
        dv = c.get("dv", d)
        q, k, v, do = (torch.randn(bh, s, w, device="cuda", generator=gen)
                       .to(dt) for w in (d, d, dv, dv))
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
        label = (f"bh={bh} s={s} d={d}" + (f" dv={dv}" if dv != d else "")
                 + f" {str(dt)[6:]} {'causal' if causal else 'full'}"
                 + (f" window={win}" if win else ""))
        print(f"  {label}: " + ", ".join(
            f"{n} err {errs[n]:.3e} (tol {tols[n]:g}; rel {rels[n]:.2e}, "
            f"tol {rel_tol:g})" for n in FLASH)
            + f", delta rel {delta_rel:.2e} (tol {F32_FWD_TOL:g}), bitwise "
            f"repeat {repeat}", flush=True)
        if not ok:
            raise SystemExit(f"kernel check failed at {label}")
        if c in (SLICE, MOE_ATTN, MLA_ATTN, RG_ATTN, ENC_ATTN,
                 ENC_ATTN_BF16):
            timed = {n: {"max_abs_err": errs[n]} for n in FLASH}
            time_attention(fa, timed, c, q, k, v, do, o, lse, sc,
                           gate=c not in (ENC_ATTN, ENC_ATTN_BF16))
            for n in FLASH:
                shapes[n].append({"shape": label, **timed[n]})
            if c == SLICE:
                results = timed
        del q, k, v, do, o, lse, grads, delta, o2, lse2, grads2
    for n in FLASH:
        results[n]["shapes"] = shapes[n]
    return results


def time_attention(fa, results, shape, q, k, v, do, o, lse, sc, gate=True):
    """Times of the three kernels, the plain versions and SDPA at one of
    the paths' shapes; flash_fwd and SDPA's forward are timed in turns,
    and with `gate` the kernel must be faster."""
    from torch.nn.attention import sdpa_kernel
    causal, win, reps = shape["causal"], shape["window"], 10
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    common = (shape["bh"], shape["s"], q.shape[-1], v.shape[-1],
              0 if shape["dtype"] == torch.float32 else 1, int(causal),
              win, sc)
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the window as a boolean mask (True = visible); no mask when causal
    # alone says it all
    mask = None
    if win:
        mask = fa._mask(shape["s"], shape["s"], causal, win, q.device)
    is_causal = causal and mask is None
    # SDPA's fused backends take only 4-D (B, H, S, d) operands; on 3-D
    # ones every call runs the unfused math path
    q4, k4, v4, do4 = (t.unsqueeze(0) for t in (q, k, v, do))
    name, backend = sdpa_fused(q4, k4, v4, mask, is_causal)

    def lib(a, b, c):
        with sdpa_kernel(backend):
            return sdpa(a, b, c, attn_mask=mask, is_causal=is_causal,
                        scale=sc)

    results["flash_fwd"]["ms"], results["flash_fwd"]["library_ms"] = \
        time_pair_ms(lambda: fa.flash_fwd(q, k, v, causal, sc, win),
                     lambda: lib(q4, k4, v4), 2 * reps)
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
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q4, k4, v4))
    out = lib(ql, kl, vl)
    # SDPA's backward yields dq, dk and dv from one call
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        out, (ql, kl, vl), do4, retain_graph=True), reps)
    results["flash_bwd_dkdv"]["library_ms"] = lib_bwd
    results["flash_bwd_dq"]["library_ms"] = lib_bwd
    at = (f"d={shape['d']}" + (f" dv={shape['dv']}" if "dv" in shape else "")
          + ("" if causal else f" s={shape['s']} {str(shape['dtype'])[6:]} "
             "non-causal"))
    from repro_torch.kernels.work import attention_work
    for n in FLASH:
        results[n]["bound_ms"], results[n]["bound_by"] = bound(
            *attention_work(n, **shape), shape["dtype"])
        print(f"  {n} at {at}"
              + (f" window={win}" if win else "")
              + f": {results[n]['ms']:.4f} ms, "
              f"plain {results[n]['plain_ms']:.4f} ms, library "
              f"{results[n]['library_ms']:.4f} ms, bound "
              f"{results[n]['bound_ms']:.4f} ms ({results[n]['bound_by']})",
              flush=True)
    pair = results["flash_bwd_dq"]["ms"] + results["flash_bwd_dkdv"]["ms"]
    print(f"  backward pair at {at}: flash_bwd_dq + "
          f"flash_bwd_dkdv {pair:.4f} ms, SDPA ({name}) backward "
          f"{lib_bwd:.4f} ms, ratio {pair / lib_bwd:.3f}", flush=True)
    fwd = results["flash_fwd"]
    print(f"  forward at {at}: flash_fwd / SDPA ({name}) forward "
          f"{fwd['ms'] / fwd['library_ms']:.3f}"
          + ("" if gate else " (not gated)"), flush=True)
    if gate and fwd["ms"] >= fwd["library_ms"]:
        raise SystemExit(f"flash_fwd not faster than SDPA's {name} "
                         f"forward at {shape}")


def sdpa_fused(q, k, v, mask, is_causal):
    """(name, SDPBackend) of the first of SDPA's fused backends (cuDNN,
    flash, mem-efficient) that takes these 4-D operands; the unfused
    math path is no yardstick, so the run fails where none does."""
    from torch.nn.attention import SDPBackend
    cuda = torch.backends.cuda
    params = cuda.SDPAParams(q, k, v, mask, 0.0, is_causal, False)
    for name, backend, takes in (
            ("cuDNN", SDPBackend.CUDNN_ATTENTION,
             cuda.can_use_cudnn_attention),
            ("flash", SDPBackend.FLASH_ATTENTION,
             cuda.can_use_flash_attention),
            ("mem-efficient", SDPBackend.EFFICIENT_ATTENTION,
             cuda.can_use_efficient_attention)):
        if takes(params):
            return name, backend
    raise SystemExit(f"no fused SDPA backend takes q {tuple(q.shape)} "
                     f"{q.dtype}, v {tuple(v.shape)}, mask "
                     f"{mask is not None}")


def gmm_wide(a, b, a_row: int, b_row: int) -> bool:
    """Whether moe_gmm.cu's host code picks the wide (16-byte copy)
    instance of gmm_mma_kernel: both operands' stored rows (a_row, b_row
    elements) a multiple of 16 bytes and both bases 16-byte aligned."""
    el = a.element_size()
    return (a_row * el % 16 == 0 and b_row * el % 16 == 0
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


def gmm_name(name: str):
    """`gmm_mma_kernel<dtype, TA, TB, WIDE>` of a profiler's kernel name,
    mangled or not, or None for any other name."""
    inst = instance_name(name)
    m = re.search(r"(gmm(?:_mma)?_kernel)<([^>]*)>", name)
    if inst is None and m:
        words = {"float": "f32", "__nv_bfloat16": "bf16", "false": "0",
                 "true": "1"}
        args = [words.get(a.strip(), a.strip()) for a in m.group(2).split(",")]
        inst = f"{m.group(1)}<{', '.join(args)}>"
    return inst if inst and inst.startswith("gmm") else None


def gmm_instances(gm, fn, tries: int = 5):
    """The grouped-matmul kernel instances `fn` launches, in launch
    order, from the profiler's events of any device type, ordered by
    start. The profiler has come back with no event at all for three
    launches of a few microseconds and, right after a shape's timed
    calls, without the first of three in three profiles running; so a
    profile with fewer grouped-matmul events than the wrappers counted
    launches (gm.LAUNCHES) is taken again after a pause, up to `tries`
    times, each retry printing what the profile held."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(tries):
        torch.cuda.synchronize()
        time.sleep(0.2 * i)
        before = sum(gm.LAUNCHES.values())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = sum(gm.LAUNCHES.values()) - before
        events = sorted(prof.profiler.kineto_results.events(),
                        key=lambda e: e.start_ns())
        out = [n for n in map(gmm_name, (e.name() for e in events)) if n]
        if len(out) >= launched:
            break
        print(f"  profile {i + 1}: {len(out)} grouped-matmul events for "
              f"{launched} launches, {len(events)} events in all: "
              f"{[(str(e.device_type()), e.name()[:48]) for e in events]}",
              flush=True)
    return out


def check_gmm(gm):
    """The three grouped-matmul kernels against their plain versions at
    the MoE paths' gate/up and down shapes (Qwen1.5-MoE's and
    DeepSeek-V2-Lite's, and a rank's of Qwen's at 1x4, GMM_RANK) and at
    ragged small shapes
    that cut every edge of gmm_mma_kernel's tile (rows no multiple of
    MMA_BM = 128, reductions no multiple of the 32 f32 / 64 bf16 R tile,
    columns no multiple of 8), with the wide and the narrow copies;
    each kernel must run the instance the host's rule picks. Returns
    Qwen's gate/up-shape results by kernel name, every path shape's
    under "shapes"."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [dict(GMM_SLICE), dict(GMM_DOWN), dict(GMM_DS),
             dict(GMM_DS_DOWN),
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
             dict(e=2, m=342, k=40, n=24, dtype=f32), *GMM_RANK]
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
        ran = gmm_instances(gm, run)
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
        if c in (GMM_SLICE, GMM_DOWN, GMM_DS, GMM_DS_DOWN, *GMM_RANK):
            timed = {nm: {"max_abs_err": errs[nm]} for nm in GMM}
            time_gmm(gm, timed, c, x, w, dy, gate=c not in GMM_RANK)
            for nm in GMM:
                shapes[nm].append({"shape": label, **timed[nm]})
            if c == GMM_SLICE:
                results = timed
        del x, w, dy, got, want
    for nm in GMM:
        results[nm]["shapes"] = shapes[nm]
    return results


def time_gmm(gm, results, shape, x, w, dy, gate=True):
    """Times of the three kernels, their plain versions and torch.bmm at
    one of the path's shapes, each kernel and torch.bmm in turns; with
    `gate`, each kernel must be faster than torch.bmm."""
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
    from repro_torch.kernels.work import gmm_work
    work = gmm_work(**shape)
    for name, (kern, plain, lib) in calls.items():
        r = results[name]
        r["ms"], r["library_ms"] = time_pair_ms(kern, lib, 2 * reps)
        r["plain_ms"] = time_ms(plain, reps)
        r["bound_ms"], r["bound_by"] = bound(*work, shape["dtype"])
        print(f"  {name} at E={shape['e']} M={shape['m']} K={shape['k']} "
              f"N={shape['n']} {str(shape['dtype'])[6:]}: {r['ms']:.4f} ms, "
              f"plain "
              f"{r['plain_ms']:.4f} ms, torch.bmm {r['library_ms']:.4f} "
              f"ms (kernel / bmm {r['ms'] / r['library_ms']:.3f}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{work[0] / r['ms'] / 1e9:.2f} TFLOP/s", flush=True)
    slow = [n for n in GMM if results[n]["ms"] >= results[n]["library_ms"]]
    if slow and gate:
        raise SystemExit(f"{slow} not faster than torch.bmm at {shape}")


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
        from repro_torch.kernels.work import scan_work
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
        from repro_torch.kernels.work import mlstm_work
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
    versions) at the campaign's tiny GPT, the reduced Qwen1.5-MoE and
    the reduced DeepSeek-V2-Lite with the full model's MLA widths (q.k
    128 + 64, v 128: its own reduced widths have no kernel): same seed,
    same weights."""
    from repro_torch.configs import qwen2_moe_a2_7b
    from repro_torch.configs.gpt import tiny_gpt
    for cfg in (tiny_gpt(layers=4, d=64, heads=4, vocab=256),
                qwen2_moe_a2_7b.reduced(), ds_reduced()):
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


def ds_reduced():
    """The reference's reduced DeepSeek-V2-Lite at the full model's MLA
    widths, as tests/test_torch_mla.py runs it."""
    from repro_torch.configs import deepseek_v2_lite_16b
    from repro_torch.configs.base import MLACfg
    full = deepseek_v2_lite_16b.CONFIG.mla
    return deepseek_v2_lite_16b.reduced().replace(mla=MLACfg(
        kv_lora_rank=32, q_lora_rank=0, qk_nope_dim=full.qk_nope_dim,
        qk_rope_dim=full.qk_rope_dim, v_head_dim=full.v_head_dim))


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
    backward once. An attn_moe or mla_moe layer makes three expert
    products in each direction."""
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


@contextlib.contextmanager
def timed_ticks(ticks: list):
    """Every Controller's checkpoint tick (a campaign scenario's too, and
    the one a crash's restart builds) timed on the host clock between
    torch.cuda.synchronize() calls: (seconds, bytes held on the host
    for the training machines after it) appended to `ticks`."""
    from repro_torch.core.controller import Controller
    tick = Controller._tick_checkpoints

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tick(self)
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0, sum(
            self.imc.bytes_for(m) for m in self.engine.grid.values())))

    Controller._tick_checkpoints = timed
    try:
        yield
    finally:
        Controller._tick_checkpoints = tick


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
        with timed_ticks(ticks):
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
    del ctl, eng
    gc.collect()
    torch.cuda.empty_cache()
    if not same:
        raise SystemExit(f"migration slice: losses {losses} are not the "
                         f"unbroken run's {unbroken}")
    if launches != want:
        raise SystemExit(f"migration slice: launches {launches} (want "
                         f"{want})")
    return launches


def drive_campaign(mods, card: str, unbroken):
    """Phase 9: the campaign's reference run and CAMPAIGN_SCENARIOS on
    the card, each against the sim-exec engine's run of the same
    config; the reference run's losses must be `unbroken`, phase 4's
    first run's, bit for bit. Returns the launches summed over the
    four runs."""
    from repro_torch.core import campaign
    cfg = campaign.CampaignCfg(**CAMPAIGN_CFG, device="cuda")
    sim_cfg = dataclasses.replace(cfg, mode="sim", device=None)
    by_name = {sc.name: sc for sc in campaign.reduced_matrix(cfg.dp,
                                                             cfg.pp)}
    print(f"[slice] {cfg.arch} campaign: reference_run, then "
          f"{', '.join(CAMPAIGN_SCENARIOS)}", flush=True)
    t0 = time.perf_counter()
    sim_ref = campaign.reference_run(sim_cfg)
    sims = {n: campaign.run_scenario(by_name[n], sim_cfg, sim_ref)
            for n in CAMPAIGN_SCENARIOS}
    print(f"  sim-exec engine, same config: {time.perf_counter() - t0:.2f}"
          f" s on the host, no tensor", flush=True)
    total = {n: 0 for mod in mods for n in mod.LAUNCHES}
    runs, failures, ref = [], [], None
    for name in ("reference_run",) + CAMPAIGN_SCENARIOS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods:
            mod.reset_launches()
        ticks = []
        with timed_ticks(ticks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = (campaign.reference_run(cfg) if ref is None else
                   campaign.run_scenario(by_name[name], cfg, ref))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {n: c for mod in mods for n, c in mod.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated()
        for n, c in launches.items():
            total[n] += c
        tick_s = sum(t for t, _ in ticks)
        run = {"run": name, "card": card, "measured_wall_s": wall,
               "measured_tick_s": tick_s, "ticks": [
                   {"measured_s": t, "bytes": b} for t, b in ticks],
               "max_memory_allocated": peak, "launches": launches}
        print(f"  {name}: measured {wall:.4f} s wall on the card ({card}), "
              f"between torch.cuda.synchronize() calls, of it "
              f"{tick_s:.4f} s in {len(ticks)} checkpoint tick(s) "
              f"({', '.join(f'{t:.4f} s' for t, _ in ticks)}; "
              f"{max((b for _, b in ticks), default=0)} B device to host "
              f"at most); "
              f"max_memory_allocated {peak} B", flush=True)
        if ref is None:
            ref = out
            steps = sorted(ref)
            same = [ref[k] for k in steps[:len(unbroken)]] == \
                unbroken[:len(steps)]
            run["losses"] = [ref[k] for k in steps]
            print(f"    losses {run['losses']}, phase 4's first run's "
                  f"{unbroken}: bitwise equal {same}", flush=True)
            if not same or steps != list(range(1 + cfg.total_iters)):
                failures.append(f"reference_run losses {ref}")
        else:
            got = {k: getattr(out, k) for k in CAMPAIGN_KEYS}
            want = {k: getattr(sims[name], k) for k in CAMPAIGN_KEYS}
            run["result"] = out.to_dict()
            print(f"    simulated (cost model): downtime lane "
                  f"{out.downtime_s!r} s, overlap lane {out.overlap_s!r} s, "
                  f"train lane {out.train_s!r} s; recovery path "
                  f"{out.recovery_path!r}, policy "
                  f"{out.policy_choice!r}; loss_parity {out.loss_parity} "
                  f"(max delta {out.loss_max_delta!r}); ledger fields "
                  f"equal to sim-exec's: {got == want}", flush=True)
            if not out.loss_parity:
                failures.append(f"{name}: loss_parity False")
            if got != want:
                failures.append(f"{name}: ledger {got} is not sim-exec's "
                                f"{want}")
        print(f"    launches {launches}", flush=True)
        idle = [n for n in FLASH if not launches[n]] + \
            [n for n in GMM + SCAN + MLSTM if launches[n]]
        if idle:
            failures.append(f"{name}: launches {launches}")
        runs.append(run)
        del out
    gc.collect()
    torch.cuda.empty_cache()
    print("  campaign: " + json.dumps({"card": card, "runs": runs,
                                       "launches": total}), flush=True)
    if failures:
        raise SystemExit(f"campaign slice: {failures}")
    return total


# the kernels one layer of each type launches on the launcher's paths,
# (forward, backward), each {kernel: launches}: an MoE layer's attention
# and three expert products (gate, up, down), each with its dx and dw in
# the backward; the sLSTM launches none
_ATTN = ({"flash_fwd": 1}, {"flash_bwd_dkdv": 1, "flash_bwd_dq": 1})
_MOE = ({**_ATTN[0], "gmm_fwd": 3},
        {**_ATTN[1], "gmm_bwd_dx": 3, "gmm_bwd_dw": 3})
LAYER_KERNELS = {"attn": _ATTN, "local_attn": _ATTN, "attn_cross": _ATTN,
                 "enc_attn": _ATTN, "attn_moe": _MOE, "mla_moe": _MOE,
                 "rglru": ({"rglru_fwd": 1}, {"rglru_bwd": 1}),
                 "mlstm": ({"mlstm_fwd": 1},
                           {"mlstm_bwd_dqdk": 1, "mlstm_bwd_dv": 1})}


def stacks(cfg):
    """(pattern, layers) of the decoder stack, and of the encoder's where
    the model has one."""
    from repro_torch.models.backbone import ENC_PATTERN
    return [(cfg.block_pattern, cfg.num_layers)] + (
        [(ENC_PATTERN, cfg.encoder_layers)] if cfg.encoder_layers else [])


def launcher_expected_launches(cfg, steps: int):
    """Launches over `steps` train steps with remat: a period's layers
    run forward twice (the forward, then the recompute in the backward),
    tail layers once; every layer runs backward once. The encoder's
    stack counts as the decoder's does."""
    from repro_torch.models.backbone import scan_layout
    want = {n: 0 for n in FLASH + GMM + SCAN + MLSTM}
    for pattern, layers in stacks(cfg):
        period, n_periods, _ = scan_layout(cfg, pattern, layers)
        for i in range(layers):
            fwd, bwd = LAYER_KERNELS.get(pattern[i % period], ({}, {}))
            for n, c in fwd.items():
                want[n] += c * (2 if i < period * n_periods else 1)
            for n, c in bwd.items():
                want[n] += c
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


def drive_launcher(mods, cfg, argv, label, busy_groups=(), busy_kernels=()):
    """The launcher twice over `argv` with one seed: counted launches
    against the config's, then the last step of the second run
    profiled, in which each group of `busy_groups` and each kernel whose
    name matches a pattern of `busy_kernels` must show device time;
    losses bitwise equal across the runs."""
    steps = int(argv[argv.index("--steps") + 1])
    print(f"[slice] {cfg.name}, {cfg.num_layers} layers, {label}",
          flush=True)
    hist, launches, _ = run_launcher(mods, argv, count=True)
    MEASURED[cfg.name] = {"peak": torch.cuda.max_memory_allocated(),
                          "step_s": [h["seconds"] for h in hist]}
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
    for pat in busy_kernels:
        hits = [us for n, us in (traces[-1] if traces else ())
                if re.search(pat, n)]
        print(f"  kernels matching {pat!r}: {len(hits)} launches, "
              f"{sum(hits) / 1e3:.1f} ms of device time", flush=True)
        if not sum(hits):
            idle.append(pat)
    if idle:
        raise SystemExit(f"no device time in {idle} in the profiled step")
    same = [h["loss"] for h in again] == losses
    print(f"  losses bitwise equal across same-seed runs: {same}",
          flush=True)
    if not same:
        raise SystemExit("same-seed runs disagree")
    return launches


def free_port() -> int:
    """A free TCP port on localhost (for a process group's rendezvous)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def mesh_argv(arch: str, mesh: str, args, *extra) -> list:
    return ["--arch", arch, "--steps", str(MESH_STEPS), "--log-every", "1",
            "--device", "cuda", "--mesh", mesh, *args, *extra]


def launcher_config(argv):
    """The config the launcher trains for `argv` (its --arch, --layers
    and --encoder-layers)."""
    from repro_torch.launch import train as launch
    from repro_torch.models import registry
    args = launch.parse_args(argv)
    cfg = registry.get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    if args.encoder_layers is not None:
        cfg = cfg.replace(encoder_layers=args.encoder_layers)
    return cfg


def mesh_one_card(mods) -> dict:
    """Phase 13 on one card: every model of MESH_ONE through the launcher
    with --mesh 1x1 over one NCCL process group (counted), then with
    --mesh none; each model's losses and grad norms bitwise equal."""
    import torch.distributed as dist
    print(f"[mesh] --mesh 1x1 against --mesh none: "
          f"{', '.join(a for a, _ in MESH_ONE)}", flush=True)
    runs = {}
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        print(f"  process group: {dist.get_backend()}, world "
              f"{dist.get_world_size()}", flush=True)
        for arch, args in MESH_ONE:
            t0 = time.perf_counter()
            print(f"[mesh] {arch} {' '.join(args)} --mesh 1x1", flush=True)
            hist, launches, _ = run_launcher(
                mods, mesh_argv(arch, "1x1", args), count=True)
            runs[arch] = [hist, launches, time.perf_counter() - t0]
    finally:
        dist.destroy_process_group()
    found, failures = {}, []
    stats = lambda hs: [(h["loss"], h["grad_norm"]) for h in hs]
    for arch, args in MESH_ONE:
        hist, launches, secs = runs[arch]
        t0 = time.perf_counter()
        print(f"[mesh] {arch} {' '.join(args)} --mesh none", flush=True)
        plain, _, _ = run_launcher(mods, mesh_argv(arch, "none", args),
                                   count=True)
        cfg = launcher_config(mesh_argv(arch, "none", args))
        want = launcher_expected_launches(cfg, MESH_STEPS)
        same = stats(hist) == stats(plain)
        print(f"  {arch}: launches in the mesh path {launches} (want "
              f"{want}); --mesh 1x1 losses and grad norms bitwise --mesh "
              f"none's: {same}; {secs:.1f} s at 1x1, "
              f"{time.perf_counter() - t0:.1f} s with none", flush=True)
        if launches != want or not same or \
                not all(math.isfinite(h["loss"]) for h in hist):
            failures.append(f"{arch}: launches {launches} (want {want}), "
                            f"{stats(hist)} against {stats(plain)}")
        found[f"{cfg.name} {cfg.num_layers} layers mesh 1x1"] = launches
    if failures:
        raise SystemExit(f"mesh 1x1: {failures}")
    return found


def rank_setup(rank: int, world: int, port: int) -> tuple:
    """A spawned rank's start: the environment torchrun gives a rank, its
    card and an NCCL process group; returns the kernel modules."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm as ml
    from repro_torch.kernels import moe_gmm as gm
    from repro_torch.kernels import rglru_scan as rg
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", device_id=torch.device("cuda", rank))
    return fa, gm, rg, ml


def mesh_rank(rank: int, world: int, port: int, jobs: list,
              out_dir: str) -> None:
    """One rank of phase 13 on several cards (spawned, one per card):
    each job's launcher run twice with one seed; what each run gave goes
    to `out_dir`/rank<rank>.json, written anew after each job."""
    mods = rank_setup(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch import train as launch
    out = []
    try:
        for argv in jobs:
            runs = []
            for _ in range(2):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                for mod in mods:
                    mod.reset_launches()
                t0 = time.perf_counter()
                hist = launch.main(argv)
                runs.append({"hist": hist, "wall": time.perf_counter() - t0,
                             "peak": torch.cuda.max_memory_allocated(),
                             "launches": {n: c for mod in mods
                                          for n, c in mod.LAUNCHES.items()}})
            out.append(runs)
            # after every job, so a later job's failure leaves these
            with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def layout(cfg, tp: int) -> list:
    """The shapes of every parameter in the tp layout (padded heads,
    experts and vocab)."""
    from repro_torch.models import backbone
    from repro_torch.tree import tree_leaves
    return [tuple(t.shape) for t in tree_leaves(
        backbone.init_params(cfg, None, tp=tp, device="meta"))]


def mesh_cards(mods, n: int) -> dict:
    """Phase 13 on n > 1 cards: `mesh_jobs(n)` on one spawned rank per
    card, then the compared ones alone on one card in their mesh's
    layout."""
    import shutil
    import torch.multiprocessing as mp
    jobs = mesh_jobs(n)
    argvs = [mesh_argv(a, m, args) for a, m, args, _ in jobs]
    out_dir = ROOT / "build" / "mesh_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    print(f"[mesh] {n} ranks, one per card: " + "; ".join(
        " ".join([a, m, *g]) for a, m, g, _ in jobs), flush=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(n, free_port(), argvs,
                                              str(out_dir)),
                             nprocs=n, start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 900:
                raise SystemExit("mesh ranks timed out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    print(f"  ranks done in {time.perf_counter() - t0:.1f} s", flush=True)
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())
             for r in range(n)]
    found, failures, alone = {}, [], {}
    for j, ((arch, mesh, args, compared), argv) in enumerate(zip(jobs,
                                                                 argvs)):
        cfg = launcher_config(argv)
        want = launcher_expected_launches(cfg, MESH_STEPS)
        label = f"{arch} {cfg.num_layers} layers --mesh {mesh}"
        print(f"[mesh] {label} {' '.join(args)}", flush=True)
        for r, rank in enumerate(ranks):
            for i, run in enumerate(rank[j]):
                print(f"  rank {r} run {i + 1}: peak {run['peak']} B, step "
                      f"wall s {[h['seconds'] for h in run['hist']]}, "
                      f"launcher wall {run['wall']:.2f} s", flush=True)
                if run["launches"] != want:
                    failures.append(f"{label} rank {r}: launches "
                                    f"{run['launches']} (want {want})")
        # per run, every rank's (loss, grad norm) list: the ranks' must
        # be the same, as both are all-reduced
        stats = [[[(h["loss"], h["grad_norm"]) for h in rank[j][i]["hist"]]
                  for rank in ranks] for i in range(2)]
        first, again = stats[0][0], stats[1][0]
        print(f"  (loss, grad norm) {first}; launches a rank "
              f"{ranks[0][j][0]['launches']}", flush=True)
        for i, run in enumerate(stats):
            if any(r != run[0] for r in run) or \
                    len(run[0]) != MESH_STEPS or \
                    not all(math.isfinite(v) for h in run[0] for v in h):
                failures.append(f"{label} run {i + 1}: ranks disagree or "
                                f"not finite: {run}")
        print(f"  two same-seed runs on the mesh bitwise equal: "
              f"{first == again} (largest difference "
              f"{max(abs(a - b) for x, y in zip(first, again) for a, b in zip(x, y)):.3e})",
              flush=True)
        if first != again:
            failures.append(f"{label}: same-seed runs {first} and {again}")
        found[f"{label} (rank 0)"] = ranks[0][j][0]["launches"]
        if not compared:
            continue
        tp = int(mesh.split("x")[-1])
        key = (arch, tuple(args), str(layout(cfg, tp)))
        if key not in alone:
            print(f"[mesh] {arch} {cfg.num_layers} layers alone on one "
                  f"card, --mesh none --tp {tp}", flush=True)
            hist, _, _ = run_launcher(
                mods, mesh_argv(arch, "none", args, "--tp", str(tp)),
                count=True)
            alone[key] = [(h["loss"], h["grad_norm"]) for h in hist]
        else:
            print(f"  tp {tp}'s layout is an earlier one-process run's",
                  flush=True)
        one = alone[key]
        dloss = max(abs(a[0] - b[0]) / max(1.0, abs(b[0]))
                    for a, b in zip(first, one))
        dnorm = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(first, one))
        print(f"  (loss, grad norm) {one}; mesh against one process: "
              f"losses {dloss:.3e} (tolerance {MESH_LOSS_TOL}), grad norms "
              f"{dnorm:.3e} (tolerance {MESH_GNORM_TOL})", flush=True)
        if len(one) != len(first) or not dloss <= MESH_LOSS_TOL or \
                not dnorm <= MESH_GNORM_TOL:
            failures.append(f"{label}: mesh {first} against one process "
                            f"{one}")
    if failures:
        raise SystemExit(f"mesh phase: {failures}")
    return found


def drive_mesh(mods) -> dict:
    """Phase 13 with one rank per card the script finds."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    found = mesh_one_card(mods) if n == 1 else mesh_cards(mods, n)
    print(f"[mesh] phase 13 in {time.perf_counter() - t0:.1f} s", flush=True)
    return found


def kv_buffers(cache) -> list:
    """A decode cache's slot buffers (KV caches, MLA's latent cache):
    what a step may read only where written; and the cross K/V, which
    setup_cross_cache must write whole. Recurrent states are read whole
    and are not among them."""
    if isinstance(cache, dict):
        if "pos" in cache:
            return [t for k, t in cache.items() if k != "pos"]
        return [t for k, v in cache.items() for t in (
            [v] if k in ("cross_k", "cross_v") else kv_buffers(v))]
    if isinstance(cache, (tuple, list)):
        return [t for v in cache for t in kv_buffers(v)]
    return []


@contextlib.contextmanager
def sync_is_error(on: bool):
    """Within, with `on`: any host sync raises
    (torch.cuda.set_sync_debug_mode("error"))."""
    if on:
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        if on:
            torch.cuda.set_sync_debug_mode("default")


def decode_run(cfg, params, tokens, max_len: int, cache_dtype,
               nan_fill=False, sync_check=False, frames=None, mesh=None,
               tp=None):
    """`tokens` (B, N) decoded one at a time on the card through
    make_serve_step from an empty cache of `max_len` slots in
    `cache_dtype` (its slot buffers filled with NaN with `nan_fill`), the
    loop under sync debug "error" with `sync_check`; with `frames`,
    setup_cross_cache fills the cross K/V first. Under `mesh`, params
    hold the rank's blocks, the cache is the rank's, tokens and frames
    are the global batch's and the logits the rank's rows and vocab
    block; without one, `tp` picks the layout (default 1). Returns
    (logits (B, N, V), the loop's wall seconds between
    synchronizations, the cache after the last token)."""
    from repro_torch.models import backbone
    from repro_torch.models.shardings import axis_size, shard
    from repro_torch.train import step as step_mod
    tp = axis_size(mesh, "heads") if mesh is not None else (tp or 1)
    serve = step_mod.make_serve_step(cfg, mesh, tp=tp)
    cache = backbone.init_cache(cfg, tokens.shape[0], max_len, tp,
                                dtype=cache_dtype, mesh=mesh)
    if nan_fill:
        for t in kv_buffers(cache):
            t.fill_(float("nan"))
    if frames is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        backbone.setup_cross_cache(params, cache,
                                   shard(frames, ("batch", None, None), mesh),
                                   cfg, tp, mesh)
        torch.cuda.synchronize()
        print(f"  setup_cross_cache (the encoder over {frames.shape[1]} "
              f"frames, {cfg.num_layers} layers' cross K/V): "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sync_is_error(sync_check):
        for i in range(tokens.shape[1]):
            logits, cache = serve(params, cache, tokens[:, i:i + 1])
            outs.append(logits)
    torch.cuda.synchronize()
    return torch.cat(outs, 1), time.perf_counter() - t0, cache


def serve_expected_launches(cfg, setups: int):
    """Launches of one prefill forward without gradients (each layer
    once; decode launches none): an attention layer's flash_fwd, an
    rglru layer's rglru_fwd, an mlstm layer's mlstm_fwd, and three
    gmm_fwd products per MoE layer; the encoder's layers as the
    decoder's, in the prefill and in each of `setups` calls of
    setup_cross_cache."""
    want = {n: 0 for n in FLASH + GMM + SCAN + MLSTM}
    for (pattern, layers), runs in zip(stacks(cfg), (1, 1 + setups)):
        for i in range(layers):
            t = pattern[i % len(pattern)]
            for n, c in LAYER_KERNELS.get(t, ({}, {}))[0].items():
                want[n] += c * runs
    return want


def check_serve_reference():
    """The reduced DeepSeek-V2-Lite at MLA's full widths decoding 8
    tokens of 2 sequences on the card against the CPU: same weights,
    f32 cache; logits within SERVE_REF_TOL."""
    from repro_torch.models import backbone
    from repro_torch.train import step as step_mod
    from repro_torch.tree import tree_map
    cfg = ds_reduced()
    gen = torch.Generator().manual_seed(7)
    params = backbone.init_params(cfg, gen, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        serve = step_mod.make_serve_step(cfg, device=dev)
        p = tree_map(lambda t: t.to(dev), params)
        cache = backbone.init_cache(cfg, 2, 12, dtype=torch.float32,
                                    device=dev)
        outs = []
        for i in range(tokens.shape[1]):
            lg, cache = serve(p, cache, tokens[:, i:i + 1])
            outs.append(lg.cpu())
        out[dev] = torch.cat(outs, 1)
    diff = float((out["cuda"] - out["cpu"]).abs().max())
    print(f"  {cfg.name} reduced, MLA's full widths: decode logits card "
          f"against CPU max diff {diff:.3e} (tol {SERVE_REF_TOL:g})",
          flush=True)
    if not (torch.isfinite(out["cuda"]).all() and diff <= SERVE_REF_TOL):
        raise SystemExit("card decode disagrees with the CPU at the reduced "
                         "DeepSeek-V2-Lite")


def drive_serve(mods, cfg, card: str):
    """One model's serving path on the card (see phase 11): f32 weights
    and tokens from seed 0; returns the kernel launches over the path,
    zeroed just before it and read just after."""
    from repro_torch.models import backbone
    from repro_torch.train import step as step_mod
    batch, n, max_len, layers = SERVE[cfg.name]
    cfg = cfg.replace(num_layers=layers or cfg.num_layers)
    f32 = torch.float32
    print(f"[serve] {cfg.name}, {cfg.num_layers} layers, batch {batch}, "
          f"{n} tokens, caches of {max_len} slots, f32 weights", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods:
        mod.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = backbone.init_params(cfg, gen, dtype=f32, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                           device="cuda")
    # the encoder's frame embeddings at the scale train/data.py draws
    frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda") * 0.02 \
        if cfg.encoder_layers else None

    def report(what, wall):
        print(f"  decode, {what}: {wall:.4f} s, {wall / n * 1e3:.4f} ms "
              f"per token, {batch * n / wall:.1f} tokens/s [{card}]",
              flush=True)

    dec, wall, _ = decode_run(cfg, params, tokens, max_len, f32,
                              sync_check=True, frames=frames)
    # the first decode's peak, for phase 15: one cache (each later run
    # makes its own while the one before is still referenced here)
    MEASURED[f"{cfg.name} decode"] = torch.cuda.max_memory_allocated()
    report("f32 cache, no host sync (sync debug mode error)", wall)
    runs = [("slot buffers NaN-filled", dict(nan_fill=True))]
    if cfg.name == "stablelm-1.6b":
        runs.append(("again, same seed", {}))
    for what, kw in runs:
        again, wall, _ = decode_run(cfg, params, tokens, max_len, f32,
                                    frames=frames, **kw)
        report(what, wall)
        same = torch.equal(again, dec)
        print(f"    bitwise equal to the first run: {same}", flush=True)
        if not same:
            raise SystemExit(f"{cfg.name}: decode runs disagree ({what})")
        del again
    print(f"  decode peak max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B [{card}]", flush=True)
    if not (dec.shape == (batch, n, cfg.vocab_size)
            and torch.isfinite(dec).all()):
        raise SystemExit(f"{cfg.name}: decode logits {tuple(dec.shape)} "
                         "not finite or not (B, N, V)")
    prefill = step_mod.make_prefill_step(cfg, step_mod.RunCfg(
        param_dtype=f32))
    pre = prefill(params, {"tokens": tokens} if frames is None else
                  {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    scale = max(1.0, float(pre.abs().max()))
    err = float((dec - pre).abs().max()) / scale
    launches = {n_: c for mod in mods for n_, c in mod.LAUNCHES.items()}
    gated = cfg.name != "deepseek-v2-lite-16b"
    print(f"  decode against prefill: max |diff| / max(1, max |prefill|) "
          f"{err:.3e} (max |prefill| {scale:.4f}; "
          + (f"tol {SERVE_TOL:g})" if gated else "not gated: apply_moe "
             "drops tokens over capacity, decode_moe never does)"),
          flush=True)
    if gated and not err <= SERVE_TOL:
        raise SystemExit(f"{cfg.name}: decode disagrees with prefill")
    if cfg.name == "stablelm-1.6b":
        del dec
        dec16, wall, _ = decode_run(cfg, params, tokens, max_len,
                                    torch.bfloat16)
        report("bf16 cache", wall)
        err16 = float((dec16 - pre).abs().max()) / scale
        print(f"    against prefill {err16:.3e} (reported, not gated)",
              flush=True)
        if not torch.isfinite(dec16).all():
            raise SystemExit("bf16-cache decode not finite")
    want = serve_expected_launches(cfg, setups=1 + len(runs))
    print(f"  launches over the path: {launches} (want {want})", flush=True)
    if launches != want:
        raise SystemExit(f"{cfg.name}: serve launches {launches}, want "
                         f"{want}")
    print(f"  path peak max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B [{card}]", flush=True)
    return launches


def serve_config(arch: str, cuts: dict):
    from repro_torch.models import registry
    return registry.get_config(arch).replace(**cuts)


def draw(cfg, batch: int, n: int, dtype, mesh=None, tp: int = 1):
    """Weights in `dtype` (the rank's blocks under `mesh`: each leaf drawn
    whole and cut, so every mesh of one tp serves the same model), tokens
    (batch, n) and, for an encoder, f32 frames at the scale train/data.py
    draws them; all from seed 0 on the card."""
    from repro_torch.models import backbone
    from repro_torch.models.shardings import axis_size
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = backbone.init_params(
        cfg, gen, tp=axis_size(mesh, "heads") if mesh is not None else tp,
        dtype=dtype, device="cuda", mesh=mesh)
    tokens = torch.randint(0, cfg.vocab_size, (batch, n), generator=gen,
                           device="cuda")
    frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                         generator=gen, device="cuda") * 0.02 \
        if cfg.encoder_layers else None
    return params, tokens, frames


def prefill_run(cfg, params, tokens, frames, dtype, mesh=None, tp=None):
    """make_prefill_step's logits on the same tokens (the rank's block
    under `mesh`)."""
    from repro_torch.train import step as step_mod
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    out = step_mod.make_prefill_step(cfg, step_mod.RunCfg(
        param_dtype=dtype), mesh, tp=tp)(params, batch)
    torch.cuda.synchronize()
    return out


def serve_once(mods, cfg, batch: int, n: int, max_len: int, mesh=None,
               tp=None) -> dict:
    """One model's serve path in f32 (phase 14): drawn from seed 0,
    decoded from an empty cache under sync debug "error", then the
    prefill on the same tokens; the kernel launches over both. Under
    `mesh` the rank's blocks of everything returned."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f32 = torch.float32
    params, tokens, frames = draw(cfg, batch, n, f32, mesh, tp or 1)
    for mod in mods:
        mod.reset_launches()
    dec, wall, cache = decode_run(cfg, params, tokens, max_len, f32,
                                  sync_check=True, frames=frames,
                                  mesh=mesh, tp=tp)
    pre = prefill_run(cfg, params, tokens, frames, f32, mesh, tp)
    return {"decode": dec, "prefill": pre, "cache": cache, "wall": wall,
            "launches": {k: c for mod in mods
                         for k, c in mod.LAUNCHES.items()},
            "peak": torch.cuda.max_memory_allocated()}


def gathered(logits: dict, mesh) -> dict:
    """Each of a rank's blocks of logits (its rows, its vocab block)
    whole (collectives: every rank calls it)."""
    from repro_torch.models.shardings import resolve, whole
    spec = resolve(("batch", None, "vocab"), mesh)
    return {k: whole(t, spec, mesh) for k, t in logits.items()}


def logits_err(got, want, vocab: int) -> float:
    """max |got - want| over max(1, max |want|) within the vocab; inf
    where the padded rows past it differ (both are masked alike)."""
    if not torch.equal(got[..., vocab:], want[..., vocab:]):
        return math.inf
    got, want = got[..., :vocab], want[..., :vocab]
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def warm_groups(mesh) -> None:
    """One all-reduce on each of the mesh's process groups, so that their
    NCCL communicators exist before a decode loop that must not sync."""
    import torch.distributed as dist
    for name in mesh.mesh_dim_names:
        dist.all_reduce(torch.zeros(1, device="cuda"),
                        group=mesh.get_group(name))
    torch.cuda.synchronize()


def nonzero(launches: dict) -> dict:
    return {k: c for k, c in launches.items() if c}


def serve_mesh_one_card(mods, card: str) -> dict:
    """Phase 14 on one card: every model of SERVE_MESH served with no
    mesh, then with --mesh 1x1 over one NCCL process group (each after
    the other, so neither runs cold); bitwise equal decode and prefill
    logits and caches, the 1x1 run's launches the config's."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import step as step_mod
    from repro_torch.tree import tree_leaves
    print(f"[serve-mesh] --mesh 1x1 against none: "
          f"{', '.join(a for a, *_ in SERVE_MESH)}", flush=True)
    found, failures = {}, []
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_production_mesh("1x1")
        warm_groups(mesh)
        for arch, cuts, batch, n, max_len in SERVE_MESH:
            cfg = serve_config(arch, cuts)
            plain = serve_once(mods, cfg, batch, n, max_len)
            one = serve_once(mods, cfg, batch, n, max_len, mesh)
            same = {k: torch.equal(one[k], plain[k])
                    for k in ("decode", "prefill")}
            sh = tree_leaves(step_mod.cache_shardings(cfg, mesh))
            same["cache"] = all(torch.equal(s.whole(a), b) for s, a, b in
                                zip(sh, tree_leaves(one["cache"]),
                                    tree_leaves(plain["cache"])))
            want = serve_expected_launches(cfg, setups=1)
            print(f"  {arch} ({cfg.num_layers} layers, batch {batch}, {n} "
                  f"tokens): 1x1 bitwise none: {same}; prefill launches at "
                  f"1x1 {nonzero(one['launches'])} (want {nonzero(want)}); "
                  f"decode {plain['wall'] / n * 1e3:.4f} ms a token with "
                  f"none, {one['wall'] / n * 1e3:.4f} at 1x1; peak "
                  f"{one['peak']} B at 1x1 [{card}]", flush=True)
            if not all(same.values()) or one["launches"] != want or \
                    not torch.isfinite(one["decode"]).all():
                failures.append(f"{arch}: {same}, launches "
                                f"{one['launches']}")
            found[f"{cfg.name} {cfg.num_layers} layers serve mesh 1x1"] = \
                one["launches"]
            del one, plain
    finally:
        dist.destroy_process_group()
    if failures:
        raise SystemExit(f"serve mesh 1x1: {failures}")
    return found


def serve_mesh_jobs(n: int) -> list:
    """Phase 14's runs on n > 1 cards besides Yi-34B: (index into
    SERVE_MESH, mesh), every model on 1xn and StableLM on (n/2)x2."""
    return [*((i, f"1x{n}") for i in range(len(SERVE_MESH))),
            (0, f"{n // 2}x2")]


def serve_yi(mods, mesh) -> dict:
    """Yi-34B at full width and depth on the ranks of `mesh` (see phase
    14): the numbers each rank reports."""
    import torch.distributed as dist
    from repro_torch.configs import yi_34b
    from repro_torch.tree import tree_leaves
    cfg = yi_34b.CONFIG
    batch, n, max_len = YI_SERVE
    out = {}
    f32, bf16 = torch.float32, torch.bfloat16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, tokens, _ = draw(cfg, batch, n, f32, mesh)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["weights_b"] = torch.cuda.memory_allocated()
    warm_groups(mesh)
    for mod in mods:
        mod.reset_launches()
    dec, out["wall"], cache = decode_run(cfg, params, tokens, max_len, f32,
                                         sync_check=True, mesh=mesh)
    out["cache_b"] = sum(t.numel() * t.element_size()
                         for t in tree_leaves(cache))
    del cache
    again, out["wall_nan"], _ = decode_run(cfg, params, tokens, max_len, f32,
                                           nan_fill=True, mesh=mesh)
    out["nan_same"] = torch.equal(again, dec)
    del again
    pre = prefill_run(cfg, params, tokens, None, f32, mesh)
    out["peak_f32"] = torch.cuda.max_memory_allocated()
    whole = gathered({"decode": dec, "prefill": pre}, mesh)
    out["err"] = logits_err(whole["decode"], whole["prefill"],
                            cfg.vocab_size)
    out["finite"] = bool(torch.isfinite(whole["decode"]).all())
    out["launches"] = {k: c for mod in mods for k, c in mod.LAUNCHES.items()}
    ref = whole["decode"].clone()
    dist.broadcast(ref, src=0)
    out["ranks_agree"] = torch.equal(ref, whole["decode"])
    del params, pre, ref
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p16, _, _ = draw(cfg, batch, n, bf16, mesh)
    d16 = [decode_run(cfg, p16, tokens, max_len, bf16, sync_check=i == 0,
                      mesh=mesh)[:2] for i in range(2)]
    out["peak_bf16"] = torch.cuda.max_memory_allocated()
    out["wall_bf16"] = [w for _, w in d16]
    out["bf16_same"] = torch.equal(d16[0][0], d16[1][0])
    out["bf16_finite"] = bool(torch.isfinite(d16[0][0]).all())
    w16 = gathered({"decode": d16[0][0]}, mesh)
    out["bf16_err"] = logits_err(w16["decode"], whole["decode"],
                                 cfg.vocab_size)
    del p16, d16, w16, whole
    return out


def serve_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of phase 14 on several cards (spawned, one per card):
    Yi-34B, then each of `serve_mesh_jobs` twice; the numbers to
    `out_dir`/serve<rank>.json after each job, and rank 0's gathered
    logits of each job's first run to `out_dir`/job<j>.pt."""
    mods = rank_setup(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh
    out = {"jobs": []}
    path = Path(out_dir) / f"serve{rank}.json"
    try:
        out["yi"] = serve_yi(mods, make_production_mesh(f"1x{world}"))
        path.write_text(json.dumps(out))
        for j, (i, name) in enumerate(serve_mesh_jobs(world)):
            arch, cuts, batch, n, max_len = SERVE_MESH[i]
            cfg = serve_config(arch, cuts)
            mesh = make_production_mesh(name)
            warm_groups(mesh)
            runs, rec = [], {"wall": [], "peak": [], "launches": []}
            for _ in range(2):
                got = serve_once(mods, cfg, batch, n, max_len, mesh)
                for k in ("wall", "peak", "launches"):
                    rec[k].append(got[k])
                runs.append(gathered({k: got[k] for k in
                                      ("decode", "prefill")}, mesh))
                del got
            rec["same"] = all(torch.equal(runs[0][k], runs[1][k])
                              for k in runs[0])
            agree = []
            for k, t in runs[0].items():
                ref = t.clone()
                dist.broadcast(ref, src=0)
                agree.append(torch.equal(ref, t))
                del ref
            rec["agree"] = all(agree)
            if rank == 0:
                torch.save({k: t.cpu() for k, t in runs[0].items()},
                           Path(out_dir) / f"job{j}.pt")
            out["jobs"].append(rec)
            path.write_text(json.dumps(out))
            del runs
    finally:
        dist.destroy_process_group()


def serve_mesh_cards(mods, n: int, card: str) -> dict:
    """Phase 14 on n > 1 cards: Yi-34B and `serve_mesh_jobs(n)` on one
    spawned rank per card, then each job's model alone on one card in
    its tp layout."""
    import shutil
    import torch.multiprocessing as mp
    out_dir = ROOT / "build" / "serve_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    jobs = serve_mesh_jobs(n)
    print(f"[serve-mesh] {n} ranks, one per card: yi-34b full on 1x{n}; "
          + "; ".join(f"{SERVE_MESH[i][0]} {m}" for i, m in jobs),
          flush=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(serve_rank, args=(n, free_port(),
                                               str(out_dir)),
                             nprocs=n, start_method="spawn", join=False)
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 900:
                raise SystemExit("serve ranks timed out")
    except BaseException:
        for r in range(n):          # what each rank found before it
            path = out_dir / f"serve{r}.json"
            if path.exists():
                print(f"  rank {r} wrote: {path.read_text()}", flush=True)
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)
    print(f"  ranks done in {time.perf_counter() - t0:.1f} s", flush=True)
    ranks = [json.loads((out_dir / f"serve{r}.json").read_text())
             for r in range(n)]
    failures, found = [], {}
    from repro_torch.configs import yi_34b
    batch, ntok, max_len = YI_SERVE
    want = serve_expected_launches(yi_34b.CONFIG, setups=0)
    print(f"[serve-mesh] yi-34b, 60 layers, 1x{n}, batch {batch}, {ntok} "
          f"tokens, caches of {max_len} slots", flush=True)
    for r, rank in enumerate(ranks):
        yi = rank["yi"]
        print(f"  rank {r}: init {yi['init_s']:.2f} s, weights "
              f"{yi['weights_b']} B, cache {yi['cache_b']} B; f32 decode "
              f"{yi['wall'] / ntok * 1e3:.4f} ms a token, "
              f"{batch * ntok / yi['wall']:.1f} tokens/s (NaN-filled rerun "
              f"{yi['wall_nan'] / ntok * 1e3:.4f}; bitwise "
              f"{yi['nan_same']}); peak {yi['peak_f32']} B; decode against "
              f"prefill {yi['err']:.3e} (tol {SERVE_TOL:g}); ranks agree "
              f"{yi['ranks_agree']}; launches {nonzero(yi['launches'])} "
              f"(want {nonzero(want)}) [{card}]", flush=True)
        print(f"  rank {r}: bf16 weights and cache: decode "
              f"{[round(w / ntok * 1e3, 4) for w in yi['wall_bf16']]} ms a "
              f"token, peak {yi['peak_bf16']} B, same-seed rerun bitwise "
              f"{yi['bf16_same']}, finite {yi['bf16_finite']}, against the "
              f"f32 logits {yi['bf16_err']:.3e} (reported) [{card}]",
              flush=True)
        if not (yi["nan_same"] and yi["err"] <= SERVE_TOL and yi["finite"]
                and yi["ranks_agree"] and yi["launches"] == want
                and yi["bf16_same"] and yi["bf16_finite"]):
            failures.append(f"yi-34b rank {r}: {yi}")
    found[f"yi-34b 60 layers serve 1x{n} (rank 0)"] = \
        ranks[0]["yi"]["launches"]
    MEASURED[f"yi-34b 1x{n} decode"] = max(r["yi"]["peak_f32"]
                                           for r in ranks)
    for j, (i, name) in enumerate(jobs):
        arch, cuts, batch, ntok, max_len = SERVE_MESH[i]
        cfg = serve_config(arch, cuts)
        tp = int(name.split("x")[-1])
        want = serve_expected_launches(cfg, setups=1)
        label = f"{arch} {cfg.num_layers} layers {name}"
        for r, rank in enumerate(ranks):
            rec = rank["jobs"][j]
            print(f"  {label} rank {r}: decode "
                  f"{[round(w / ntok * 1e3, 4) for w in rec['wall']]} ms a "
                  f"token, peak {rec['peak']} B, two runs bitwise "
                  f"{rec['same']}, ranks agree {rec['agree']} [{card}]",
                  flush=True)
            if not (rec["same"] and rec["agree"]) or \
                    any(l != want for l in rec["launches"]):
                failures.append(f"{label} rank {r}: {rec}")
        one = serve_once(mods, cfg, batch, ntok, max_len, tp=tp)
        mesh_out = torch.load(out_dir / f"job{j}.pt")
        errs = {k: logits_err(mesh_out[k].cuda(), one[k], cfg.vocab_size)
                for k in mesh_out}
        print(f"  {label} against one process at tp {tp}: decode "
              f"{errs['decode']:.3e}, prefill {errs['prefill']:.3e} (tol "
              f"{SERVE_MESH_TOL:g})", flush=True)
        if not max(errs.values()) <= SERVE_MESH_TOL:
            failures.append(f"{label}: against one process {errs}")
        found[f"{label} serve (rank 0)"] = ranks[0]["jobs"][j]["launches"][0]
        del one, mesh_out
    if failures:
        raise SystemExit(f"serve mesh phase: {failures}")
    return found


def drive_serve_mesh(mods, card: str) -> dict:
    """Phase 14 with one rank per card the script finds."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    found = serve_mesh_one_card(mods, card) if n == 1 else \
        serve_mesh_cards(mods, n, card)
    print(f"[serve-mesh] phase 14 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return found


def predicted_peak(label: str, rec: dict, measured, card: str) -> bool:
    """Print a dry-run's predicted peak beside a measured one; whether
    it is within DRYRUN_PEAK_TOL."""
    ratio = rec["mem_peak_bytes"] / measured
    print(f"  {label}: predicted peak {rec['mem_peak_bytes']} B "
          f"(arguments {rec['mem_argument']} B, beyond them "
          f"{rec['mem_temp']} B, cuBLAS workspace), measured "
          f"max_memory_allocated {measured} B: predicted / measured "
          f"{ratio:.4f} (tol {DRYRUN_PEAK_TOL:g}); run on meta in "
          f"{rec['run_s']} s [{card}]", flush=True)
    return abs(ratio - 1) <= DRYRUN_PEAK_TOL


def drive_dryrun(card: str) -> None:
    """Phase 15 (see the module's docstring)."""
    from repro_torch.configs import recurrentgemma_2b, stablelm_1_6b, yi_34b
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dryrun] card total_memory {total} B; the dry-run's budget "
          f"H100_HBM_BYTES {dryrun.H100_HBM_BYTES} B [{card}]", flush=True)
    failures = []
    if dryrun.H100_HBM_BYTES > total:
        failures.append("the budget is above the card's memory")
    for arch, shape, multi in (("qwen2-moe-a2.7b", "train_4k", False),
                               ("yi-34b", "decode_32k", True)):
        rec = dryrun.run_cell(arch, shape, multi)
        print(f"  {arch} {shape} {rec['mesh']}: {rec['status']}"
              + (f", {rec.get('error')}" if rec["status"] != "ok" else
                 f" in {rec['run_s']} s: {rec['flops_per_device']:.4e} "
                 f"FLOPs a device, {rec['mem_peak_bytes']} B peak, fits "
                 f"{rec['fits_h100_hbm']}, collectives "
                 f"{rec['collective_bytes_per_device']:.4e} B "
                 f"{json.dumps(rec['per_collective'])}"), flush=True)
        if rec["status"] != "ok":
            failures.append(f"{arch} {shape}: {rec.get('trace')}")
    rgc = recurrentgemma_2b.CONFIG
    rg = dryrun.analyze_cell(rgc, ShapeCfg("launcher", "train", 4096, 1),
                             None)
    got = MEASURED[rgc.name]
    if not predicted_peak(f"{rgc.name} phase 6 train step", rg, got["peak"],
                          card):
        failures.append(f"{rgc.name}: predicted peak off the measured")
    step = min(got["step_s"])
    rate = rg["flops_per_device"] / step
    peak_rate = PEAK_FLOPS[torch.bfloat16]
    print(f"  {rgc.name}: predicted FLOPs {rg['flops_per_device']:.6e} "
          f"(matmuls {rg['matmul_flops_per_device']:.6e}, kernels "
          f"{rg['kernel_flops_per_device']:.6e}) over the fastest measured "
          f"step {step:.4f} s: {rate / 1e12:.2f} TFLOP/s, the card's bf16 "
          f"peak {peak_rate / 1e12:.0f} TFLOP/s [{card}]", flush=True)
    if not 0 < rate <= peak_rate:
        failures.append(f"{rgc.name}: {rate:.4e} FLOP/s above the peak")
    lm = stablelm_1_6b.CONFIG
    batch, _, slots, _ = SERVE[lm.name]
    dec = dryrun.analyze_cell(lm, ShapeCfg("serve", "decode", slots, batch),
                              None, param_dtype=torch.float32,
                              cache_dtype=torch.float32)
    if not predicted_peak(f"{lm.name} phase 11 decode step", dec,
                          MEASURED[f"{lm.name} decode"], card):
        failures.append(f"{lm.name}: predicted decode peak off the measured")
    n = torch.cuda.device_count()
    if f"yi-34b 1x{n} decode" in MEASURED:
        batch, _, slots = YI_SERVE
        yi = dryrun.analyze_cell(yi_34b.CONFIG,
                                 ShapeCfg("serve", "decode", slots, batch),
                                 f"1x{n}", param_dtype=torch.float32,
                                 cache_dtype=torch.float32)
        predicted_peak(f"yi-34b phase 14 decode step, a rank of 1x{n} "
                       f"(printed, not gated)", yi,
                       MEASURED[f"yi-34b 1x{n} decode"], card)
    print(f"[dryrun] phase 15 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if failures:
        raise SystemExit(f"dry-run: {failures}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="smoke run of the port on "
                                 "the GPUs (see the module's docstring)")
    ap.add_argument("--only", choices=["mesh", "serve-mesh"],
                    help="build the kernels and run this phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import (deepseek_v2_lite_16b, qwen2_moe_a2_7b,
                                     recurrentgemma_2b, stablelm_1_6b,
                                     whisper_medium, xlstm_350m)
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
                          3 * len(fa.WIDTHS) * len(fa._DTYPE_CODE))
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

    mods = (fa, gm, rg, ml)
    if args.only:
        phase = {"mesh": drive_mesh,
                 "serve-mesh": lambda m: drive_serve_mesh(m, card)}
        print(json.dumps({f"{args.only}_launches": phase[args.only](mods)}))
        print(card_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

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

    gpt = GPT_MEDIUM
    launches, gpt_losses = drive(
        mods, f"GPT-medium, {gpt.num_layers} layers, dp=2 pp=2 mb=2 batch 8 "
        f"seq 2048", gpt, 2, 8, moe=False, first_loss=GPT_FIRST_LOSS)
    mig_launches = drive_migration(mods, gpt, 2, 8, card, gpt_losses[1:])
    camp_launches = drive_campaign(mods, card, gpt_losses)
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
    xl = xlstm_350m.CONFIG.replace(num_layers=XL_LAYERS)
    xl_launches = drive_launcher(mods, xl, [
        "--arch", xl.name, "--layers", str(XL_LAYERS), "--steps",
        str(XL_STEPS), "--batch", "4", "--seq", str(XL_SEQ), "--log-every",
        "1", "--device", "cuda"],
        f"batch 4 seq {XL_SEQ}, launcher defaults (bf16 params, remat)")
    # phase 10: DeepSeek-V2-Lite with phase 5's engine arguments and
    # cuts (1.59 G parameters at 2 layers)
    dsc = deepseek_v2_lite_16b.CONFIG.replace(num_layers=2)
    ds_launches, _ = drive(mods, f"{dsc.name}, {dsc.num_layers} layers, "
                           f"dp=1 pp=2 mb=2 batch 4 seq 2048, bf16 layer "
                           f"weights", dsc, 1, 4, moe=True,
                           first_loss=DS_FIRST_LOSS,
                           param_dtype=torch.bfloat16)
    # phase 12: Whisper-medium through the launcher
    wh = whisper_medium.CONFIG
    t0 = time.perf_counter()
    wh_launches = drive_launcher(mods, wh, [
        "--arch", wh.name, "--steps", str(WH_STEPS), "--batch",
        str(WH_BATCH), "--seq", str(WH_SEQ), "--log-every", "1", "--device",
        "cuda"], f"and {wh.encoder_layers} encoder layers over "
        f"{wh.encoder_seq} frames, batch {WH_BATCH} seq {WH_SEQ}, launcher "
        f"defaults (bf16 params, remat; f32 frames)",
        busy_kernels=(ENC_FWD_KERNEL,))
    print(f"[slice] phase 12 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    mesh_launches = drive_mesh(mods)
    serve_mesh_launches = drive_serve_mesh(mods, card)
    # phase 11: serving
    print("[serve] card against the CPU", flush=True)
    check_serve_reference()
    t0 = time.perf_counter()
    serve_launches = {
        c.name: drive_serve(mods, c, card)
        for c in (stablelm_1_6b.CONFIG, recurrentgemma_2b.CONFIG,
                  xlstm_350m.CONFIG, deepseek_v2_lite_16b.CONFIG, wh)}
    print(f"[serve] phase 11 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    drive_dryrun(card)
    names = FLASH + GMM + SCAN + MLSTM
    by_path = {n: {gpt.name: launches[n],
                   f"{gpt.name} migration": mig_launches[n],
                   f"{gpt.name} campaign": camp_launches[n],
                   qwen.name: moe_launches[n], rgc.name: rg_launches[n],
                   xl.name: xl_launches[n], dsc.name: ds_launches[n],
                   wh.name: wh_launches[n],
                   **{k: v[n] for k, v in mesh_launches.items()},
                   **{k: v[n] for k, v in serve_mesh_launches.items()},
                   **{f"{k} serve": v[n] for k, v in serve_launches.items()}}
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
