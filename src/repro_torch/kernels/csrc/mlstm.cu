// Chunkwise stabilized mLSTM for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel `_mlstm_kernel` / `mlstm_chunkwise` in
// src/repro/kernels/mlstm.py, which is forward-only and keeps one head's
// (C, n, m) state in VMEM scratch across a sequential grid axis of
// chunks. Here blocks run in no order, and one head's C (K x K f32, 1 MiB
// at K = 512) is four times what a block may hold in shared memory. So
// only the state recurrence walks the chunks in order; everything else
// runs every chunk at once, from states stored per chunk:
//
//   mlstm_fwd       three passes on the caller's stream:
//     _scalars_kernel  block per head: each chunk's inclusive cumsum F of
//                      log_f (a warp scan), each row's max_s W[t, s], then
//                      the chain of the state's m over the chunks (one
//                      thread, scalars only), then each row's m_loc, c_int
//                      and w and each chunk's decay, into the workspace.
//     _state_kernel    block per (64 x 64 tile of C, head) walks the chunks
//                      in order: writes C at each chunk's start into C_st,
//                      then C <- decay C + (w k)^T v; the tiles of column 0
//                      carry n. The next chunk's k and v arrive by cp.async
//                      under the current chunk's products.
//     _out_kernel      block per (chunk, head): P = D * (q k^T) and den
//                      once, into shared memory; then, per 64-column tile
//                      j of h, q C_st[:, j] over K and P v[:, j], and h.
//   mlstm_bwd_dqdk  three passes likewise:
//     _scalars_kernel  block per (chunk, head): each row's dh.h (a warp a
//                      row), F, c_int, w, the floor's denominator and dden,
//                      and each chunk's decay, into the workspace.
//     _state_kernel    the _state_kernel's walk in reverse over the chunks
//                      (one shared body): dC <- decay dC + (c_int q)^T
//                      dnum and dn likewise, writing each chunk's dC and dn
//                      (the gradient of the state at the chunk's end) into
//                      a workspace of (BH, nc, K, K) and (BH, nc, K).
//     _grad_kernel     block per (chunk, head): dP = A * (dnum v^T + dden)
//                      once, into shared memory; then, per 64-column tile,
//                      dq = scale (c_int (dnum C^T + dden n) + dP k) on
//                      four warps and dk = w (v dC^T + dn) + dP^T (scale q)
//                      on the other four.
//   mlstm_bwd_dv    two passes, after mlstm_bwd_dqdk, from its dq, dk, dC
//                   workspace and rows F, w and the denominator:
//     _grad_kernel     block per (chunk, head): each row's q.dq and k.dk,
//                      hence dlog_i = k.dk and dF = q.dq - k.dk; P' = A *
//                      (q k^T) scale / denominator_t once, into shared
//                      memory; then, per 64-column tile j, dv = w (k dC) +
//                      P'^T dh.
//     _scalars_kernel  block per head: dlog_f_t = sum_{j>=t} dF_j over the
//                      whole sequence, warp scans in one fixed order.
// The backward treats every stabilizer as a constant (they cancel from
// h exactly; see kernels/mlstm.py). Every block owns its outputs and
// every sum runs in one fixed order, with no atomics, so results repeat
// bitwise from run to run.
//
// Every product runs on the tensor cores: warp-level mma.sync m16n8k8 as
// 3xTF32 (each f32 operand split into a TF32 big and small part as it
// leaves shared memory; mma_sm90.cuh), so they keep f32 accuracy; bf16
// inputs are exact in TF32 and take the same path. Operands are 64 x 64
// tiles kept in their input type in shared memory, rows padded so that
// the fragment reads of a warp hit distinct banks. Each 64-long slice of
// a reduction sums into a fresh accumulator that is added to the running
// one in f32 (the tensor cores truncate their sums). Row scalings (1 /
// denominator, c_int, scale) are applied after a product where they
// factor out of it.
//
// Layout: q, k, v, h, dh contiguous (BH, S, K) in T (float or bf16), 16-
// byte aligned; log_i, log_f, m_loc, den, dlog_i, dlog_f (BH, S) f32; C
// states (BH, nc, K, K), n states (BH, nc, K), m states (BH, nc), f32; dq,
// dk, dv (BH, S, K) f32; the workspace ws (8, BH, S) f32. K is a multiple
// of 64 up to 512; the chunk L is at most 64 and divides S (rows past L
// are zero-padded in the tiles).
//
// What bounds it on an H100: at the xLSTM-350M path's shape (BH 16, S
// 2048, K 512, L 64, f32) the forward needs 36.6 GFLOP (0.22 ms at the
// 165 TFLOP/s of 3xTF32) and moves 806 MB (0.24 ms, the bound), 538 MB
// of it the per-chunk states that it writes and its output pass reads
// again. mlstm_bwd_dqdk needs 54.9 GFLOP (0.33 ms, the bound) and moves
// its dC workspace out and back (1.07 GB, 0.32 ms). The state walks are
// the serial part, about a third of each kernel's FLOPs, spread over
// (K / 64)^2 tiles a head. mlstm_bwd_dv needs 19.4 GFLOP (0.12 ms) and
// moves 0.94 GB (0.28 ms, the bound), 537 MB of it the dC workspace, which
// it reads once: one block per (chunk, head), where its first design
// walked the chunks in order in 128 blocks with plain FMA loops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "mma_sm90.cuh"

namespace {

constexpr int TILE = 64;          // column tile of C and K/V slice
constexpr int LMAX = 64;          // largest chunk
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ------------------------------------------------- tensor-core helpers
constexpr int NT4 = 128;          // threads of a block of 4 warps
constexpr int NT8 = 256;          // of 8 warps
constexpr unsigned FULL = 0xffffffffu;
// One padded 64 x 64 operand tile in shared memory, in floats: 64 rows of
// up to 72 f32 (or 72 bf16, with room to spare). 16-byte aligned.
constexpr int REG = TILE * 72;
// A state walk's stage: its two tiles, two row scalars and the decay.
constexpr int ST_STAGE = 2 * REG + 2 * TILE + 8;
// A dq/dk stage: four tiles, then n and dn of a 64-row tile.
constexpr int GR_STAGE = 4 * REG + 2 * TILE;
constexpr int LDP = 68;           // row stride of the L x L P and dP (f32)
constexpr int LDT = 72;           // of dv's P', read down its columns

// Row strides (elements) of a 64-wide tile in shared memory. ROW: the
// fragments read along a stored row (the reduction runs along it), COL:
// down a column. f32 strides of 68 and 72 words put the 32 lanes of a
// fragment read in 32 banks; bf16's 72 (36 words) does so both ways.
// Every stored row is a multiple of 16 bytes, as cp.async needs.
template <typename T> struct Ld {
  static constexpr int ROW = 68, COL = 72;
};
template <> struct Ld<__nv_bfloat16> {
  static constexpr int ROW = 72, COL = 72;
};

// acc[i][j] += sum_{k < 8 KS} A(16 i + r, k) B(k, 8 j + c) for one warp on
// the tensor cores, as 3xTF32 m16n8k8: A(r, k) and B(k, c) return the f32
// operands relative to the warp's tile; each k step splits its MI A and
// NI B fragments once, and every split feeds NI or MI products. The k
// loop unrolls by two: unrolled whole, ptxas hoists every step's
// fragments and spills at 255 registers.
template <int MI, int NI, int KS, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4], FA A,
                                         FB B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < KS; ++kk) {
    const int k0 = 8 * kk;
    FragB<float> fb[NI];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      split_tf32(B(k0 + t, 8 * j + g), fb[j].hi[0], fb[j].lo[0]);
      split_tf32(B(k0 + t + 4, 8 * j + g), fb[j].hi[1], fb[j].lo[1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int r = 16 * i + g;
      const FragA<float> fa = frag_a_tf32(A(r, k0 + t), A(r + 8, k0 + t),
                                          A(r, k0 + t + 4),
                                          A(r + 8, k0 + t + 4));
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_op(acc[i][j], fa, fb[j]);
    }
  }
}

// f(r, c, i, j, e) for every accumulator pair (e, e + 1) of a warp's MI x
// NI m16n8 tiles: row r and columns c, c + 1 of the warp's tile.
template <int MI, int NI, typename Fn>
__device__ __forceinline__ void each_pair(Fn f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NI; ++j)
        f(16 * i + g + 8 * h, 8 * j + 2 * t, i, j, 2 * h);
}

template <int MI, int NI>
__device__ __forceinline__ void add_to(float (&acc)[MI][NI][4],
                                       const float (&part)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

template <int MI, int NI>
__device__ __forceinline__ void zero(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// Rows [0, 64) x columns [0, 64) of g (row stride ldg elements) into the
// tile s (row stride lds) by NTH threads, 16 bytes a cp.async; rows from
// `rows` on arrive as zeros.
template <typename T, int NTH>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g,
                                          int64_t ldg, int rows) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = TILE / CH;
  static_assert(TILE * CPR % NTH == 0, "copies a thread");
#pragma unroll
  for (int n = 0; n < TILE * CPR / NTH; ++n) {
    const int i = threadIdx.x + n * NTH, r = i / CPR, x = i % CPR * CH;
    const bool in = r < rows;
    cp_async16(s + r * lds + x, g + (in ? r * ldg + x : 0), in);
  }
}

// One f32 a row for rows [0, 64), by threads 0-63: g[t] by cp.async for
// t < rows, else `pad`.
__device__ __forceinline__ void load_rows(float* s, const float* g, int rows,
                                          float pad) {
  const int t = threadIdx.x;
  if (t < TILE) {
    if (t < rows)
      cp_async4(s + t, g + t, true);
    else
      s[t] = pad;
  }
}

// Steps [i0, i1) of a two-stage cp.async ring of `steps` steps in sm,
// `stage` floats each: step i + 1's copies (load(stage index, i + 1)) are
// issued before step i is computed (body(i, its stage)). The caller
// issues step 0's copies and commits them; the barrier after each body
// frees its stage for the next copies.
template <typename Load, typename Body>
__device__ __forceinline__ void ring(int i0, int i1, int steps, int stage,
                                     float* sm, Load& load, Body body) {
  for (int i = i0; i < i1; ++i) {
    if (i + 1 < steps) load((i + 1) & 1, i + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    body(i, sm + (i & 1) * stage);
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_cumsum(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// F, the inclusive cumsum of log_f over the chunk's L <= 64 rows at row0,
// by one warp: lane holds rows lane and lane + 32 in f[0], f[1]; every
// lane gets Ftot = F[L - 1].
__device__ __forceinline__ void chunk_cumsum(const float* lf, int64_t row0,
                                             int L, float (&f)[2],
                                             float& ftot) {
  const int lane = threadIdx.x & 31;
  f[0] = warp_cumsum(lane < L ? lf[row0 + lane] : 0.f);
  f[1] = warp_cumsum(lane + 32 < L ? lf[row0 + lane + 32] : 0.f) +
         __shfl_sync(FULL, f[0], 31);
  ftot = __shfl_sync(FULL, L > 32 ? f[1] : f[0], (L - 1) & 31);
}

// ---------------------------------------------- forward: the scalars
// Workspace rows (each BH * S floats): F, c_int, w, then per chunk
// (BH * nc each) decay, Ftot, max_s (li_s + Ftot - F_s) and m_new.
__global__ void __launch_bounds__(NT8)
mlstm_fwd_scalars_kernel(const float* __restrict__ li_g,
                         const float* __restrict__ lf_g, float* mst,
                         float* mloc_g, float* ws, int BH, int S, int L) {
  __shared__ float sF[NT8 / 32][LMAX], sLi[NT8 / 32][LMAX];
  __shared__ float sA[NT8], sB[NT8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t b = blockIdx.x;
  const int nc = S / L;
  const int64_t N = (int64_t)BH * S, NC = (int64_t)BH * nc;
  float* F_g = ws;
  float* cint_g = ws + N;
  float* w_g = ws + 2 * N;
  float* decay_g = ws + 3 * N;
  float* ftot_g = decay_g + NC;
  float* msc_g = ftot_g + NC;
  float* mnew_g = msc_g + NC;

  // a warp a chunk: F, each row's max_s W[t, s] (into m_loc for now),
  // Ftot and max_s (li_s + Ftot - F_s)
  for (int c = warp; c < nc; c += NT8 / 32) {
    const int64_t row0 = b * S + (int64_t)c * L;
    float f[2], ftot;
    chunk_cumsum(lf_g, row0, L, f, ftot);
    float ms = NEG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      if (t < L) {
        const float li = li_g[row0 + t];
        sF[warp][t] = f[h];
        sLi[warp][t] = li;
        F_g[row0 + t] = f[h];
        ms = fmaxf(ms, (li + ftot) - f[h]);
      }
    }
    ms = warp_max(ms);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      if (t < L) {
        float mx = NEG;
        for (int s = 0; s <= t; ++s)
          mx = fmaxf(mx, (sF[warp][t] - sF[warp][s]) + sLi[warp][s]);
        mloc_g[row0 + t] = mx;
      }
    }
    if (lane == 0) {
      ftot_g[b * nc + c] = ftot;
      msc_g[b * nc + c] = ms;
    }
    __syncwarp();
  }
  __syncthreads();

  // the state's m chunk by chunk, by thread 0, NT8 chunks at a time
  float m = NEG;
  for (int c0 = 0; c0 < nc; c0 += NT8) {
    const int n = min(NT8, nc - c0);
    if (tid < n) {
      sA[tid] = ftot_g[b * nc + c0 + tid];
      sB[tid] = msc_g[b * nc + c0 + tid];
    }
    __syncthreads();
    if (tid == 0)
      for (int i = 0; i < n; ++i) {
        const int64_t ci = b * nc + c0 + i;
        const float mn = fmaxf(m + sA[i], sB[i]);
        mst[ci] = m;
        decay_g[ci] = expf(m + sA[i] - mn);
        mnew_g[ci] = mn;
        m = mn;
      }
    __syncthreads();
  }

  // each row: m_loc, c_int and w
  for (int i = tid; i < S; i += NT8) {
    const int64_t row = b * S + i, ci = b * nc + i / L;
    const float Fv = F_g[row], gi = mst[ci] + Fv;
    const float ml = fmaxf(gi, mloc_g[row]);
    mloc_g[row] = ml;
    cint_g[row] = expf(gi - ml);
    w_g[row] = expf((li_g[row] + ftot_g[ci]) - Fv - mnew_g[ci]);
  }
}

// ------------------------------------ the state walk (forward, backward)
// Block (column tile j, row tile r, head) keeps X[r, j] (64 x 64 f32) in
// its accumulators and walks the chunks, in order or (REV) in reverse. At
// each chunk it first writes X into Xst[head, chunk], then
//   X <- decay X + (a * A)^T[r] B[:, j]
// for the chunk's rows of A and B (L x K) and row weights a, on the tensor
// cores; the tiles j = 0 also carry x[r] <- decay x + sum_t an_t A[t, r]
// into xst. The next chunk's tiles arrive by cp.async under the current
// chunk's products. 4 warps, each a 32 x 32 quarter of the tile.
template <typename T, bool REV>
__device__ __forceinline__ void state_walk(
    float* sm, const T* __restrict__ A, const T* __restrict__ B,
    const float* a_g, const float* an_g, const float* decay_g, float* Xst,
    float* xst, int S, int K, int L) {
  constexpr int LD = Ld<T>::COL;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int j0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const int64_t b = blockIdx.z;
  const int nc = S / L;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const bool carry_x = blockIdx.x == 0;
  auto load = [&](int stage, int c) {
    const int64_t row0 = b * S + (int64_t)c * L;
    float* s = sm + stage * ST_STAGE;
    load_tile<T, NT4>(reinterpret_cast<T*>(s), LD, A + row0 * K + r0, K, L);
    load_tile<T, NT4>(reinterpret_cast<T*>(s + REG), LD, B + row0 * K + j0,
                      K, L);
    load_rows(s + 2 * REG, a_g + row0, L, 0.f);
    load_rows(s + 2 * REG + TILE, an_g + row0, L, 0.f);
    if (tid == TILE) cp_async4(s + 2 * REG + 2 * TILE, decay_g + b * nc + c,
                               true);
  };
  float acc[2][4][4] = {};
  float x = 0.f;
  load(0, REV ? nc - 1 : 0);
  cp_commit();
  for (int i = 0; i < nc; ++i) {
    const int c = REV ? nc - 1 - i : i;
    float* dst = Xst + (b * nc + c) * K * K + (int64_t)(r0 + wm) * K + j0 + wn;
    each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
      *reinterpret_cast<float2*>(dst + (int64_t)r * K + col) =
          make_float2(acc[ii][jj][e], acc[ii][jj][e + 1]);
    });
    if (carry_x && tid < TILE) xst[(b * nc + c) * K + r0 + tid] = x;
    if (i + 1 < nc) load((i + 1) & 1, REV ? c - 1 : c + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* s = sm + (i & 1) * ST_STAGE;
    const T* As = reinterpret_cast<const T*>(s);
    const T* Bs = reinterpret_cast<const T*>(s + REG);
    const float* a = s + 2 * REG;
    const float decay = s[2 * REG + 2 * TILE];
    float part[2][4][4] = {};
    warp_mma<2, 4, 8>(
        part, [&](int r, int t) { return a[t] * to_f(As[t * LD + wm + r]); },
        [&](int t, int col) { return to_f(Bs[t * LD + wn + col]); });
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[ii][jj][e] = decay * acc[ii][jj][e] + part[ii][jj][e];
    if (carry_x && tid < TILE) {
      const float* an = a + TILE;
      float sum = 0.f;
      for (int t = 0; t < L; ++t)
        sum = fmaf(an[t], to_f(As[t * LD + tid]), sum);
      x = decay * x + sum;
    }
    __syncthreads();
  }
  cp_wait<0>();
}

// ----------------------------------------- forward: the state pass
// C at each chunk's start into C_st, n into n_st: X = C, A = k, B = v,
// a = an = w.
template <typename T>
__global__ void __launch_bounds__(NT4, 2)
mlstm_fwd_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       float* __restrict__ Cst, float* __restrict__ nst,
                       const float* ws, int BH, int S, int K, int L) {
  extern __shared__ float sm[];
  const int64_t N = (int64_t)BH * S;
  state_walk<T, false>(sm, k, v, ws + 2 * N, ws + 2 * N, ws + 3 * N, Cst,
                       nst, S, K, L);
}

// ----------------------------------------- forward: the output pass
// Block (chunk, head), 4 warps. Steps, each one stage of the cp.async
// ring: K / 64 slices of q [k; n]^T (q.n rides as a fifth n8 tile of the
// same A fragments), after which P = D * (q k^T) * scale goes to shared
// memory and each row's den is written; then, per 64-column tile j of h,
// K / 64 slices of q C_st[:, j] and one step of P v[:, j], after which
// h[:, j] is written.
template <typename T>
__global__ void __launch_bounds__(NT4, 2)
mlstm_fwd_out_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ li_g,
                     T* __restrict__ h, const float* __restrict__ Cst,
                     const float* __restrict__ nst, const float* mloc_g,
                     float* __restrict__ den_g, const float* ws, int BH,
                     int S, int K, int L, float scale) {
  extern __shared__ float sm[];
  constexpr int LDR = Ld<T>::ROW, LDC = Ld<T>::COL;
  float* Ps = sm + 2 * ST_STAGE;        // [64][LDP] P
  float* F = Ps + TILE * LDP;           // [64] each from here
  float* li = F + TILE;
  float* ml = li + TILE;
  float* ci = ml + TILE;
  float* dd = ci + TILE;                // max(|den|, exp(-m_loc))
  float* qn = dd + TILE;                // q.n (unscaled)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = S / L, ns = K / TILE;
  const int64_t N = (int64_t)BH * S, row0 = b * S + (int64_t)c * L;
  const int64_t st = b * nc + c;
  const float* Cc = Cst + st * K * K;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  if (tid < TILE) {
    const bool in = tid < L;
    F[tid] = in ? ws[row0 + tid] : 0.f;
    li[tid] = in ? li_g[row0 + tid] : 0.f;
    ml[tid] = in ? mloc_g[row0 + tid] : 0.f;
    ci[tid] = in ? ws[N + row0 + tid] : 0.f;
  }
  auto load = [&](int stage, int i) {
    float* s = sm + stage * ST_STAGE;
    T* qs = reinterpret_cast<T*>(s);
    if (i < ns) {
      load_tile<T, NT4>(qs, LDR, q + row0 * K + i * TILE, K, L);
      load_tile<T, NT4>(reinterpret_cast<T*>(s + REG), LDR,
                        k + row0 * K + i * TILE, K, L);
      if (tid < TILE)
        cp_async4(s + 2 * REG + tid, nst + st * K + i * TILE + tid, true);
      return;
    }
    const int j = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    if (sl < ns) {
      load_tile<T, NT4>(qs, LDR, q + row0 * K + sl * TILE, K, L);
      load_tile<float, NT4>(s + REG, 72, Cc + (int64_t)sl * TILE * K +
                                             j * TILE, K, TILE);
    } else {
      load_tile<T, NT4>(reinterpret_cast<T*>(s + REG), LDC,
                        v + row0 * K + j * TILE, K, L);
    }
  };
  const int steps = ns + ns * (ns + 1);
  load(0, 0);
  cp_commit();

  // q k^T in n8 tiles 0-3 of the warp, q.n in every column of tile 4
  float accs[2][5][4] = {};
  ring(0, ns, steps, ST_STAGE, sm, load, [&](int, const float* s) {
    const T* qs = reinterpret_cast<const T*>(s);
    const T* ks = reinterpret_cast<const T*>(s + REG);
    const float* n = s + 2 * REG;
    float part[2][5][4] = {};
    warp_mma<2, 5, 8>(
        part, [&](int r, int kk) { return to_f(qs[(wm + r) * LDR + kk]); },
        [&](int kk, int col) {
          return col < 32 ? to_f(ks[(wn + col) * LDR + kk]) : n[kk];
        });
    add_to(accs, part);
  });
  each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
    const int t = wm + r;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int sx = wn + col + x;
      float p = 0.f;
      if (sx <= t && t < L)
        p = expf(((F[t] - F[sx]) + li[sx]) - ml[t]) *
            (accs[ii][jj][e + x] * scale);
      Ps[t * LDP + sx] = p;
    }
  });
  if (wn == 0 && (lane & 3) == 0)
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        qn[wm + 16 * ii + (lane >> 2) + 4 * e] = accs[ii][4][e];
  __syncthreads();
  if (tid < L) {
    float rs = 0.f;
    for (int sx = 0; sx < L; ++sx) rs += Ps[tid * LDP + sx];
    const float d = ci[tid] * (qn[tid] * scale) + rs;
    den_g[row0 + tid] = d;
    dd[tid] = fmaxf(fabsf(d), expf(-ml[tid]));
  }

  float acc[2][4][4] = {};
  ring(ns, steps, steps, ST_STAGE, sm, load, [&](int i, const float* s) {
    const int j = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    float part[2][4][4] = {};
    if (sl < ns) {
      const T* qs = reinterpret_cast<const T*>(s);
      const float* cs = s + REG;
      warp_mma<2, 4, 8>(
          part, [&](int r, int kk) { return to_f(qs[(wm + r) * LDR + kk]); },
          [&](int kk, int col) { return cs[kk * 72 + wn + col]; });
      add_to(acc, part);
      return;
    }
    const T* vs = reinterpret_cast<const T*>(s + REG);
    warp_mma<2, 4, 8>(
        part, [&](int r, int sx) { return Ps[(wm + r) * LDP + sx]; },
        [&](int sx, int col) { return to_f(vs[sx * LDC + wn + col]); });
    T* out = h + (row0 + wm) * K + j * TILE + wn;
    each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
      const int t = wm + r;
      if (t < L)
        store2<T>(out + (int64_t)r * K + col,
                  (ci[t] * (acc[ii][jj][e] * scale) + part[ii][jj][e]) /
                      dd[t],
                  (ci[t] * (acc[ii][jj][e + 1] * scale) +
                   part[ii][jj][e + 1]) / dd[t]);
    });
    zero(acc);
  });
  cp_wait<0>();
}

// ---------------------------------------------- backward: the scalars
// Block (chunk, head). Workspace rows (each BH * S floats): F, c_int, w,
// the denominator max(|den|, exp(-m_loc)), dden (the gradient of den,
// zero where the floor wins), coef = c_int scale / denominator and coefn
// = dden c_int scale; then each chunk's decay (BH * nc).
template <typename T>
__global__ void __launch_bounds__(NT8)
mlstm_bwd_dqdk_scalars_kernel(const T* __restrict__ h,
                              const T* __restrict__ dh,
                              const float* __restrict__ li_g,
                              const float* __restrict__ lf_g,
                              const float* __restrict__ mst,
                              const float* __restrict__ mloc_g,
                              const float* __restrict__ den_g, float* ws,
                              int BH, int S, int K, int L, float scale) {
  __shared__ float hd[LMAX], sF[LMAX], sc[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = S / L;
  const int64_t N = (int64_t)BH * S, row0 = b * S + (int64_t)c * L;
  const float m = mst[b * nc + c];
  for (int t = warp; t < L; t += NT8 / 32) {   // dh.h, a warp a row
    const T* x = dh + (row0 + t) * K;
    const T* y = h + (row0 + t) * K;
    float acc = 0.f;
    for (int j = lane; j < K; j += 32) acc = fmaf(to_f(x[j]), to_f(y[j]), acc);
#pragma unroll
    for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (lane == 0) hd[t] = acc;
  }
  if (warp == 0) {
    float f[2], ftot;
    chunk_cumsum(lf_g, row0, L, f, ftot);
    float ms = NEG;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int t = lane + 32 * x;
      if (t < L) {
        sF[t] = f[x];
        ms = fmaxf(ms, (li_g[row0 + t] + ftot) - f[x]);
      }
    }
    ms = warp_max(ms);
    if (lane == 0) {
      const float mn = fmaxf(m + ftot, ms);
      sc[0] = mn;
      sc[1] = ftot;
      ws[7 * N + b * nc + c] = expf(m + ftot - mn);
    }
  }
  __syncthreads();
  if (tid < L) {
    const int64_t row = row0 + tid;
    const float Fv = sF[tid], ml = mloc_g[row], d = den_g[row];
    const float fl = expf(-ml), dd = fmaxf(fabsf(d), fl);
    const float hdt = hd[tid];
    const float dden = fabsf(d) > fl ? (d > 0.f ? -hdt / dd : hdt / dd) : 0.f;
    const float ci = expf((m + Fv) - ml);
    ws[row] = Fv;
    ws[N + row] = ci;
    ws[2 * N + row] = expf((li_g[row] + sc[1]) - Fv - sc[0]);
    ws[3 * N + row] = dd;
    ws[4 * N + row] = dden;
    ws[5 * N + row] = (ci * scale) / dd;
    ws[6 * N + row] = dden * (ci * scale);
  }
}

// ------------------------------------------ backward: the dC pass
// dC and dn at each chunk's end into the workspace: X = dC, A = q, B = dh,
// a = coef (dnum's 1 / denominator folded in), an = coefn.
template <typename T>
__global__ void __launch_bounds__(NT4, 2)
mlstm_bwd_dqdk_state_kernel(const T* __restrict__ q,
                            const T* __restrict__ dh, float* __restrict__ dCw,
                            float* __restrict__ dnw, const float* ws, int BH,
                            int S, int K, int L) {
  extern __shared__ float sm[];
  const int64_t N = (int64_t)BH * S;
  state_walk<T, true>(sm, q, dh, ws + 5 * N, ws + 6 * N, ws + 7 * N, dCw,
                      dnw, S, K, L);
}

// ------------------------------------------ backward: dq and dk
// Block (chunk, head), 8 warps. Steps, each one stage of the cp.async
// ring: K / 64 slices of dh v^T on all warps, after which dP = A * (dh v^T
// / denominator + dden) goes to shared memory; then, per 64-column tile r
// of dq and dk, K / 64 slices of dh C_st[r, :]^T (warps 0-3) and of v
// dC[r, :]^T (warps 4-7), and one step of dP k[:, r] and dP^T q[:, r],
// after which dq[:, r] and dk[:, r] are written.
template <typename T>
__global__ void __launch_bounds__(NT8, 1)
mlstm_bwd_dqdk_grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dh,
                           const float* __restrict__ li_g,
                           const float* __restrict__ Cst,
                           const float* __restrict__ nst,
                           const float* __restrict__ mloc_g,
                           const float* __restrict__ dCw,
                           const float* __restrict__ dnw, const float* ws,
                           float* __restrict__ dq, float* __restrict__ dk,
                           int BH, int S, int K, int L, float scale) {
  extern __shared__ float sm[];
  constexpr int LDR = Ld<T>::ROW, LDC = Ld<T>::COL, LDF = Ld<float>::ROW;
  float* Ps = sm + 2 * GR_STAGE;        // [64][LDP] dP
  float* F = Ps + TILE * LDP;           // [64] each from here
  float* li = F + TILE;
  float* ml = li + TILE;
  float* ci = ml + TILE;
  float* w = ci + TILE;
  float* dd = w + TILE;
  float* de = dd + TILE;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = S / L, ns = K / TILE;
  const int64_t N = (int64_t)BH * S, row0 = b * S + (int64_t)c * L;
  const int64_t st = b * nc + c;
  const float* Cc = Cst + st * K * K;
  const float* dCc = dCw + st * K * K;
  if (tid < TILE) {
    const bool in = tid < L;
    const int64_t row = row0 + tid;
    F[tid] = in ? ws[row] : 0.f;
    li[tid] = in ? li_g[row] : 0.f;
    ml[tid] = in ? mloc_g[row] : 0.f;
    ci[tid] = in ? ws[N + row] : 0.f;
    w[tid] = in ? ws[2 * N + row] : 0.f;
    dd[tid] = in ? ws[3 * N + row] : 1.f;
    de[tid] = in ? ws[4 * N + row] : 0.f;
  }
  auto load = [&](int stage, int i) {
    float* s = sm + stage * GR_STAGE;
    T* r0s = reinterpret_cast<T*>(s);
    T* r1s = reinterpret_cast<T*>(s + REG);
    if (i < ns) {
      load_tile<T, NT8>(r0s, LDR, dh + row0 * K + i * TILE, K, L);
      load_tile<T, NT8>(r1s, LDR, v + row0 * K + i * TILE, K, L);
      return;
    }
    const int rt = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    if (sl < ns) {
      load_tile<T, NT8>(r0s, LDR, dh + row0 * K + sl * TILE, K, L);
      load_tile<T, NT8>(r1s, LDR, v + row0 * K + sl * TILE, K, L);
      const int64_t o = (int64_t)rt * TILE * K + sl * TILE;
      load_tile<float, NT8>(s + 2 * REG, LDF, Cc + o, K, TILE);
      load_tile<float, NT8>(s + 3 * REG, LDF, dCc + o, K, TILE);
    } else {
      load_tile<T, NT8>(r0s, LDC, k + row0 * K + rt * TILE, K, L);
      load_tile<T, NT8>(r1s, LDC, q + row0 * K + rt * TILE, K, L);
      if (tid < TILE)
        cp_async4(s + 4 * REG + tid, nst + st * K + rt * TILE + tid, true);
      else if (tid < 2 * TILE)
        cp_async4(s + 4 * REG + tid, dnw + st * K + rt * TILE + tid - TILE,
                  true);
    }
  };
  const int steps = ns + ns * (ns + 1);
  load(0, 0);
  cp_commit();

  // dP: warps 2 x 4 over 64 x 64, each 32 x 16
  const int pm = (warp & 1) * 32, pn = (warp >> 1) * 16;
  float accp[2][2][4] = {};
  ring(0, ns, steps, GR_STAGE, sm, load, [&](int, const float* s) {
    const T* dhs = reinterpret_cast<const T*>(s);
    const T* vs = reinterpret_cast<const T*>(s + REG);
    float part[2][2][4] = {};
    warp_mma<2, 2, 8>(
        part, [&](int r, int kk) { return to_f(dhs[(pm + r) * LDR + kk]); },
        [&](int kk, int col) { return to_f(vs[(pn + col) * LDR + kk]); });
    add_to(accp, part);
  });
  each_pair<2, 2>([&](int r, int col, int ii, int jj, int e) {
    const int t = pm + r;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int sx = pn + col + x;
      float p = 0.f;
      if (sx <= t && t < L)
        p = expf(((F[t] - F[sx]) + li[sx]) - ml[t]) *
            (accp[ii][jj][e + x] / dd[t] + de[t]);
      Ps[t * LDP + sx] = p;
    }
  });

  // dq (warps 0-3) and dk (warps 4-7): 2 x 2 over 64 x 64, each 32 x 32;
  // the next step's barrier precedes every read of dP
  const bool is_dk = warp >= 4;
  const int wm = (warp & 1) * 32, wn = ((warp >> 1) & 1) * 32;
  float acc[2][4][4] = {};
  ring(ns, steps, steps, GR_STAGE, sm, load, [&](int i, const float* s) {
    const int rt = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    const T* r0s = reinterpret_cast<const T*>(s);
    const T* r1s = reinterpret_cast<const T*>(s + REG);
    float part[2][4][4] = {};
    if (sl < ns) {
      const float* bs = s + (is_dk ? 3 : 2) * REG;
      const T* as = is_dk ? r1s : r0s;
      warp_mma<2, 4, 8>(
          part, [&](int r, int kk) { return to_f(as[(wm + r) * LDR + kk]); },
          [&](int kk, int col) { return bs[(wn + col) * LDF + kk]; });
      add_to(acc, part);
      return;
    }
    if (!is_dk) {    // dq = scale (c_int (dh C^T / dd + dden n) + dP k)
      const float* n = s + 4 * REG;
      warp_mma<2, 4, 8>(
          part, [&](int r, int sx) { return Ps[(wm + r) * LDP + sx]; },
          [&](int sx, int col) { return to_f(r0s[sx * LDC + wn + col]); });
      float* out = dq + (row0 + wm) * K + rt * TILE + wn;
      each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
        const int t = wm + r;
        if (t < L) {
          float o[2];
#pragma unroll
          for (int x = 0; x < 2; ++x)
            o[x] = (ci[t] * (acc[ii][jj][e + x] / dd[t] +
                             de[t] * n[wn + col + x]) +
                    part[ii][jj][e + x]) * scale;
          *reinterpret_cast<float2*>(out + (int64_t)r * K + col) =
              make_float2(o[0], o[1]);
        }
      });
    } else {         // dk = w (v dC^T + dn) + dP^T q scale
      const float* dn = s + 4 * REG + TILE;
      warp_mma<2, 4, 8>(
          part, [&](int r, int t) { return Ps[t * LDP + wm + r]; },
          [&](int t, int col) { return to_f(r1s[t * LDC + wn + col]); });
      float* out = dk + (row0 + wm) * K + rt * TILE + wn;
      each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
        const int sx = wm + r;
        if (sx < L) {
          float o[2];
#pragma unroll
          for (int x = 0; x < 2; ++x)
            o[x] = w[sx] * (acc[ii][jj][e + x] + dn[wn + col + x]) +
                   part[ii][jj][e + x] * scale;
          *reinterpret_cast<float2*>(out + (int64_t)r * K + col) =
              make_float2(o[0], o[1]);
        }
      });
    }
    zero(acc);
  });
  cp_wait<0>();
}

// Four f32 of T (16 or 8 bytes) from device memory.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ------------------------------------- backward: dv and the log gates
// Block (chunk, head), 4 warps. First each row's q.dq and k.dk over all K
// columns (a warp a row, 16 bytes a lane): dlog_i = k.dk, and dF = q.dq -
// k.dk into dlog_f, which the scalar pass then sums. Then steps, each one
// stage of the cp.async ring: K / 64 slices of q k^T, after which P' = A *
// (q k^T) scale / denominator_t goes to shared memory (t is the next
// product's reduction index, so 1 / denominator_t cannot be applied after
// it); then, per 64-column tile j of dv, K / 64 slices of k dC[:, j] and
// one step of P'^T dh[:, j], after which dv[:, j] = w (k dC[:, j]) + P'^T
// dh[:, j] is written. dC is the state's gradient at the chunk's end, as
// mlstm_bwd_dqdk's walk wrote it; F, w and the denominator are its
// workspace rows 0, 2 and 3.
template <typename T>
__global__ void __launch_bounds__(NT4, 2)
mlstm_bwd_dv_grad_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ dh,
                         const float* __restrict__ li_g,
                         const float* __restrict__ mloc_g,
                         const float* __restrict__ dCw, const float* ws,
                         const float* __restrict__ dq,
                         const float* __restrict__ dk, float* __restrict__ dv,
                         float* __restrict__ dli, float* __restrict__ dlf,
                         int BH, int S, int K, int L, float scale) {
  extern __shared__ float sm[];
  constexpr int LDR = Ld<T>::ROW, LDC = Ld<T>::COL;
  float* Ps = sm + 2 * ST_STAGE;        // [64][LDT] P', read transposed
  float* F = Ps + TILE * LDT;           // [64] each from here
  float* li = F + TILE;
  float* ml = li + TILE;
  float* w = ml + TILE;
  float* dd = w + TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = S / L, ns = K / TILE;
  const int64_t N = (int64_t)BH * S, row0 = b * S + (int64_t)c * L;
  const float* dCc = dCw + (b * nc + c) * K * K;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  if (tid < TILE) {
    const bool in = tid < L;
    const int64_t row = row0 + tid;
    F[tid] = in ? ws[row] : 0.f;
    li[tid] = in ? li_g[row] : 0.f;
    ml[tid] = in ? mloc_g[row] : 0.f;
    w[tid] = in ? ws[2 * N + row] : 0.f;
    dd[tid] = in ? ws[3 * N + row] : 1.f;
  }
  auto load = [&](int stage, int i) {
    float* s = sm + stage * ST_STAGE;
    T* r0s = reinterpret_cast<T*>(s);
    if (i < ns) {
      load_tile<T, NT4>(r0s, LDR, q + row0 * K + i * TILE, K, L);
      load_tile<T, NT4>(reinterpret_cast<T*>(s + REG), LDR,
                        k + row0 * K + i * TILE, K, L);
      return;
    }
    const int j = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    if (sl < ns) {
      load_tile<T, NT4>(r0s, LDR, k + row0 * K + sl * TILE, K, L);
      load_tile<float, NT4>(s + REG, 72, dCc + (int64_t)sl * TILE * K +
                                             j * TILE, K, TILE);
    } else {
      load_tile<T, NT4>(r0s, LDC, dh + row0 * K + j * TILE, K, L);
    }
  };
  const int steps = ns + ns * (ns + 1);
  load(0, 0);
  cp_commit();

  // the log gates' row sums, under the first stage's copies
  for (int t = warp; t < L; t += NT4 / 32) {
    const int64_t o = (row0 + t) * K;
    float a1 = 0.f, a2 = 0.f;
    for (int x = 4 * lane; x < K; x += 128) {
      const float4 qv = ld4(q + o + x), dqv = ld4(dq + o + x);
      const float4 kv = ld4(k + o + x), dkv = ld4(dk + o + x);
      a1 = fmaf(qv.x, dqv.x, a1);
      a1 = fmaf(qv.y, dqv.y, a1);
      a1 = fmaf(qv.z, dqv.z, a1);
      a1 = fmaf(qv.w, dqv.w, a1);
      a2 = fmaf(kv.x, dkv.x, a2);
      a2 = fmaf(kv.y, dkv.y, a2);
      a2 = fmaf(kv.z, dkv.z, a2);
      a2 = fmaf(kv.w, dkv.w, a2);
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) {
      a1 += __shfl_xor_sync(FULL, a1, m);
      a2 += __shfl_xor_sync(FULL, a2, m);
    }
    if (lane == 0) {
      dli[row0 + t] = a2;
      dlf[row0 + t] = a1 - a2;
    }
  }

  // P': warps 2 x 2 over 64 x 64, each 32 x 32
  float accs[2][4][4] = {};
  ring(0, ns, steps, ST_STAGE, sm, load, [&](int, const float* s) {
    const T* qs = reinterpret_cast<const T*>(s);
    const T* ks = reinterpret_cast<const T*>(s + REG);
    float part[2][4][4] = {};
    warp_mma<2, 4, 8>(
        part, [&](int r, int kk) { return to_f(qs[(wm + r) * LDR + kk]); },
        [&](int kk, int col) { return to_f(ks[(wn + col) * LDR + kk]); });
    add_to(accs, part);
  });
  each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
    const int t = wm + r;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int sx = wn + col + x;
      float p = 0.f;
      if (sx <= t && t < L)
        p = expf(((F[t] - F[sx]) + li[sx]) - ml[t]) *
            ((accs[ii][jj][e + x] * scale) / dd[t]);
      Ps[t * LDT + sx] = p;
    }
  });

  // dv; the next step's barrier precedes every read of P'
  float acc[2][4][4] = {};
  ring(ns, steps, steps, ST_STAGE, sm, load, [&](int i, const float* s) {
    const int j = (i - ns) / (ns + 1), sl = (i - ns) % (ns + 1);
    const T* r0s = reinterpret_cast<const T*>(s);
    float part[2][4][4] = {};
    if (sl < ns) {
      const float* cs = s + REG;
      warp_mma<2, 4, 8>(
          part, [&](int r, int kk) { return to_f(r0s[(wm + r) * LDR + kk]); },
          [&](int kk, int col) { return cs[kk * 72 + wn + col]; });
      add_to(acc, part);
      return;
    }
    warp_mma<2, 4, 8>(
        part, [&](int r, int t) { return Ps[t * LDT + wm + r]; },
        [&](int t, int col) { return to_f(r0s[t * LDC + wn + col]); });
    float* out = dv + (row0 + wm) * K + j * TILE + wn;
    each_pair<2, 4>([&](int r, int col, int ii, int jj, int e) {
      const int sx = wm + r;
      if (sx < L)
        *reinterpret_cast<float2*>(out + (int64_t)r * K + col) = make_float2(
            w[sx] * acc[ii][jj][e] + part[ii][jj][e],
            w[sx] * acc[ii][jj][e + 1] + part[ii][jj][e + 1]);
    });
    zero(acc);
  });
  cp_wait<0>();
}

// ---------------------------------------- backward: dlog_f's scalar pass
// Block per head: dlog_f_t = sum_{j >= t} dF_j over the head's rows, in
// place of dF. NT8 rows a step from the last: a warp scan over 32 rows,
// then each warp adds the sums of the warps before it and of the later
// steps, in one fixed order.
__global__ void __launch_bounds__(NT8)
mlstm_bwd_dv_scalars_kernel(float* __restrict__ dlf, int S) {
  __shared__ float tot[NT8 / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* d = dlf + (int64_t)blockIdx.x * S;
  float carry = 0.f;                    // the same in every thread
  for (int e = S; e > 0; e -= NT8) {    // rows e - 1 - tid
    const int t = e - 1 - tid;
    float x = warp_cumsum(t >= 0 ? d[t] : 0.f);
    if (lane == 31) tot[warp] = x;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < NT8 / 32; ++v) {
      if (v == warp) x += carry;
      carry += tot[v];
    }
    if (t >= 0) d[t] = x;
    __syncthreads();
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

constexpr size_t state_smem() { return sizeof(float) * 2 * ST_STAGE; }
constexpr size_t out_smem() {
  return sizeof(float) * (2 * ST_STAGE + TILE * LDP + 6 * TILE);
}
constexpr size_t grad_smem() {
  return sizeof(float) * (2 * GR_STAGE + TILE * LDP + 7 * TILE);
}
constexpr size_t dv_smem() {
  return sizeof(float) * (2 * ST_STAGE + TILE * LDT + 5 * TILE);
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* li,
        const void* lf, void* h, void* Cst, void* nst, void* mst,
        void* mloc, void* den, void* ws, int BH, int S, int K, int L,
        float scale, cudaStream_t st) {
  mlstm_fwd_scalars_kernel<<<BH, NT8, 0, st>>>(
      (const float*)li, (const float*)lf, (float*)mst, (float*)mloc,
      (float*)ws, BH, S, L);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = set_smem(mlstm_fwd_state_kernel<T>, state_smem())) return rc;
  mlstm_fwd_state_kernel<T><<<dim3(K / TILE, K / TILE, BH), NT4,
                              state_smem(), st>>>(
      (const T*)k, (const T*)v, (float*)Cst, (float*)nst, (const float*)ws,
      BH, S, K, L);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = set_smem(mlstm_fwd_out_kernel<T>, out_smem())) return rc;
  mlstm_fwd_out_kernel<T><<<dim3(S / L, BH), NT4, out_smem(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)li, (T*)h,
      (const float*)Cst, (const float*)nst, (const float*)mloc, (float*)den,
      (const float*)ws, BH, S, K, L, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dqdk(const void* q, const void* k, const void* v, const void* li,
             const void* lf, const void* h, const void* dh,
             const void* Cst, const void* nst, const void* mst,
             const void* mloc, const void* den, void* dq, void* dk,
             void* dCw, void* dnw, void* ws, int BH, int S, int K, int L,
             float scale, cudaStream_t st) {
  mlstm_bwd_dqdk_scalars_kernel<T><<<dim3(S / L, BH), NT8, 0, st>>>(
      (const T*)h, (const T*)dh, (const float*)li, (const float*)lf,
      (const float*)mst, (const float*)mloc, (const float*)den, (float*)ws,
      BH, S, K, L, scale);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = set_smem(mlstm_bwd_dqdk_state_kernel<T>, state_smem()))
    return rc;
  mlstm_bwd_dqdk_state_kernel<T><<<dim3(K / TILE, K / TILE, BH), NT4,
                                   state_smem(), st>>>(
      (const T*)q, (const T*)dh, (float*)dCw, (float*)dnw, (const float*)ws,
      BH, S, K, L);
  if (int rc = (int)cudaGetLastError()) return rc;
  if (int rc = set_smem(mlstm_bwd_dqdk_grad_kernel<T>, grad_smem()))
    return rc;
  mlstm_bwd_dqdk_grad_kernel<T><<<dim3(S / L, BH), NT8, grad_smem(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dh, (const float*)li,
      (const float*)Cst, (const float*)nst, (const float*)mloc,
      (const float*)dCw, (const float*)dnw, (const float*)ws, (float*)dq,
      (float*)dk, BH, S, K, L, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dv(const void* q, const void* k, const void* li, const void* dh,
           const void* mloc, const void* dCw, const void* ws,
           const void* dq, const void* dk, void* dv, void* dli, void* dlf,
           int BH, int S, int K, int L, float scale, cudaStream_t st) {
  if (int rc = set_smem(mlstm_bwd_dv_grad_kernel<T>, dv_smem())) return rc;
  mlstm_bwd_dv_grad_kernel<T><<<dim3(S / L, BH), NT4, dv_smem(), st>>>(
      (const T*)q, (const T*)k, (const T*)dh, (const float*)li,
      (const float*)mloc, (const float*)dCw, (const float*)ws,
      (const float*)dq, (const float*)dk, (float*)dv, (float*)dli,
      (float*)dlf, BH, S, K, L, scale);
  if (int rc = (int)cudaGetLastError()) return rc;
  mlstm_bwd_dv_scalars_kernel<<<BH, NT8, 0, st>>>((float*)dlf, S);
  return (int)cudaGetLastError();
}

bool shape_ok(int bh, int s, int kd, int chunk, int dtype) {
  return bh > 0 && bh <= 65535 && s > 0 && kd > 0 && kd % TILE == 0 &&
         kd <= 512 && chunk >= 1 && chunk <= LMAX && s % chunk == 0 &&
         (dtype == 0 || dtype == 1);
}

// Every pointer given, and the (BH, S, K) arrays 16-byte aligned, as the
// tensor-core passes' cp.async copies need.
bool ptrs_ok(std::initializer_list<const void*> all,
             std::initializer_list<const void*> wide) {
  for (const void* p : all)
    if (!p) return false;
  for (const void* p : wide)
    if ((uintptr_t)p % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = launched), or
// 100000 for a shape, dtype (0 = float32, 1 = bfloat16 for q, k, v, h and
// dh) or pointer the kernels do not take. ws is a workspace of 8 * bh * s
// f32 for mlstm_fwd and mlstm_bwd_dqdk; mlstm_bwd_dv reads the latter's.
// mlstm_fwd writes h and every aux array (C, n, m states, m_loc, den).
int mlstm_fwd(const void* q, const void* k, const void* v, const void* li,
              const void* lf, void* h, void* Cst, void* nst, void* mst,
              void* mloc, void* den, void* ws, int bh, int s, int kd,
              int chunk, int dtype, float scale, void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype) ||
      !ptrs_ok({q, k, v, li, lf, h, Cst, nst, mst, mloc, den, ws},
               {q, k, v, h, Cst}))
    return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd<float>(q, k, v, li, lf, h, Cst, nst, mst, mloc, den, ws, bh,
                      s, kd, chunk, scale, st);
  return fwd<__nv_bfloat16>(q, k, v, li, lf, h, Cst, nst, mst, mloc, den,
                            ws, bh, s, kd, chunk, scale, st);
}

// mlstm_bwd_dqdk writes dq, dk and, for each chunk, the gradient of the
// state at its end: dC (bh, nc, kd, kd) and dn (bh, nc, kd).
int mlstm_bwd_dqdk(const void* q, const void* k, const void* v,
                   const void* li, const void* lf, const void* h,
                   const void* dh, const void* Cst, const void* nst,
                   const void* mst, const void* mloc, const void* den,
                   void* dq, void* dk, void* dC, void* dn, void* ws, int bh,
                   int s, int kd, int chunk, int dtype, float scale,
                   void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype) ||
      !ptrs_ok({q, k, v, li, lf, h, dh, Cst, nst, mst, mloc, den, dq, dk,
                dC, dn, ws},
               {q, k, v, dh, Cst, dq, dk, dC}))
    return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dqdk<float>(q, k, v, li, lf, h, dh, Cst, nst, mst, mloc,
                           den, dq, dk, dC, dn, ws, bh, s, kd, chunk, scale,
                           st);
  return bwd_dqdk<__nv_bfloat16>(q, k, v, li, lf, h, dh, Cst, nst, mst,
                                 mloc, den, dq, dk, dC, dn, ws, bh, s, kd,
                                 chunk, scale, st);
}

// mlstm_bwd_dv writes dv, dlog_i and dlog_f from what mlstm_bwd_dqdk
// wrote: dq, dk, the state's gradient dC at each chunk's end and its
// workspace ws (F, w and the denominator of each row).
int mlstm_bwd_dv(const void* q, const void* k, const void* li,
                 const void* dh, const void* mloc, const void* dC,
                 const void* ws, const void* dq, const void* dk, void* dv,
                 void* dli, void* dlf, int bh, int s, int kd, int chunk,
                 int dtype, float scale, void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype) ||
      !ptrs_ok({q, k, li, dh, mloc, dC, ws, dq, dk, dv, dli, dlf},
               {q, k, dh, dC, dq, dk, dv}))
    return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dv<float>(q, k, li, dh, mloc, dC, ws, dq, dk, dv, dli, dlf,
                         bh, s, kd, chunk, scale, st);
  return bwd_dv<__nv_bfloat16>(q, k, li, dh, mloc, dC, ws, dq, dk, dv, dli,
                               dlf, bh, s, kd, chunk, scale, st);
}

}  // extern "C"
