// Causal/non-causal, optionally windowed attention for Hopper (sm_90a):
// forward and backward.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (forward only there; the JAX
// package takes the gradient by autodiff through dense_attention). Here
// the backward is two kernels of its own, so training never leaves the
// hand-written path.
//
//   flash_fwd       one block per (q tile, bh); loops over kv tiles with
//                   an f32 running max m, denominator l and accumulator,
//                   skipping kv tiles wholly above the diagonal when
//                   causal and wholly below the window. Writes o (input
//                   dtype) and lse = m + log(max(l, 1e-30)) (f32,
//                   (BH, S)).
//   flash_bwd_dkdv  one block per (kv tile, bh); loops over q tiles
//                   (skipping those wholly above the window),
//                   recomputing P = exp(S*scale - lse) and
//                   D_i = rowsum(dO_i * O_i); dV += P^T dO,
//                   dK += scale * dS^T Q with dS = P * (dO V^T - D).
//   flash_bwd_dq    one block per (q tile, bh); loops over kv tiles as
//                   the forward does; dQ += scale * dS K.
//
// Mask: key k is visible to query q when k < S, k <= q (causal) and
// q - k < window (window > 0), the reference's sliding window
// (src/repro/models/attention.py, _mask_bias).
//
// Every block owns its outputs: no atomics, and a fixed loop order, so
// results repeat bitwise from run to run.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (BH, S, D); f32 or
// bf16, computed in f32. D is a template parameter (16, 32, 64, 128,
// 256), and so is the tile size BQ (q rows = kv rows per tile): 64 for
// D <= 128, 32 for D = 256, where 64-row tiles would need more shared
// memory than a block may have in both backward kernels (300,032 and
// 283,392 B against 232,448) and 128 accumulator registers a thread in
// the forward. Each of the 128 threads owns a BQ/16 x BQ/8 tile of
// scores and BQ/16 rows of the accumulator, so the D <= 128 instances
// run exactly the arithmetic they ran before the template grew. S need
// not be a multiple of BQ: the ragged edge is masked (rows >= S load as
// zero, their scores are masked and their outputs are not written), so
// the reference's "blocks divide S" contract is relaxed rather than
// kept.
//
// What bounds it on an H100: at the main paths' shapes (BH 32, S 2048,
// D 64, causal; BH 10, S 4096, D 256, window 2048) the work is 17 and
// 64 GFLOP forward per call against 25 and 84 MB of inputs and outputs,
// far above the card's bytes-to-FLOP line, so the bound is arithmetic.
// This first version does the two products with plain f32 FMA loops
// over shared-memory tiles (each thread a BQ/16 x BQ/8 register tile of
// scores and a BQ/16 x D/8 tile of the accumulator), so it runs at
// CUDA-core f32 rate at best; tensor cores (wgmma on bf16) are the next
// step. Shared-memory tiles are stored transposed with a stride of
// BQ + 1 floats so that every access pattern below is free of bank
// conflicts (or a broadcast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;         // threads per block: 16 row groups x 8
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Rows per tile (q and kv alike) for head dim D.
template <int D> constexpr int tile_rows() { return D > 128 ? 32 : 64; }

// Whether key kj is visible to query qi.
__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return kj < S && (!causal || kj <= qi) && (!window || qi - kj < window);
}

// First kv tile any query of the q tile starting at q0 can see.
__device__ __forceinline__ int first_kv_tile(int q0, int window, int bq) {
  return window ? max(0, q0 - window + 1) / bq : 0;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + BQ) of an (S, D) matrix into t[d * LD + r] as f32;
// rows >= S read as zero. Neighbouring threads read neighbouring d.
template <typename T, int D, int BQ>
__device__ __forceinline__ void load_t(float* t, const T* g, int r0,
                                       int S) {
  constexpr int LD = BQ + 1;
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    t[d * LD + r] = row < S ? to_f(g[(size_t)row * D + d]) : 0.f;
  }
}

// lse and D_i = rowsum(dO * O) for the BQ q rows of a tile, NT / BQ
// threads per row (dO from its transposed tile, O from device memory).
template <typename T, int D, int BQ>
__device__ __forceinline__ void load_lse_delta(
    float* Ls, float* Ds, const float* dOt, const T* o, const float* lse,
    int q0, int S) {
  constexpr int LD = BQ + 1, TPR = NT / BQ;
  const int r = threadIdx.x / TPR, h = threadIdx.x % TPR, row = q0 + r;
  float acc = 0.f;
  if (row < S)
    for (int d = h; d < D; d += TPR)
      acc += to_f(o[(size_t)row * D + d]) * dOt[d * LD + r];
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    acc += __shfl_xor_sync(FULL, acc, off);
  if (h == 0) {
    Ds[r] = acc;
    Ls[r] = row < S ? lse[row] : 0.f;
  }
}


template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int causal, int window,
           float scale) {
  constexpr int DC = D / 8, LD = BQ + 1, RQ = BQ / 16, CK = BQ / 8;
  extern __shared__ float sm[];
  float* Qt = sm;
  float* Kt = Qt + D * LD;
  float* Vt = Kt + D * LD;
  float* Ps = Vt + D * LD;                 // Ps[c * LD + r]
  const int bh = blockIdx.y, qt = blockIdx.x, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D, BQ>(Qt, q + base, q0, S);
  float acc[RQ][DC], m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (S + BQ - 1) / BQ;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;
  for (int kt = first_kv_tile(q0, window, BQ); kt < kv_end; ++kt) {
    const int k0 = kt * BQ;
    __syncthreads();                       // previous tiles consumed
    load_t<T, D, BQ>(Kt, k + base, k0, S);
    load_t<T, D, BQ>(Vt, v + base, k0, S);
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], b[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qt[d * LD + ty * RQ + i];
#pragma unroll
      for (int j = 0; j < CK; ++j) b[j] = Kt[d * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty * RQ + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (!visible(qi, kj, S, causal, window)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tx + 8 * j) * LD + ty * RQ + i] = p;
      }
      rs += __shfl_xor_sync(FULL, rs, 1);
      rs += __shfl_xor_sync(FULL, rs, 2);
      rs += __shfl_xor_sync(FULL, rs, 4);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = Ps[c * LD + ty * RQ + i];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = Vt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][dc] += p[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      o[base + (size_t)r * D + tx + 8 * dc] = from_f<T>(acc[i][dc] / den);
    if (tx == 0) lse[(size_t)bh * S + r] = m[i] + logf(den);
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                int window, float scale) {
  constexpr int DC = D / 8, LD = BQ + 1, RQ = BQ / 16, CK = BQ / 8;
  extern __shared__ float sm[];
  float* Kt = sm;
  float* Vt = Kt + D * LD;
  float* Qt = Vt + D * LD;
  float* dOt = Qt + D * LD;
  float* Ps = dOt + D * LD;                // Ps[q * LD + kr]
  float* dSs = Ps + BQ * LD;               // dSs[q * LD + kr]
  float* Ls = dSs + BQ * LD;
  float* Ds = Ls + BQ;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D, BQ>(Kt, k + base, k0, S);
  load_t<T, D, BQ>(Vt, v + base, k0, S);
  float gk[RQ][DC], gv[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;
  const int n_q = (S + BQ - 1) / BQ;
  // the last query that sees a key of this tile is k0 + BQ - 2 + window
  const int q_end = window ? min(n_q, (k0 + BQ - 2 + window) / BQ + 1)
                           : n_q;
  for (int qt = causal ? kt : 0; qt < q_end; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_t<T, D, BQ>(Qt, q + base, q0, S);
    load_t<T, D, BQ>(dOt, dout + base, q0, S);
    __syncthreads();
    load_lse_delta<T, D, BQ>(Ls, Ds, dOt, o + base, lse + (size_t)bh * S,
                             q0, S);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RQ], av[RQ], b[CK], bo[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = Kt[d * LD + ty * RQ + i];
        av[i] = Vt[d * LD + ty * RQ + i];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        b[j] = Qt[d * LD + tx + 8 * j];
        bo[j] = dOt[d * LD + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += av[i] * bo[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int kr = k0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int qc = tx + 8 * j, qg = q0 + qc;
        const bool ok = qg < S && visible(qg, kr, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
        Ps[qc * LD + ty * RQ + i] = p;
        dSs[qc * LD + ty * RQ + i] = p * (dp[i][j] - Ds[qc]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[RQ], ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        p[i] = Ps[c * LD + ty * RQ + i];
        ds[i] = dSs[c * LD + ty * RQ + i];
      }
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float g = dOt[(tx + 8 * dc) * LD + c];
        const float x = Qt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          gv[i][dc] += p[i] * g;
          gk[i][dc] += ds[i] * x;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = k0 + ty * RQ + i;
    if (r >= S) continue;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const size_t at = base + (size_t)r * D + tx + 8 * dc;
      dk[at] = from_f<T>(gk[i][dc] * scale);
      dv[at] = from_f<T>(gv[i][dc]);
    }
  }
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, int S, int causal, int window,
              float scale) {
  constexpr int DC = D / 8, LD = BQ + 1, RQ = BQ / 16, CK = BQ / 8;
  extern __shared__ float sm[];
  float* Qt = sm;
  float* dOt = Qt + D * LD;
  float* Kt = dOt + D * LD;
  float* Vt = Kt + D * LD;
  float* dSs = Vt + D * LD;                // dSs[kc * LD + q]
  float* Ls = dSs + BQ * LD;
  float* Ds = Ls + BQ;
  const int bh = blockIdx.y, qt = blockIdx.x, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D, BQ>(Qt, q + base, q0, S);
  load_t<T, D, BQ>(dOt, dout + base, q0, S);
  __syncthreads();
  load_lse_delta<T, D, BQ>(Ls, Ds, dOt, o + base, lse + (size_t)bh * S,
                           q0, S);
  float gq[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gq[i][c] = 0.f;
  const int n_kv = (S + BQ - 1) / BQ;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;
  for (int kt = first_kv_tile(q0, window, BQ); kt < kv_end; ++kt) {
    const int k0 = kt * BQ;
    __syncthreads();
    load_t<T, D, BQ>(Kt, k + base, k0, S);
    load_t<T, D, BQ>(Vt, v + base, k0, S);
    __syncthreads();
    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[RQ], ao[RQ], b[CK], bv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = Qt[d * LD + ty * RQ + i];
        ao[i] = dOt[d * LD + ty * RQ + i];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        b[j] = Kt[d * LD + tx + 8 * j];
        bv[j] = Vt[d * LD + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += ao[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qr = ty * RQ + i, qg = q0 + qr;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kc = tx + 8 * j, kg = k0 + kc;
        const bool ok = qg < S && visible(qg, kg, S, causal, window);
        const float p = ok ? expf(s[i][j] * scale - Ls[qr]) : 0.f;
        dSs[kc * LD + qr] = p * (dp[i][j] - Ds[qr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float ds[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) ds[i] = dSs[c * LD + ty * RQ + i];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float x = Kt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) gq[i][dc] += ds[i] * x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = q0 + ty * RQ + i;
    if (r >= S) continue;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      dq[base + (size_t)r * D + tx + 8 * dc] = from_f<T>(gq[i][dc] * scale);
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

template <typename K>
int launch_prep(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int bh, int S, int causal, int window, float scale,
        cudaStream_t st) {
  constexpr int BQ = tile_rows<D>(), LD = BQ + 1;
  const size_t smem = (3 * D * LD + BQ * LD) * sizeof(float);
  auto kern = fwd_kernel<T, D, BQ>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (T*)o, lse, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* o,
         const float* lse, const void* dout, void* dk, void* dv, int bh,
         int S, int causal, int window, float scale, cudaStream_t st) {
  constexpr int BQ = tile_rows<D>(), LD = BQ + 1;
  const size_t smem = (4 * D * LD + 2 * BQ * LD + 2 * BQ) * sizeof(float);
  auto kern = bwd_dkdv_kernel<T, D, BQ>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (const T*)o, lse, (const T*)dout, (T*)dk,
                               (T*)dv, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const float* lse, const void* dout, void* dqp, int bh, int S,
       int causal, int window, float scale, cudaStream_t st) {
  constexpr int BQ = tile_rows<D>(), LD = BQ + 1;
  const size_t smem = (4 * D * LD + BQ * LD + 2 * BQ) * sizeof(float);
  auto kern = bwd_dq_kernel<T, D, BQ>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (const T*)o, lse, (const T*)dout, (T*)dqp,
                               S, causal, window, scale);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
#define DISPATCH(FN, ...)                                                 \
  switch (d * 2 + dtype) {                                                \
    case 32: return FN<float, 16>(__VA_ARGS__);                           \
    case 33: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                   \
    case 64: return FN<float, 32>(__VA_ARGS__);                           \
    case 65: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                   \
    case 128: return FN<float, 64>(__VA_ARGS__);                          \
    case 129: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                  \
    case 256: return FN<float, 128>(__VA_ARGS__);                         \
    case 257: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                 \
    case 512: return FN<float, 256>(__VA_ARGS__);                         \
    case 513: return FN<__nv_bfloat16, 256>(__VA_ARGS__);                 \
    default: return kUnsupported;                                         \
  }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// 100000 for a head dim / dtype / window with no instance. window = 0
// means no window.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int s, int d, int dtype, int causal,
              int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(fwd, q, k, v, o, (float*)lse, bh, s, causal, window, scale,
           (cudaStream_t)stream)
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   void* dk, void* dv, int bh, int s, int d, int dtype,
                   int causal, int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(dkdv, q, k, v, o, (const float*)lse, dout, dk, dv, bh, s,
           causal, window, scale, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* o, const void* lse, const void* dout,
                 void* dqp, int bh, int s, int d, int dtype, int causal,
                 int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(dq, q, k, v, o, (const float*)lse, dout, dqp, bh, s, causal,
           window, scale, (cudaStream_t)stream)
}

}  // extern "C"
