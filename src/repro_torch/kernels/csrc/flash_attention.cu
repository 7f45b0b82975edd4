// Causal/non-causal attention for Hopper (sm_90a): forward and backward.
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
//                   causal. Writes o (input dtype) and
//                   lse = m + log(max(l, 1e-30)) (f32, (BH, S)).
//   flash_bwd_dkdv  one block per (kv tile, bh); loops over q tiles,
//                   recomputing P = exp(S*scale - lse) and
//                   D_i = rowsum(dO_i * O_i); dV += P^T dO,
//                   dK += scale * dS^T Q with dS = P * (dO V^T - D).
//   flash_bwd_dq    one block per (q tile, bh); loops over kv tiles;
//                   dQ += scale * dS K.
//
// Every block owns its outputs: no atomics, and a fixed loop order, so
// results repeat bitwise from run to run.
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (BH, S, D); f32 or
// bf16, computed in f32. D is a template parameter (16, 32, 64, 128).
// Tiles are 64 x 64. S need not be a multiple of 64: the ragged edge is
// masked (rows >= S load as zero, their scores are masked and their
// outputs are not written), so the reference's "blocks divide S"
// contract is relaxed rather than kept.
//
// What bounds it on an H100: at the main path's shape (BH 32, S 2048,
// D 64) the work is ~17 GFLOP forward per call against ~25 MB of
// inputs and outputs, far above the card's bytes-to-FLOP line, so the
// bound is arithmetic. This first version does the two products with
// plain f32 FMA loops over shared-memory tiles (each thread a 4 x 8
// register tile of scores and a 4 x D/8 tile of the accumulator), so it
// runs at CUDA-core f32 rate at best; tensor cores (wgmma on bf16) are
// the next step. Shared-memory tiles are stored transposed with a
// stride of 65 floats so that every access pattern below is free of
// bank conflicts (or a broadcast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // q rows per tile
constexpr int BK = 64;          // kv rows per tile (must equal BQ)
constexpr int NT = 128;         // threads per block: 16 row groups x 8
constexpr int LD = BQ + 1;      // padded stride of transposed tiles
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// Rows [r0, r0 + 64) of an (S, D) matrix into t[d * LD + r] as f32;
// rows >= S read as zero. Neighbouring threads read neighbouring d.
template <typename T, int D>
__device__ __forceinline__ void load_t(float* t, const T* g, int r0,
                                       int S) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    t[d * LD + r] = row < S ? to_f(g[(size_t)row * D + d]) : 0.f;
  }
}

// lse and D_i = rowsum(dO * O) for the 64 q rows of a tile, two threads
// per row (dO from its transposed tile, O from device memory).
template <typename T, int D>
__device__ __forceinline__ void load_lse_delta(
    float* Ls, float* Ds, const float* dOt, const T* o, const float* lse,
    int q0, int S) {
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1, row = q0 + r;
  float acc = 0.f;
  if (row < S)
    for (int d = h; d < D; d += 2)
      acc += to_f(o[(size_t)row * D + d]) * dOt[d * LD + r];
  acc += __shfl_xor_sync(FULL, acc, 1);
  if (h == 0) {
    Ds[r] = acc;
    Ls[r] = row < S ? lse[row] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int causal, float scale) {
  constexpr int DC = D / 8;
  extern __shared__ float sm[];
  float* Qt = sm;
  float* Kt = Qt + D * LD;
  float* Vt = Kt + D * LD;
  float* Ps = Vt + D * LD;                 // Ps[c * LD + r]
  const int bh = blockIdx.y, qt = blockIdx.x, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D>(Qt, q + base, q0, S);
  float acc[4][DC], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }
  const int n_kv = (S + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                       // previous tiles consumed
    load_t<T, D>(Kt, k + base, k0, S);
    load_t<T, D>(Vt, v + base, k0, S);
    __syncthreads();
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qt[d * LD + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Kt[d * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx + 8 * j;
        float x = s[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) x = NEG_INF;
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
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(tx + 8 * j) * LD + ty * 4 + i] = p;
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
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[c * LD + ty * 4 + i];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = Vt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] += p[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      o[base + (size_t)r * D + tx + 8 * dc] = from_f<T>(acc[i][dc] / den);
    if (tx == 0) lse[(size_t)bh * S + r] = m[i] + logf(den);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                float scale) {
  constexpr int DC = D / 8;
  extern __shared__ float sm[];
  float* Kt = sm;
  float* Vt = Kt + D * LD;
  float* Qt = Vt + D * LD;
  float* dOt = Qt + D * LD;
  float* Ps = dOt + D * LD;                // Ps[q * LD + kr]
  float* dSs = Ps + BQ * LD;               // dSs[q * LD + kr]
  float* Ls = dSs + BQ * LD;
  float* Ds = Ls + BQ;
  const int bh = blockIdx.y, kt = blockIdx.x, k0 = kt * BK;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D>(Kt, k + base, k0, S);
  load_t<T, D>(Vt, v + base, k0, S);
  float gk[4][DC], gv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gk[i][c] = gv[i][c] = 0.f;
  const int n_q = (S + BQ - 1) / BQ;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_t<T, D>(Qt, q + base, q0, S);
    load_t<T, D>(dOt, dout + base, q0, S);
    __syncthreads();
    load_lse_delta<T, D>(Ls, Ds, dOt, o + base, lse + (size_t)bh * S, q0,
                         S);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], av[4], b[8], bo[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Kt[d * LD + ty * 4 + i];
        av[i] = Vt[d * LD + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = Qt[d * LD + tx + 8 * j];
        bo[j] = dOt[d * LD + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += av[i] * bo[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = tx + 8 * j, qg = q0 + qc;
        const bool ok = qg < S && kr < S && (!causal || kr <= qg);
        const float p = ok ? expf(s[i][j] * scale - Ls[qc]) : 0.f;
        Ps[qc * LD + ty * 4 + i] = p;
        dSs[qc * LD + ty * 4 + i] = p * (dp[i][j] - Ds[qc]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[c * LD + ty * 4 + i];
        ds[i] = dSs[c * LD + ty * 4 + i];
      }
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float g = dOt[(tx + 8 * dc) * LD + c];
        const float x = Qt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gv[i][dc] += p[i] * g;
          gk[i][dc] += ds[i] * x;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= S) continue;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const size_t at = base + (size_t)r * D + tx + 8 * dc;
      dk[at] = from_f<T>(gk[i][dc] * scale);
      dv[at] = from_f<T>(gv[i][dc]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, int S, int causal, float scale) {
  constexpr int DC = D / 8;
  extern __shared__ float sm[];
  float* Qt = sm;
  float* dOt = Qt + D * LD;
  float* Kt = dOt + D * LD;
  float* Vt = Kt + D * LD;
  float* dSs = Vt + D * LD;                // dSs[kc * LD + q]
  float* Ls = dSs + BK * LD;
  float* Ds = Ls + BQ;
  const int bh = blockIdx.y, qt = blockIdx.x, q0 = qt * BQ;
  const size_t base = (size_t)bh * S * D;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;

  load_t<T, D>(Qt, q + base, q0, S);
  load_t<T, D>(dOt, dout + base, q0, S);
  __syncthreads();
  load_lse_delta<T, D>(Ls, Ds, dOt, o + base, lse + (size_t)bh * S, q0, S);
  float gq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) gq[i][c] = 0.f;
  const int n_kv = (S + BK - 1) / BK;
  const int kv_end = causal ? min(n_kv, qt + 1) : n_kv;
  for (int kt = 0; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_t<T, D>(Kt, k + base, k0, S);
    load_t<T, D>(Vt, v + base, k0, S);
    __syncthreads();
    float s[4][8], dp[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float a[4], ao[4], b[8], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qt[d * LD + ty * 4 + i];
        ao[i] = dOt[d * LD + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        b[j] = Kt[d * LD + tx + 8 * j];
        bv[j] = Vt[d * LD + tx + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += ao[i] * bv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i, qg = q0 + qr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kc = tx + 8 * j, kg = k0 + kc;
        const bool ok = qg < S && kg < S && (!causal || kg <= qg);
        const float p = ok ? expf(s[i][j] * scale - Ls[qr]) : 0.f;
        dSs[kc * LD + qr] = p * (dp[i][j] - Ds[qr]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[c * LD + ty * 4 + i];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float x = Kt[(tx + 8 * dc) * LD + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) gq[i][dc] += ds[i] * x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
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
        int bh, int S, int causal, float scale, cudaStream_t st) {
  const size_t smem = (3 * D * LD + BK * LD) * sizeof(float);
  auto kern = fwd_kernel<T, D>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (T*)o, lse, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dkdv(const void* q, const void* k, const void* v, const void* o,
         const float* lse, const void* dout, void* dk, void* dv, int bh,
         int S, int causal, float scale, cudaStream_t st) {
  const size_t smem = (4 * D * LD + 2 * BQ * LD + 2 * BQ) * sizeof(float);
  auto kern = bwd_dkdv_kernel<T, D>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BK - 1) / BK, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (const T*)o, lse, (const T*)dout, (T*)dk,
                               (T*)dv, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* o,
       const float* lse, const void* dout, void* dqp, int bh, int S,
       int causal, float scale, cudaStream_t st) {
  const size_t smem = (4 * D * LD + BK * LD + 2 * BQ) * sizeof(float);
  auto kern = bwd_dq_kernel<T, D>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid((S + BQ - 1) / BQ, bh);
  kern<<<grid, NT, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                               (const T*)o, lse, (const T*)dout, (T*)dqp,
                               S, causal, scale);
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
    default: return kUnsupported;                                         \
  }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// 100000 for a head dim / dtype with no instance.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int s, int d, int dtype, int causal,
              float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return kUnsupported;
  DISPATCH(fwd, q, k, v, o, (float*)lse, bh, s, causal, scale,
           (cudaStream_t)stream)
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* o, const void* lse, const void* dout,
                   void* dk, void* dv, int bh, int s, int d, int dtype,
                   int causal, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return kUnsupported;
  DISPATCH(dkdv, q, k, v, o, (const float*)lse, dout, dk, dv, bh, s,
           causal, scale, (cudaStream_t)stream)
}

int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* o, const void* lse, const void* dout,
                 void* dqp, int bh, int s, int d, int dtype, int causal,
                 float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return kUnsupported;
  DISPATCH(dq, q, k, v, o, (const float*)lse, dout, dqp, bh, s, causal,
           scale, (cudaStream_t)stream)
}

}  // extern "C"
