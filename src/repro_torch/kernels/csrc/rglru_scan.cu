// RG-LRU linear recurrence for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan.py (forward only there; the JAX model
// path takes the scan with jax.lax.associative_scan and its gradient by
// autodiff). Here the backward is a kernel of its own.
//
//   rglru_fwd  h_t = a_t * h_{t-1} + x_t along S, h_{-1} = 0. One thread
//              per (b, d) lane carries the state in an f32 register
//              across the whole sequence (the TPU kernel carried it in
//              VMEM scratch across a sequential grid axis); h is
//              written in x's dtype.
//   rglru_bwd  one reverse pass for the upstream gradient g:
//              delta_t = g_t + a_{t+1} * delta_{t+1},
//              dx_t = delta_t, da_t = delta_t * h_{t-1} (h_{-1} = 0);
//              dx in x's dtype, da in a's dtype.
//
// Every lane owns its outputs: no atomics and one fixed order, so
// results repeat bitwise from run to run.
//
// Layout: a, x, h, g, da, dx are contiguous (B, S, D); a and x are f32
// or bf16 each (template parameters TA, TX), arithmetic is f32.
// Neighbouring threads own neighbouring d, so every load and store of a
// warp is one contiguous run of 32 elements. Lanes past B*D are masked
// and S is a loop bound, so no shape needs to divide anything.
//
// What bounds it on an H100: the function moves 3 (forward) or 5
// (backward) B*S*D arrays and does 2 (or 3) FLOPs per element, so its
// bound is bytes (126 MB, 0.038 ms, forward at B 1, S 4096, D 2560,
// f32). This first version has only B*D lanes (2560 at batch 1: about
// 40 blocks of 64 threads on 132 SMs) walking 4096 dependent steps, so
// it is bound by load latency instead: each thread loads U time steps
// ahead into registers before it uses them, to keep U loads of each
// input in flight. A chunked two-pass scan (a parallel prefix over S
// blocks) is the way to the bound and later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;      // threads per block
constexpr int U = 8;        // time steps loaded ahead

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

template <typename TA, typename TX>
__global__ void __launch_bounds__(NT)
rglru_fwd_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                 TX* __restrict__ h, int B, int S, int D) {
  const int64_t lane = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (lane >= (int64_t)B * D) return;
  const int64_t b = lane / D, d = lane % D;
  const int64_t base = b * S * D + d;
  float carry = 0.f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      av[u] = t < S ? to_f(a[base + (int64_t)t * D]) : 0.f;
      xv[u] = t < S ? to_f(x[base + (int64_t)t * D]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        carry = av[u] * carry + xv[u];
        h[base + (int64_t)t * D] = from_f<TX>(carry);
      }
    }
  }
}

template <typename TA, typename TX>
__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const TA* __restrict__ a, const TX* __restrict__ h,
                 const TX* __restrict__ g, TA* __restrict__ da,
                 TX* __restrict__ dx, int B, int S, int D) {
  const int64_t lane = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (lane >= (int64_t)B * D) return;
  const int64_t b = lane / D, d = lane % D;
  const int64_t base = b * S * D + d;
  float delta = 0.f, a_next = 0.f;   // a_{t+1}; 0 past the last step
  for (int t0 = S - 1; t0 >= 0; t0 -= U) {
    float av[U], gv[U], hv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      av[u] = t >= 0 ? to_f(a[base + (int64_t)t * D]) : 0.f;
      gv[u] = t >= 0 ? to_f(g[base + (int64_t)t * D]) : 0.f;
      hv[u] = t >= 1 ? to_f(h[base + (int64_t)(t - 1) * D]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        delta = gv[u] + a_next * delta;
        dx[base + (int64_t)t * D] = from_f<TX>(delta);
        da[base + (int64_t)t * D] = from_f<TA>(delta * hv[u]);
        a_next = av[u];
      }
    }
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

template <typename TA, typename TX>
int fwd(const void* a, const void* x, void* h, int B, int S, int D,
        cudaStream_t st) {
  const int64_t lanes = (int64_t)B * D;
  const int grid = (int)((lanes + NT - 1) / NT);
  rglru_fwd_kernel<TA, TX><<<grid, NT, 0, st>>>(
      (const TA*)a, (const TX*)x, (TX*)h, B, S, D);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX>
int bwd(const void* a, const void* h, const void* g, void* da, void* dx,
        int B, int S, int D, cudaStream_t st) {
  const int64_t lanes = (int64_t)B * D;
  const int grid = (int)((lanes + NT - 1) / NT);
  rglru_bwd_kernel<TA, TX><<<grid, NT, 0, st>>>(
      (const TA*)a, (const TX*)h, (const TX*)g, (TA*)da, (TX*)dx, B, S, D);
  return (int)cudaGetLastError();
}

// a_dtype, x_dtype: 0 = float32, 1 = bfloat16.
#define DISPATCH(FN, ...)                                                 \
  switch (a_dtype * 2 + x_dtype) {                                        \
    case 0: return FN<float, float>(__VA_ARGS__);                         \
    case 1: return FN<float, __nv_bfloat16>(__VA_ARGS__);                 \
    case 2: return FN<__nv_bfloat16, float>(__VA_ARGS__);                 \
    case 3: return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);         \
    default: return kUnsupported;                                         \
  }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// 100000 for a dtype with no instance.
int rglru_fwd(const void* a, const void* x, void* h, int b, int s, int d,
              int a_dtype, int x_dtype, void* stream) {
  if (a_dtype < 0 || a_dtype > 1 || x_dtype < 0 || x_dtype > 1)
    return kUnsupported;
  DISPATCH(fwd, a, x, h, b, s, d, (cudaStream_t)stream)
}

int rglru_bwd(const void* a, const void* h, const void* g, void* da,
              void* dx, int b, int s, int d, int a_dtype, int x_dtype,
              void* stream) {
  if (a_dtype < 0 || a_dtype > 1 || x_dtype < 0 || x_dtype > 1)
    return kUnsupported;
  DISPATCH(bwd, a, h, g, da, dx, b, s, d, (cudaStream_t)stream)
}

}  // extern "C"
