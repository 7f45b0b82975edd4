// RG-LRU linear recurrence for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan.py (forward only there; the JAX model
// path takes the scan with jax.lax.associative_scan and its gradient by
// autodiff). Here the backward is a kernel of its own.
//
//   rglru_fwd  h_t = a_t * h_{t-1} + x_t along S, h_{-1} = 0, with an f32
//              carry; h is written in x's dtype.
//   rglru_bwd  for the upstream gradient g:
//              delta_t = g_t + a_{t+1} * delta_{t+1} (a_S = 0),
//              dx_t = delta_t, da_t = delta_t * h_{t-1} (h_{-1} = 0);
//              dx in x's dtype, da in a's dtype.
//
// The TPU kernel carried the state in VMEM scratch across a sequential
// grid axis of S blocks. Blocks on the card run in no order, so each
// export is a chunked scan in three launches over chunks of L steps
// (L from the wrapper, per shape; the last chunk of a row may be
// shorter):
//   reduce  a thread per (b, chunk, lanes) walks its chunk from a zero
//           carry and writes the chunk's aggregate to an f32 workspace
//           ws (2, B, nc, D): the product of its decays and its end
//           value;
//   carry   a block per (b, 32 lanes) walks the chunks in order (the
//           backward: from the last) and overwrites each chunk's end
//           value with the carry it starts from;
//   out     as reduce, walks its chunk again from that carry and writes
//           the outputs.
// The backward's chunk c covers t in [c L, c L + L) and walks it from
// its end: its aggregate is the product of a_{t+1} over the chunk and
// its delta at the first row from delta_{cL+L} = 0; its carry is the
// next chunk's first delta. a_{t+1} at a chunk's last row is the next
// chunk's first a, and h_{t-1} at its first row the previous chunk's
// last h; neither crosses a batch row (a_S = 0, h_{-1} = 0).
//
// Every thread owns its outputs and combines in one fixed order: no
// atomics, and results repeat bitwise from run to run.
//
// Layout: a, x, h, g, da, dx are contiguous (B, S, D); a and x are f32
// or bf16 each (template parameters TA, TX), arithmetic is f32. A
// thread of the reduce and out passes takes V neighbouring lanes d (V =
// VEC, one 16- or 8-byte load a step, where D is a multiple of VEC and
// every pointer is aligned to it; else V = 1), and neighbouring threads
// take neighbouring lanes, so every load and store of a warp is one
// contiguous run. Lanes past D are masked and S is a loop bound, so no
// shape needs to divide anything.
//
// What bounds it on an H100: the function moves 3 (forward) or 5
// (backward) B*S*D arrays and does 2 (or 3) FLOPs per element, so its
// bound is bytes (126 MB, 0.038 ms, forward at B 1, S 4096, D 2560,
// f32). The passes read the inputs twice (a and x, or a and g, are 84 MB
// at that shape: more than the 50 MB L2), so they move 20 (28) bytes an
// element where the bound counts 12 (20). The first version had a thread
// per (b, d) lane walking all of S: 2560 threads at batch 1, bound by
// load latency. Chunks make S parallel (B*D*S/L (chunk, lane) pairs,
// 327,680 at that shape), and each thread loads U steps ahead into
// registers, so many loads are in flight on every SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int NT = 128;     // threads per block of the reduce and out passes
constexpr int U = 8;        // time steps loaded ahead
constexpr int VEC = 4;      // lanes a thread takes where D and alignment allow
constexpr int CW = 32;      // lanes of a carry block
constexpr int CS = 8;       // runs of chunks a carry block splits nc into
constexpr int CU = 16;      // chunks loaded ahead by the carry pass

// V consecutive elements (V-aligned) to and from f32: one load or store.
template <int V, typename T>
__device__ __forceinline__ void load_f(const T* p, float (&v)[V]);
template <>
__device__ __forceinline__ void load_f<1, float>(const float* p,
                                                 float (&v)[1]) {
  v[0] = *p;
}
template <>
__device__ __forceinline__ void load_f<1, __nv_bfloat16>(
    const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_f<4, float>(const float* p,
                                                 float (&v)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
template <>
__device__ __forceinline__ void load_f<4, __nv_bfloat16>(
    const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
template <int V, typename T>
__device__ __forceinline__ void store_f(T* p, const float (&v)[V]);
template <>
__device__ __forceinline__ void store_f<1, float>(float* p,
                                                  const float (&v)[1]) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store_f<1, __nv_bfloat16>(
    __nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
template <>
__device__ __forceinline__ void store_f<4, float>(float* p,
                                                  const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_f<4, __nv_bfloat16>(
    __nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<const uint32_t*>(&lo);
  w.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}
template <int V>
__device__ __forceinline__ void fill(float (&v)[V], float f) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = f;
}
// load_f where `in`, else every element f.
template <int V, typename T>
__device__ __forceinline__ void load_or(bool in, const T* p, float (&v)[V],
                                        float f) {
  if (in) load_f<V>(p, v);
  else fill(v, f);
}

// The (b, chunk, lanes d .. d + V - 1) of this thread: grid
// (ceil(D / (NT V)), nc, B).
struct Lane {
  int d, c, b, t0, t1;
  int64_t row0;   // element (b, 0, d) of a (B, S, D) array
  int64_t w;      // element (b, c, d) of a (B, nc, D) workspace half
};

template <int V>
__device__ __forceinline__ bool lane_of(Lane& l, int S, int D, int L,
                                        int nc) {
  l.d = (blockIdx.x * NT + threadIdx.x) * V;
  l.c = blockIdx.y;
  l.b = blockIdx.z;
  l.t0 = l.c * L;
  l.t1 = min(l.t0 + L, S);
  l.row0 = (int64_t)l.b * S * D + l.d;
  l.w = ((int64_t)l.b * nc + l.c) * D + l.d;
  return l.d < D;
}

template <typename TA, typename TX, int V>
__global__ void __launch_bounds__(NT)
rglru_fwd_reduce_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                        float* __restrict__ ws, int S, int D, int L,
                        int nc, int64_t half) {
  Lane l;
  if (!lane_of<V>(l, S, D, L, nc)) return;
  float A[V], X[V];
  fill(A, 1.f);
  fill(X, 0.f);
  for (int t = l.t0; t < l.t1; t += U) {
    float av[U][V], xv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = l.row0 + (int64_t)(t + u) * D;
      load_or(t + u < l.t1, a + i, av[u], 1.f);
      load_or(t + u < l.t1, x + i, xv[u], 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        X[k] = fmaf(av[u][k], X[k], xv[u][k]);
        A[k] *= av[u][k];
      }
    }
  }
  store_f<V>(ws + l.w, A);
  store_f<V>(ws + half + l.w, X);
}

// Block per (CW lanes, b), grid (ceil(D / CW), B), CW x CS threads.
// The chunks, in walk order (from the last with `reverse`), are split
// into CS runs; thread (x, y) owns lane x of run y. Each run's
// composite (product and end value from a zero carry) goes through
// shared memory, each thread folds the runs before its own into its
// carry, then walks its run again writing the running carry over each
// chunk's end value: carry = product * carry + end value. CU chunks'
// loads are in flight at a time.
__global__ void __launch_bounds__(CW * CS)
rglru_carry_kernel(float* ws, int D, int nc, int64_t half, int reverse) {
  __shared__ float sp[CS][CW], se[CS][CW];
  const int x = threadIdx.x, y = threadIdx.y;
  const int d = blockIdx.x * CW + x;
  const bool live = d < D;
  const int64_t base = (int64_t)blockIdx.y * nc * D + d;
  const int run = (nc + CS - 1) / CS;
  const int i0 = min(y * run, nc), i1 = min(i0 + run, nc);
  auto at = [&](int i) {
    return base + (int64_t)(reverse ? nc - 1 - i : i) * D;
  };
  float P = 1.f, E = 0.f;
  for (int i = i0; i < i1; i += CU) {
    float pv[CU], ev[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const bool in = live && i + u < i1;
      pv[u] = in ? ws[at(i + u)] : 1.f;
      ev[u] = in ? ws[half + at(i + u)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      E = fmaf(pv[u], E, ev[u]);
      P *= pv[u];
    }
  }
  sp[y][x] = P;
  se[y][x] = E;
  __syncthreads();
  float carry = 0.f;
  for (int r = 0; r < y; ++r) carry = fmaf(sp[r][x], carry, se[r][x]);
  if (!live) return;
  for (int i = i0; i < i1; i += CU) {
    float pv[CU], ev[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      pv[u] = i + u < i1 ? ws[at(i + u)] : 0.f;
      ev[u] = i + u < i1 ? ws[half + at(i + u)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (i + u < i1) {
        ws[half + at(i + u)] = carry;
        carry = fmaf(pv[u], carry, ev[u]);
      }
    }
  }
}

template <typename TA, typename TX, int V>
__global__ void __launch_bounds__(NT)
rglru_fwd_out_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                     const float* __restrict__ ws, TX* __restrict__ h,
                     int S, int D, int L, int nc, int64_t half) {
  Lane l;
  if (!lane_of<V>(l, S, D, L, nc)) return;
  float carry[V];
  load_f<V>(ws + half + l.w, carry);
  for (int t = l.t0; t < l.t1; t += U) {
    float av[U][V], xv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = l.row0 + (int64_t)(t + u) * D;
      load_or(t + u < l.t1, a + i, av[u], 0.f);
      load_or(t + u < l.t1, x + i, xv[u], 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t + u < l.t1) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          carry[k] = fmaf(av[u][k], carry[k], xv[u][k]);
        store_f<V>(h + l.row0 + (int64_t)(t + u) * D, carry);
      }
    }
  }
}

template <typename TA, typename TX, int V>
__global__ void __launch_bounds__(NT)
rglru_bwd_reduce_kernel(const TA* __restrict__ a, const TX* __restrict__ g,
                        float* __restrict__ ws, int S, int D, int L,
                        int nc, int64_t half) {
  Lane l;
  if (!lane_of<V>(l, S, D, L, nc)) return;
  float P[V], G[V];
  fill(P, 1.f);
  fill(G, 0.f);
  for (int t = l.t1 - 1; t >= l.t0; t -= U) {
    float an[U][V], gv[U][V];       // a_{t+1} (0 at S), g_t
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tu = t - u;
      const int64_t i = l.row0 + (int64_t)tu * D;
      load_or(tu >= l.t0 && tu + 1 < S, a + i + D, an[u], 0.f);
      load_or(tu >= l.t0, g + i, gv[u], 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t - u >= l.t0) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          G[k] = fmaf(an[u][k], G[k], gv[u][k]);
          P[k] *= an[u][k];
        }
      }
    }
  }
  store_f<V>(ws + l.w, P);
  store_f<V>(ws + half + l.w, G);
}

template <typename TA, typename TX, int V>
__global__ void __launch_bounds__(NT)
rglru_bwd_out_kernel(const TA* __restrict__ a, const TX* __restrict__ h,
                     const TX* __restrict__ g, const float* __restrict__ ws,
                     TA* __restrict__ da, TX* __restrict__ dx, int S, int D,
                     int L, int nc, int64_t half) {
  Lane l;
  if (!lane_of<V>(l, S, D, L, nc)) return;
  float delta[V];     // delta at the next chunk's first row
  load_f<V>(ws + half + l.w, delta);
  for (int t = l.t1 - 1; t >= l.t0; t -= U) {
    float an[U][V], gv[U][V], hv[U][V];     // a_{t+1}, g_t, h_{t-1}
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tu = t - u;
      const int64_t i = l.row0 + (int64_t)tu * D;
      load_or(tu >= l.t0 && tu + 1 < S, a + i + D, an[u], 0.f);
      load_or(tu >= l.t0, g + i, gv[u], 0.f);
      load_or(tu >= l.t0 && tu >= 1, h + i - D, hv[u], 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int tu = t - u;
      if (tu >= l.t0) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          delta[k] = fmaf(an[u][k], delta[k], gv[u][k]);
          hv[u][k] *= delta[k];             // da_t = delta_t h_{t-1}
        }
        const int64_t i = l.row0 + (int64_t)tu * D;
        store_f<V>(dx + i, delta);
        store_f<V>(da + i, hv[u]);
      }
    }
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

// The three launches' geometry; false for a shape the grid cannot take.
struct Plan {
  dim3 carry;
  int nc;
  int64_t half;
};

bool plan(Plan& p, int B, int S, int D, int L) {
  if (B < 1 || S < 1 || D < 1 || L < 1 || B > 65535) return false;
  p.nc = (S + L - 1) / L;
  if (p.nc > 65535) return false;
  p.carry = dim3((D + CW - 1) / CW, B);
  p.half = (int64_t)B * p.nc * D;
  return true;
}

// Whether a thread can take VEC lanes: D a multiple of VEC and every
// pointer aligned to VEC elements of its type.
template <typename TA, typename TX>
bool vec_ok(int D, std::initializer_list<const void*> as,
            std::initializer_list<const void*> xs, const void* ws) {
  auto aligned = [](size_t bytes, std::initializer_list<const void*> ps) {
    for (const void* p : ps)
      if ((uintptr_t)p % bytes) return false;
    return true;
  };
  return D % VEC == 0 && aligned(VEC * sizeof(TA), as) &&
         aligned(VEC * sizeof(TX), xs) && aligned(VEC * sizeof(float), {ws});
}

dim3 grid(const Plan& p, int B, int D, int V) {
  return dim3((D / V + NT - 1) / NT, p.nc, B);
}

template <typename TA, typename TX, int V>
int fwd_passes(const Plan& p, const void* a, const void* x, void* h,
               void* ws, int B, int S, int D, int L, cudaStream_t st) {
  rglru_fwd_reduce_kernel<TA, TX, V><<<grid(p, B, D, V), NT, 0, st>>>(
      (const TA*)a, (const TX*)x, (float*)ws, S, D, L, p.nc, p.half);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  rglru_carry_kernel<<<p.carry, dim3(CW, CS), 0, st>>>(
      (float*)ws, D, p.nc, p.half, 0);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  rglru_fwd_out_kernel<TA, TX, V><<<grid(p, B, D, V), NT, 0, st>>>(
      (const TA*)a, (const TX*)x, (const float*)ws, (TX*)h, S, D, L, p.nc,
      p.half);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX, int V>
int bwd_passes(const Plan& p, const void* a, const void* h, const void* g,
               void* da, void* dx, void* ws, int B, int S, int D, int L,
               cudaStream_t st) {
  rglru_bwd_reduce_kernel<TA, TX, V><<<grid(p, B, D, V), NT, 0, st>>>(
      (const TA*)a, (const TX*)g, (float*)ws, S, D, L, p.nc, p.half);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  rglru_carry_kernel<<<p.carry, dim3(CW, CS), 0, st>>>(
      (float*)ws, D, p.nc, p.half, 1);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  rglru_bwd_out_kernel<TA, TX, V><<<grid(p, B, D, V), NT, 0, st>>>(
      (const TA*)a, (const TX*)h, (const TX*)g, (const float*)ws, (TA*)da,
      (TX*)dx, S, D, L, p.nc, p.half);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX>
int fwd(const void* a, const void* x, void* h, void* ws, int B, int S,
        int D, int L, cudaStream_t st) {
  Plan p;
  if (!plan(p, B, S, D, L)) return kUnsupported;
  return vec_ok<TA, TX>(D, {a}, {x, h}, ws)
      ? fwd_passes<TA, TX, VEC>(p, a, x, h, ws, B, S, D, L, st)
      : fwd_passes<TA, TX, 1>(p, a, x, h, ws, B, S, D, L, st);
}

template <typename TA, typename TX>
int bwd(const void* a, const void* h, const void* g, void* da, void* dx,
        void* ws, int B, int S, int D, int L, cudaStream_t st) {
  Plan p;
  if (!plan(p, B, S, D, L)) return kUnsupported;
  return vec_ok<TA, TX>(D, {a, da}, {h, g, dx}, ws)
      ? bwd_passes<TA, TX, VEC>(p, a, h, g, da, dx, ws, B, S, D, L, st)
      : bwd_passes<TA, TX, 1>(p, a, h, g, da, dx, ws, B, S, D, L, st);
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

// Each launches its three passes and returns the first nonzero
// cudaGetLastError() (0 = all launched), or 100000 for a dtype with no
// instance or a shape the grid cannot take. ws: (2, B, ceil(S / chunk),
// D) f32, written before it is read.
int rglru_fwd(const void* a, const void* x, void* h, void* ws, int b, int s,
              int d, int chunk, int a_dtype, int x_dtype, void* stream) {
  if (a_dtype < 0 || a_dtype > 1 || x_dtype < 0 || x_dtype > 1)
    return kUnsupported;
  DISPATCH(fwd, a, x, h, ws, b, s, d, chunk, (cudaStream_t)stream)
}

int rglru_bwd(const void* a, const void* h, const void* g, void* da,
              void* dx, void* ws, int b, int s, int d, int chunk,
              int a_dtype, int x_dtype, void* stream) {
  if (a_dtype < 0 || a_dtype > 1 || x_dtype < 0 || x_dtype > 1)
    return kUnsupported;
  DISPATCH(bwd, a, h, g, da, dx, ws, b, s, d, chunk, (cudaStream_t)stream)
}

}  // extern "C"
