// Grouped (per-expert) matrix product for Hopper (sm_90a): forward and
// the two gradients of the MoE expert FFN.
//
// Replaces the Pallas TPU kernel `_gmm_kernel` / `grouped_matmul` in
// src/repro/kernels/moe_gmm.py (forward only there; the JAX package
// takes the gradient by autodiff through the einsums of
// models/moe.py). Here the gradients are kernels of their own, so the
// expert products never leave the hand-written path:
//
//   gmm_fwd     y[e]  = x[e]  @ w[e]     (E,M,K) x (E,K,N) -> (E,M,N)  NN
//   gmm_bwd_dx  dx[e] = dy[e] @ w[e]^T   (E,M,N) x (E,K,N) -> (E,M,K)  NT
//   gmm_bwd_dw  dw[e] = x[e]^T @ dy[e]   (E,M,K) x (E,M,N) -> (E,K,N)  TN
//
// All three are one templated tile loop, C = A . B with C (P x Q) and a
// reduction of length R, where A and B are read either as stored or
// transposed. One block owns one (expert, 64 x 64 tile of C) and loops
// over R in shared-memory tiles of 16, accumulating in f32 registers
// with FMAs (each of 256 threads a 4 x 4 register tile). The TPU
// kernel's sequential reduction axis, carried in VMEM scratch, becomes
// this loop inside the block.
//
// Determinism: no split of R across blocks and no atomics, so every
// output element is summed in one fixed order (gmm_bwd_dw reduces over
// the token axis that way too) and results repeat bitwise.
//
// Types: f32 or bf16 inputs, loaded as f32; the output is written in
// the input dtype. Ragged edges of P, Q and R are masked (out-of-range
// elements load as zero and are not written): the main path's token
// count B*C = 2*171 = 342 is a multiple of no power-of-two tile, so the
// Pallas kernel's "blocks divide C, F, D" assertion is relaxed here.
//
// What bounds it on an H100: at the main path's shape (E 60, M 342,
// K 2048, N 1408) a call is 118 GFLOP against under 1 GB of inputs and
// output, far above the card's bytes-to-FLOP line, so the bound is
// arithmetic. This first version runs on the CUDA cores in f32 (no TF32,
// no tensor cores), so its ceiling is the f32 FMA rate; wgmma on bf16
// tiles is the step after it. The next tile of A and B is fetched into
// registers while the current one is multiplied, to hide load latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;          // rows of C per block
constexpr int TQ = 64;          // columns of C per block
constexpr int TR = 16;          // reduction depth per shared tile
constexpr int NT = 256;         // threads: 16 x 16, each a 4 x 4 tile
constexpr int LDS = TP + 4;     // padded row of a shared tile (16 B rows)
constexpr int PER = TP * TR / NT;   // elements of each tile per thread

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

// Element (row, r) of a 64-row operand tile, for the tile's flat index
// `idx`. Stored (rows x R) with r contiguous (TRANS false): consecutive
// threads take consecutive r. Stored (R x rows), rows contiguous (TRANS
// true): consecutive threads take consecutive rows. Both keep global
// reads coalesced.
template <bool TRANS>
__device__ __forceinline__ void tile_coord(int idx, int& row, int& r) {
  if (TRANS) {
    r = idx / TP;
    row = idx % TP;
  } else {
    row = idx / TR;
    r = idx % TR;
  }
}

// Load this thread's PER elements of the operand tile at (row0, r0) into
// registers as f32; elements outside (rows, R) read as zero. `g` points
// at the expert's matrix: (rows x R) if !TRANS, else (R x rows).
template <typename T, bool TRANS>
__device__ __forceinline__ void fetch(float* reg, const T* __restrict__ g,
                                      int row0, int r0, int rows, int R) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int row, r;
    tile_coord<TRANS>(threadIdx.x + i * NT, row, r);
    row += row0;
    r += r0;
    const bool in = row < rows && r < R;
    const size_t off = TRANS ? (size_t)r * rows + row : (size_t)row * R + r;
    reg[i] = in ? to_f(g[off]) : 0.f;
  }
}

// Registers -> shared tile s[r * LDS + row].
template <bool TRANS>
__device__ __forceinline__ void stash(float* s, const float* reg) {
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    int row, r;
    tile_coord<TRANS>(threadIdx.x + i * NT, row, r);
    s[r * LDS + row] = reg[i];
  }
}

// C[e] (P x Q) = A[e] . B[e] with reduction length R, where
//   A(p, r) = TA ? a[r * P + p] : a[p * R + r]
//   B(r, q) = TB ? b[q * R + r] : b[r * Q + q].
// Grid: (ceil(Q / 64), ceil(P / 64), E).
template <typename T, bool TA, bool TB>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ a, const T* __restrict__ b,
           T* __restrict__ c, int P, int Q, int R) {
  __shared__ __align__(16) float As[TR * LDS];   // As[r * LDS + p]
  __shared__ __align__(16) float Bs[TR * LDS];   // Bs[r * LDS + q]
  const int e = blockIdx.z;
  const int p0 = blockIdx.y * TP, q0 = blockIdx.x * TQ;
  a += (size_t)e * P * R;
  b += (size_t)e * R * Q;
  c += (size_t)e * P * Q;
  // B is read as a Q-row operand: B(r, q) = Bt(q, r), Bt stored (Q x R)
  // when TB and (R x Q) otherwise.
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  float ra[PER], rb[PER];
  fetch<T, TA>(ra, a, p0, 0, P, R);
  fetch<T, !TB>(rb, b, q0, 0, Q, R);
  for (int r0 = 0; r0 < R; r0 += TR) {
    __syncthreads();                 // the last tile's readers are done
    stash<TA>(As, ra);
    stash<!TB>(Bs, rb);
    __syncthreads();
    if (r0 + TR < R) {               // next tile in flight during FMAs
      fetch<T, TA>(ra, a, p0, r0 + TR, P, R);
      fetch<T, !TB>(rb, b, q0, r0 + TR, Q, R);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(
          &As[r * LDS + ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(
          &Bs[r * LDS + tx * 4]);
      const float ai[4] = {av.x, av.y, av.z, av.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ai[i], bj[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + tx * 4 + j;
      if (q < Q) c[(size_t)p * Q + q] = from_f<T>(acc[i][j]);
    }
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

template <typename T, bool TA, bool TB>
int gmm(const void* a, const void* b, void* c, int E, int P, int Q, int R,
        cudaStream_t st) {
  dim3 grid((Q + TQ - 1) / TQ, (P + TP - 1) / TP, E);
  gmm_kernel<T, TA, TB><<<grid, NT, 0, st>>>((const T*)a, (const T*)b,
                                             (T*)c, P, Q, R);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
template <bool TA, bool TB>
int dispatch(const void* a, const void* b, void* c, int E, int P, int Q,
             int R, int dtype, void* stream) {
  if (E <= 0 || P <= 0 || Q <= 0 || R < 0 || E > 65535)
    return kUnsupported;
  if (dtype == 0)
    return gmm<float, TA, TB>(a, b, c, E, P, Q, R, (cudaStream_t)stream);
  if (dtype == 1)
    return gmm<__nv_bfloat16, TA, TB>(a, b, c, E, P, Q, R,
                                      (cudaStream_t)stream);
  return kUnsupported;
}

}  // namespace

extern "C" {

// Shapes: x (E, M, K), w (E, K, N), y / dy (E, M, N); all contiguous and
// of one dtype. Each returns cudaGetLastError() after the launch
// (0 = launched), or 100000 for a dtype or shape with no launch.
int gmm_fwd(const void* x, const void* w, void* y, int e, int m, int k,
            int n, int dtype, void* stream) {
  return dispatch<false, false>(x, w, y, e, m, n, k, dtype, stream);
}

int gmm_bwd_dx(const void* dy, const void* w, void* dx, int e, int m,
               int k, int n, int dtype, void* stream) {
  return dispatch<false, true>(dy, w, dx, e, m, k, n, dtype, stream);
}

int gmm_bwd_dw(const void* x, const void* dy, void* dw, int e, int m,
               int k, int n, int dtype, void* stream) {
  return dispatch<true, false>(x, dy, dw, e, k, n, m, dtype, stream);
}

}  // extern "C"
