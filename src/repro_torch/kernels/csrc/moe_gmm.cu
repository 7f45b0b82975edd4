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
// Each is C = A . B with C (P x Q) and a reduction of length R, where A
// and B are read either as stored or transposed. The TPU kernel's
// sequential reduction axis, carried in VMEM scratch, becomes a loop
// over R inside the block.
//
// What bounds it on an H100: at the main path's shapes (E 60, M 342, K
// 2048, N 1408, and the down product with K and N swapped) a call is
// 118 GFLOP against under 1 GB of inputs and output, far above the
// card's bytes-to-FLOP line, so the bound is arithmetic.
//
// All three run one tile loop on the tensor cores (gmm_mma_kernel):
//  - A block owns one (expert, MMA_BM x MMA_BN = 128 x 64 tile of C);
//    its 4 warps own 64 x 32 outputs each, and two blocks share an SM,
//    so one block's ring fill and epilogue run under the other's
//    products. The block walks R in tiles of 128 bytes
//    (32 f32 or 64 bf16), copied by cp.async into a ring of MMA_STAGES
//    stages in dynamic shared memory, so the next tiles' copies run
//    under the current tile's products.
//  - Products are warp-level mma.sync: bf16 m16n8k16, and f32 as
//    3xTF32 m16n8k8 (big*small + small*big + big*big, each operand split
//    in registers as it leaves shared memory; mma_sm90.cuh). A k step's
//    4 A and 4 B fragments feed 16 products, so each split serves 4.
//  - The tensor cores truncate the sums in their accumulator, a bias
//    that grows with the number of sums, so each R tile sums into a
//    fresh accumulator that is added to the running one in f32 (as the
//    attention backward does).
//  - Operand tiles are stored either with the reduction contiguous
//    (A of NN and NT, B of NT: read by ldmatrix) or with the rows
//    contiguous (B of NN and TN, A of TN: ldmatrix.trans in bf16, 32-bit
//    loads in f32), rows padded so that neither read has bank conflicts.
//    Only that read differs between the products: the three are
//    instances of one loop.
//  - Ragged P, Q and R: rows and reduction elements out of range arrive
//    as zeros (cp.async's source size 0) and outputs out of range are
//    not written. The 16-byte copies need every operand row to be a
//    multiple of 16 bytes and 16-byte aligned bases; any other shape
//    runs the narrow instance (WIDE false: 4-byte cp.async for f32,
//    plain loads for bf16, which cp.async cannot copy alone).
//  - On an H100 the f32 instances run at about 50 TFLOP/s, 30 % of the
//    3xTF32 bound; ring depths and one accumulator did no better, and
//    the 128 x 64 tile at two blocks an SM beat 128 x 128 at one
//    (PERF.md). gmm_bwd_dw's reduction is the token axis, M = 342 on
//    the main path: 11 R tiles a block, where gmm_fwd's blocks walk 64,
//    so the ring's fill and the epilogue weigh more there.
//
// Determinism: no split of R across blocks and no atomics, so every
// output element is summed in one fixed order (gmm_bwd_dw reduces over
// the token axis that way too) and results repeat bitwise.
//
// Types: f32 or bf16 inputs, summed in f32; the output is written in
// the input dtype. The main path's token count B*C = 2*171 = 342 is a
// multiple of no power-of-two tile, so the Pallas kernel's "blocks
// divide C, F, D" assertion is relaxed here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ------------------------------------------------ tensor-core tile loop

constexpr int MMA_BM = 128;          // rows of C per block
constexpr int MMA_BN = 64;           // columns of C per block
constexpr int MMA_WM = 2;            // warps along the rows
constexpr int MMA_WN = 2;            // warps along the columns
constexpr int MMA_NT = MMA_WM * MMA_WN * 32;
constexpr int MMA_STAGES = 3;        // depth of the cp.async ring
constexpr int TILE_BYTES = 128;      // of each row of R a stage holds
constexpr int KSTEPS = TILE_BYTES / 32;   // mma k steps of 32 bytes

// One stage of an operand in shared memory: ROWS rows (of A or B's
// columns) by one R tile of BK elements. KMAJOR: stored as ROWS lines of
// BK (the reduction contiguous), each 144 bytes, so the eight 16-byte
// rows an ldmatrix phase reads fall in distinct banks. Else BK lines of
// ROWS + 8 elements: in bf16 an odd number of 16 bytes (ldmatrix.trans),
// in f32 8 words past a multiple of 32, so the 32-bit fragment loads
// (lines t, columns g) hit 32 distinct banks.
template <typename T, bool KMAJOR, int ROWS> struct OpTile {
  static_assert(ROWS % 32 == 0, "tile rows");
  static constexpr int BK = TILE_BYTES / (int)sizeof(T);
  static constexpr int LINES = KMAJOR ? ROWS : BK;
  static constexpr int LEN = KMAJOR ? BK : ROWS;
  static constexpr int LD = LEN + (KMAJOR ? 16 / (int)sizeof(T) : 8);
  static constexpr int ELEMS = LINES * LD;
};

// The R tile [k0, k0 + BK) of rows [row0, row0 + ROWS) of an expert's
// operand g, which has `rows` rows and reduction length R and is stored
// (rows x R) if KMAJOR, else (R x rows), into the stage at s. Elements
// out of range arrive as zeros. WIDE: 16-byte cp.async (every stored row
// a multiple of 16 bytes, g 16-byte aligned); else one element at a
// time: 4-byte cp.async for f32, a plain load for bf16.
template <typename T, bool KMAJOR, int ROWS, bool WIDE>
__device__ __forceinline__ void load_tile(T* s, const T* g, int row0, int k0,
                                          int rows, int R) {
  using Tl = OpTile<T, KMAJOR, ROWS>;
  const int line0 = KMAJOR ? row0 : k0, lines = KMAJOR ? rows : R;
  const int x0 = KMAJOR ? k0 : row0, len = KMAJOR ? R : rows;
  if constexpr (WIDE) {
    constexpr int CH = 16 / (int)sizeof(T), CPL = Tl::LEN / CH;
    constexpr int N = Tl::LINES * CPL;
#pragma unroll
    for (int i = 0; i < (N + MMA_NT - 1) / MMA_NT; ++i) {
      const int c = threadIdx.x + i * MMA_NT;
      if (N % MMA_NT && c >= N) break;
      const int l = c / CPL, x = c % CPL * CH;
      const bool in = line0 + l < lines && x0 + x < len;
      cp_async16(s + l * Tl::LD + x,
                 g + (in ? (size_t)(line0 + l) * len + x0 + x : 0), in);
    }
  } else {
    for (int c = threadIdx.x; c < Tl::LINES * Tl::LEN; c += MMA_NT) {
      const int l = c / Tl::LEN, x = c % Tl::LEN;
      const bool in = line0 + l < lines && x0 + x < len;
      const T* src = g + (in ? (size_t)(line0 + l) * len + x0 + x : 0);
      if constexpr (std::is_same<T, float>::value)
        cp_async4(s + l * Tl::LD + x, src, in);
      else
        s[l * Tl::LD + x] = in ? *src : __float2bfloat16(0.f);
    }
  }
}

// The 32-bit fragment words of 16 rows at row0 of a stage, k step kk, in
// the B operand's layout: r[0] and r[1] hold the two k halves (k t and
// t + 4 in TF32; pairs 2t and 2t + 8 in bf16) of row row0 + g, r[2] and
// r[3] those of row row0 + 8 + g, with g = lane / 4, t = lane % 4.
template <typename T, bool KMAJOR, int ROWS>
__device__ __forceinline__ void frag16(uint32_t (&r)[4], const T* s,
                                       int row0, int kk, int lane) {
  constexpr int LD = OpTile<T, KMAJOR, ROWS>::LD;
  if constexpr (KMAJOR) {
    ldsm_x4(r, smem_u32(s + (row0 + (lane & 7) + ((lane >> 4) << 3)) * LD) +
                   kk * 32 + ((lane >> 3) & 1) * 16);
  } else if constexpr (std::is_same<T, float>::value) {
    const float* p = s + (kk * 8 + (lane & 3)) * LD + row0 + (lane >> 2);
    r[0] = __float_as_uint(p[0]);
    r[1] = __float_as_uint(p[4 * LD]);
    r[2] = __float_as_uint(p[8]);
    r[3] = __float_as_uint(p[4 * LD + 8]);
  } else {
    ldsm_x4_t(r, smem_u32(s + (kk * 16 + (lane & 7) +
                               (((lane >> 3) & 1) << 3)) * LD +
                          row0 + ((lane >> 4) << 3)));
  }
}

// sum[i][j] += A B over one stage for one warp: MI m16 tiles of A from
// row a0 of As, NI n8 tiles of B from column b0 of Bs. Each k step
// splits (TF32) its A and B fragments once and uses each in NI or MI
// products.
template <typename T, bool TA, bool TB, int MI, int NI>
__device__ __forceinline__ void mma_stage(float (&sum)[MI][NI][4],
                                          const T* As, const T* Bs, int a0,
                                          int b0, int lane) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    FragB<T> fb[NI];
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      uint32_t r[4];
      frag16<T, TB, MMA_BN>(r, Bs, b0 + 16 * j, kk, lane);
      fb[2 * j] = frag_b_raw<T>(r[0], r[1]);
      fb[2 * j + 1] = frag_b_raw<T>(r[2], r[3]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint32_t r[4];
      frag16<T, !TA, MMA_BM>(r, As, a0 + 16 * i, kk, lane);
      const uint32_t ra[4] = {r[0], r[2], r[1], r[3]};
      const FragA<T> fa = frag_a_raw<T>(ra);
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_op(sum[i][j], fa, fb[j]);
    }
  }
}

template <typename T, bool TA, bool TB>
constexpr size_t mma_smem() {
  return (size_t)MMA_STAGES *
         (OpTile<T, !TA, MMA_BM>::ELEMS + OpTile<T, TB, MMA_BN>::ELEMS) *
         sizeof(T);
}

// C[e] (P x Q) = A[e] . B[e] with reduction length R on the tensor cores,
// where
//   A(p, r) = TA ? a[r * P + p] : a[p * R + r]
//   B(r, q) = TB ? b[q * R + r] : b[r * Q + q].
// Grid: (ceil(Q / MMA_BN), ceil(P / MMA_BM), E), MMA_NT threads,
// mma_smem<T, TA, TB>() bytes of dynamic shared memory. Accumulator
// layout of m16n8: sum[i][j][e] is row 16 i + g + 8 (e / 2), column
// 8 j + 2 t + e % 2 of the warp's tile.
template <typename T, bool TA, bool TB, bool WIDE>
__global__ void __launch_bounds__(MMA_NT, 2)
gmm_mma_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ c, int P, int Q, int R) {
  using TlA = OpTile<T, !TA, MMA_BM>;
  using TlB = OpTile<T, TB, MMA_BN>;
  constexpr int WTM = MMA_BM / MMA_WM, WTN = MMA_BN / MMA_WN;
  constexpr int MI = WTM / 16, NI = WTN / 8, BK = TlA::BK;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);        // stage s at s * TlA::ELEMS
  T* Bs = As + MMA_STAGES * TlA::ELEMS;      // stage s at s * TlB::ELEMS
  const int e = blockIdx.z;
  const int p0 = blockIdx.y * MMA_BM, q0 = blockIdx.x * MMA_BN;
  a += (size_t)e * P * R;
  b += (size_t)e * R * Q;
  c += (size_t)e * P * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a0 = warp % MMA_WM * WTM, b0 = warp / MMA_WM * WTN;
  const int nk = (R + BK - 1) / BK;
  auto load = [&](int stage, int kt) {
    load_tile<T, !TA, MMA_BM, WIDE>(As + stage * TlA::ELEMS, a, p0,
                                    kt * BK, P, R);
    load_tile<T, TB, MMA_BN, WIDE>(Bs + stage * TlB::ELEMS, b, q0, kt * BK,
                                   Q, R);
  };
#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  float acc[MI][NI][4] = {};
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<MMA_STAGES - 2>();
    __syncthreads();        // tile kt has landed; tile kt - 1 is read
    if (kt + MMA_STAGES - 1 < nk)
      load((kt + MMA_STAGES - 1) % MMA_STAGES, kt + MMA_STAGES - 1);
    cp_commit();
    const int st = kt % MMA_STAGES;
    const T* as = As + st * TlA::ELEMS;
    const T* bs = Bs + st * TlB::ELEMS;
    float part[MI][NI][4] = {};
    mma_stage<T, TA, TB, MI, NI>(part, as, bs, a0, b0, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][j][x] += part[i][j][x];
  }
  cp_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (Q & 1) == 0;     // two outputs a store, 8-byte aligned
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + a0 + 16 * i + g + 8 * h;
      if (p >= P) continue;
      T* row = c + (size_t)p * Q;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int q = q0 + b0 + 8 * j + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && q < Q) {
          store2<T>(row + q, v0, v1);
        } else {
          if (q < Q) row[q] = from_f<T>(v0);
          if (q + 1 < Q) row[q + 1] = from_f<T>(v1);
        }
      }
    }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

template <typename T, bool TA, bool TB, bool WIDE>
int gmm_mma_launch(const void* a, const void* b, void* c, int E, int P,
                   int Q, int R, cudaStream_t st) {
  constexpr size_t smem = mma_smem<T, TA, TB>();
  auto kern = gmm_mma_kernel<T, TA, TB, WIDE>;
  if (int rc = (int)cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return rc;
  dim3 grid((Q + MMA_BN - 1) / MMA_BN, (P + MMA_BM - 1) / MMA_BM, E);
  kern<<<grid, MMA_NT, smem, st>>>((const T*)a, (const T*)b, (T*)c, P, Q,
                                   R);
  return (int)cudaGetLastError();
}

// The wide instance where every stored row of A and B is a multiple of
// 16 bytes and both bases are 16-byte aligned, else the narrow one.
template <typename T, bool TA, bool TB>
int gmm_mma(const void* a, const void* b, void* c, int E, int P, int Q,
            int R, cudaStream_t st) {
  const size_t es = sizeof(T);
  const bool wide = (size_t)(TA ? P : R) * es % 16 == 0 &&
                    (size_t)(TB ? R : Q) * es % 16 == 0 &&
                    (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  return wide ? gmm_mma_launch<T, TA, TB, true>(a, b, c, E, P, Q, R, st)
              : gmm_mma_launch<T, TA, TB, false>(a, b, c, E, P, Q, R, st);
}

// dtype: 0 = float32, 1 = bfloat16.
template <bool TA, bool TB>
int dispatch(const void* a, const void* b, void* c, int E, int P, int Q,
             int R, int dtype, void* stream) {
  if (E <= 0 || P <= 0 || Q <= 0 || R < 0 || E > 65535)
    return kUnsupported;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return gmm_mma<float, TA, TB>(a, b, c, E, P, Q, R, st);
  if (dtype == 1)
    return gmm_mma<__nv_bfloat16, TA, TB>(a, b, c, E, P, Q, R, st);
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
