// Causal/non-causal, optionally windowed attention for Hopper (sm_90a):
// forward and backward.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py (forward only there; the JAX
// package takes the gradient by autodiff through dense_attention). Here
// the backward is two kernels of its own, so training never leaves the
// hand-written path.
//
//   flash_fwd       one block per (bh, q tile), the heaviest causal q
//                   tiles issued first; loops over the kv tiles its rows
//                   see with an f32 running max m, denominator l and
//                   accumulator: S = Q K^T, P = exp(S*scale - m),
//                   O += P V. Writes o (input dtype) and
//                   lse = m + log(max(l, 1e-30)) (f32, (BH, S)).
//   flash_bwd_dq    runs first: one block per (bh, q tile), the last
//                   (heaviest causal) q tiles issued first. Computes
//                   D_i = rowsum(dO_i * O_i) once for its rows and writes
//                   it to `delta` (f32, (BH, S)), then loops over the kv
//                   tiles its rows see: S = Q K^T, dP = dO V^T,
//                   P = exp(S*scale - lse), dS = P * (dP - D),
//                   dQ += scale * dS K.
//   flash_bwd_dkdv  one block per (bh, kv tile); loops over the q tiles
//                   that see it, reading lse and D (not O): S^T = K Q^T,
//                   dP^T = V dO^T, dV += P^T dO, dK += scale * dS^T Q.
//
// Mask: key k is visible to query q when k < S, k <= q (causal) and
// q - k < window (window > 0), the reference's sliding window
// (src/repro/models/attention.py, _mask_bias).
//
// Every block owns its outputs: no atomics, and a fixed loop order, so
// results repeat bitwise from run to run.
//
// Layout: q, k, dq, dk are contiguous (BH, S, DK) and v, o, dO, dv
// contiguous (BH, S, DV); f32 or bf16, computed in f32. The widths are a
// template pair (DK, DV): DK = DV in (16, 32, 64, 128, 256), and (192,
// 128), multi-head latent attention's q.k width (128 + 64 rotary) beside
// its v width (DeepSeek-V2, src/repro/models/mla.py). QK^T and dQ, dK run
// at DK; PV, dO V^T, D = rowsum(dO * O) and dV at DV. S need not be a
// multiple of any tile: rows >= S load as zero, their scores are masked
// and their outputs are not written, so the reference's "blocks divide
// S" contract is relaxed rather than kept.
//
// What bounds it on an H100: at the main paths' shapes (BH 32, S 2048,
// D 64 and 128 and (192, 128), f32, causal; BH 10, S 4096, D 256, bf16,
// window 2048) the work is 2 (DK + DV) FLOPs per visible (q, k) pair
// forward and 8 DK + 6 DV backward (both kernels form S and dP) against
// a few hundred bytes per row, far above the card's bytes-to-FLOP line,
// so the bound is arithmetic.
//
// Every product runs on the tensor cores through warp-level mma.sync,
// accumulating in f32:
//  - bf16: m16n8k16 on bf16 operands, which stay bf16 in shared memory.
//    P and dS, the A operands of the O, dV, dK and dQ products, are
//    split into a bf16 high and low part, two products each: rounded to
//    bf16 once, they moved outputs above 4 by a bf16 step there (2^-5),
//    past the check's 2e-2.
//  - f32: three m16n8k8 TF32 products a step (3xTF32). Each operand x is
//    split in registers as it is loaded, big = tf32(x) and small = x -
//    big, and big*small + small*big + big*big keeps close to f32
//    accuracy, where one TF32 product keeps about 10 bits. Shared memory
//    holds f32. The card's TF32 rate over three is its fastest route at
//    f32 accuracy: 165 TFLOP/s, against 67 on the CUDA cores.
//  - The tensor cores truncate each product's sum into their
//    accumulator, a bias that grows with the number of sums: over all of
//    a sequence's rows into one accumulator it moved dV past the f32
//    check's 1e-4 at d 128, S 2048. So O, dV, dK and dQ sum each walked
//    tile into a fresh accumulator and add that to the running one in
//    f32, rounding to nearest.
// A warp owns 16 rows of the block's own tile (q rows in the forward and
// dq, kv rows in dkdv), so the score products put those rows in the
// MMA's M dimension (S^T = K Q^T in dkdv) and the accumulator of S is
// already the A operand of the product that follows: in bf16 two n8
// accumulators pack into one k16 A fragment; in TF32 the accumulator's
// columns (2t, 2t + 1) serve as the A fragment's k = (t, t + 4), and B
// is read from the matching rows.
// The forward keeps its softmax online in that layout: lane (g, t) holds
// rows g and g + 8, and for each a running max m of the scores times
// scale * log2(e), its share of the row's denominator l (the quad adds
// the four shares at the end) and the output accumulator, which is
// rescaled by exp2(m_old - m_new) before each tile's P V is added.
// Where the outputs outgrow a thread's registers (dK and dV, 2 x 16 x
// 256 f32 a warp at D = 256 and 16 x (192 + 128) at (192, 128); the
// bf16 forward's O at D = 256), WD = 2 warps share each 16 rows, each
// computes S (and dP) for half of the walked columns and owns half of
// the output columns, and P (and dS; in the forward also each row's max
// and denominator) pass through shared memory between them. Tiles and
// warps per instance are in attn_tiles(): 64-row own tiles and 4 warps
// up to D = 64, 8 warps above, walked tiles of 16 to 64 rows as the
// registers allow; the forward takes dq's but at D = 256 in bf16.
// The walked tiles (Q, dO, lse, D in dkdv; K, V in the forward and dq)
// come in by cp.async into a ring of two stages, so the next tile's copy
// runs under the current tile's products; the block's own tiles load
// once, and rows at or beyond S arrive as zeros. Shared-memory rows are
// padded by 16 bytes, so ldmatrix and the scalar TF32 fragment loads are
// free of bank conflicts. Only tiles that cross the diagonal, the
// window's edge or S are masked element by element; tiles wholly outside
// are skipped, by the block, or by a warp none of whose rows sees them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// cp.async, ldmatrix, the TF32 split and the mma.sync fragments
#include "mma_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

// Whether key kj is visible to query qi.
__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal,
                                        int window) {
  return kj < S && (!causal || kj <= qi) && (!window || qi - kj < window);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// acc[NC / 8][4] = X Y^T over D for one warp: X its 16 rows of the own
// tile (at xs), Y NC rows of the walked tile (at ys), rows LD elements
// apart in shared memory. Accumulator layout of m16n8: acc[j][e] is row
// g + 8 * (e / 2), column 8 j + 2 t + e % 2, with g = lane / 4 and
// t = lane % 4. Each ldmatrix.x4 reads 32 bytes of k: one k step of
// either product (16 bf16 or 8 f32).
template <typename T, int D, int LD, int NC>
__device__ __forceinline__ void score(float (&acc)[NC / 8][4], const T* xs,
                                      const T* ys, int lane) {
  constexpr int ROW = LD * (int)sizeof(T), KSTEPS = D * (int)sizeof(T) / 32;
  const uint32_t xa = smem_u32(xs) + (lane & 15) * ROW + (lane >> 4) * 16;
  const uint32_t ya = smem_u32(ys) +
                      ((lane & 7) + ((lane >> 4) << 3)) * ROW +
                      ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t r[4];
    ldsm_x4(r, xa + kk * 32);
    const FragA<T> a = frag_a_raw<T>(r);
#pragma unroll
    for (int n = 0; n < NC / 16; ++n) {
      ldsm_x4(r, ya + n * 16 * ROW + kk * 32);
      mma_op(acc[2 * n], a, frag_b_raw<T>(r[0], r[1]));
      mma_op(acc[2 * n + 1], a, frag_b_raw<T>(r[2], r[3]));
    }
  }
}

// x = hi + lo for a pair of values, both parts in bf16 (hi rounded to
// nearest, lo the rounded remainder): about 16 bits of each.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc[NO / 8][4] += A Y for one warp: A is 16 x K, given in the
// accumulator layout of score() (p[j] holds columns 8 j ... 8 j + 7), Y
// is K walked rows by NO columns in shared memory from ys.
//  - The sum over this tile's K rows goes into a fresh accumulator for
//    every two n8 tiles, which is then added to acc in f32 (the note at
//    the head of the file says why).
//  - bf16: A (P or dS) is split into a bf16 high and low part, two
//    products. Two n8 accumulators pack into one k16 A fragment, and
//    ldmatrix.trans reads Y.
//  - TF32: the accumulator's columns (2t, 2t + 1) serve as the A
//    fragment's k = (t, t + 4), and B is read from Y's rows 2t and 2t + 1
//    to match.
template <typename T, int K, int NO, int LD>
__device__ __forceinline__ void outer(float (&acc)[NO / 8][4],
                                      const float (&p)[K / 8][4],
                                      const T* ys, int lane) {
  if constexpr (std::is_same<T, float>::value) {
    FragA<float> a[K / 8];
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
      a[kk] = frag_a_tf32(p[kk][0], p[kk][2], p[kk][1], p[kk][3]);
    const float* yb = ys + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
    for (int n = 0; n < NO / 8; n += 2) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < K / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* y = yb + kk * 8 * LD + (n + i) * 8;
          mma_op(part[i], a[kk], frag_b_raw<float>(__float_as_uint(y[0]),
                                                   __float_as_uint(y[LD])));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n + i][e] += part[i][e];
    }
  } else {
    FragA<__nv_bfloat16> hi[K / 16], lo[K / 16];
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 2 * kk + (r >> 1), e = 2 * (r & 1);
        split_bf16(p[j][e], p[j][e + 1], hi[kk].x[r], lo[kk].x[r]);
      }
    constexpr int ROW = LD * 2;
    const uint32_t ya = smem_u32(ys) +
                        ((lane & 7) + (((lane >> 3) & 1) << 3)) * ROW +
                        (lane >> 4) * 16;
#pragma unroll
    for (int n = 0; n < NO / 16; ++n) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < K / 16; ++kk) {
        uint32_t r[4];
        ldsm_x4_t(r, ya + kk * 16 * ROW + n * 32);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const FragB<__nv_bfloat16> b = frag_b_raw<T>(r[2 * i], r[2 * i + 1]);
          mma_op(part[i], lo[kk], b);
          mma_op(part[i], hi[kk], b);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[2 * n + i][e] += part[i][e];
    }
  }
}

// Rows [r0, r0 + ROWS) of an (S, D) matrix into s (rows LD elements
// apart) by cp.async; rows >= S arrive as zeros.
template <typename T, int D, int ROWS, int LD, int NTH>
__device__ __forceinline__ void load_rows(T* s, const T* g, int r0, int S) {
  constexpr int CH = 16 / (int)sizeof(T), CPR = D / CH;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTH) {
    const int r = c / CPR, col = (c % CPR) * CH, row = r0 + r;
    const bool in = row < S;
    cp_async16(s + r * LD + col, g + (size_t)(in ? row : 0) * D + col, in);
  }
}

// n entries [r0, r0 + n) of a length-S f32 vector into s; zeros past S.
template <int NTH>
__device__ __forceinline__ void load_vec(float* s, const float* g, int r0,
                                         int n, int S) {
  for (int i = threadIdx.x; i < n; i += NTH) {
    const bool in = r0 + i < S;
    cp_async4(s + i, g + (in ? r0 + i : 0), in);
  }
}

// One warp's 16 x NO accumulator, times `mul`, into rows r0 + (0..15) and
// columns c0 + (0..NO) of an (S, D) matrix; rows >= S are not written.
template <typename T, int D, int NO>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[NO / 8][4],
                                           int r0, int c0, int S, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NO / 8; ++j)
      store2<T>(out + (size_t)row * D + c0 + 8 * j + 2 * t,
                acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
  }
}

// Tiles and warps of an instance: BM rows of the block's own tile
// (16 a warp row), BN rows of each walked tile, NW warps in NW / WD rows
// by WD groups of output columns. The walked tile is as long as the
// registers allow without spilling: f32 A fragments take twice bf16's
// registers (big and small parts), and bf16 dkdv at D = 128 holds the
// high and low parts of P and dS beside 128 accumulators a thread. At
// D = 256, dK and dV take two column groups (WD = 2), and so does the
// bf16 forward's O: with 128 accumulators a thread it spilled at every
// walked tile from 16 to 64 rows.
// At (DK, DV) = (192, 128) the forward's O is d 128's, so it takes d
// 128's tiles; dQ (96 accumulators a thread) walks 32-row tiles, and in
// f32 its own tiles are 64 rows, since 128 rows of Q and dO beside the
// ring came to 246 KB of shared memory; dK and dV (160 together) take
// two column groups, as at D = 256.
struct Tiles { int bm, bn, nw, wd; };
enum Kernel { FWD, DQ, DKDV };

template <typename T, int DK, int DV, Kernel K> constexpr Tiles attn_tiles() {
  constexpr bool f32 = std::is_same<T, float>::value;
  if constexpr (DK != DV) {
    static_assert(DK == 192 && DV == 128, "no tiles for this width pair");
    if (K == FWD) return {128, f32 ? 32 : 64, 8, 1};
    if (K == DQ) return f32 ? Tiles{64, 32, 4, 1} : Tiles{128, 32, 8, 1};
    return f32 ? Tiles{32, 32, 4, 2} : Tiles{64, 32, 8, 2};
  }
  constexpr int D = DK;
  if (D <= 64) return {64, f32 ? 32 : 64, 4, 1};
  if (D == 128) return {128, f32 ? 32 : K == DKDV ? 16 : 64, 8, 1};
  if (K == DKDV) return f32 ? Tiles{32, 32, 4, 2} : Tiles{64, 32, 8, 2};
  if (K == FWD && !f32) return {64, 64, 8, 2};
  return f32 ? Tiles{64, 16, 4, 1} : Tiles{128, 32, 8, 1};
}

// Shared-memory row of a tile: D elements and 16 bytes of padding, so the
// eight 16-byte rows an ldmatrix phase reads fall in distinct banks, and
// so do the TF32 B loads of outer() (rows 2t apart).
template <typename T, int D> __host__ __device__ constexpr int tile_ld() {
  return D + 16 / (int)sizeof(T);
}

// Forward: each warp owns 16 q rows of the block's BM and walks the kv
// tiles [kv_lo, kv_hi) its block sees, BN rows of K and V at a time:
// S = Q K^T (score), the online softmax of the note at the head of the
// file, O += P V (outer). With WD = 2 the two warps of a row group each
// take half of the walked columns of S and half of the output columns
// of O, and pass their halves of each row's max and of P through shared
// memory. A tile none of whose keys a row group sees is skipped by its
// warps alone.
template <typename T, int DK, int DV, int BM, int BN, int NW, int WD>
__global__ void __launch_bounds__(NW * 32, 1)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, int S, int causal, int window,
           float scale) {
  constexpr int WM = NW / WD, NTH = NW * 32;
  constexpr int LDK = tile_ld<T, DK>(), LDV = tile_ld<T, DV>();
  constexpr int STAGE = BN * (LDK + LDV);  // a ring stage: K, then V
  constexpr int BNW = BN / WD, DW = DV / WD, LDP = BN + 8;
  static_assert(BM == 16 * WM && BNW % 16 == 0 && DW % 16 == 0, "tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* KV = Qs + BM * LDK;                   // stage s: K at KV + s STAGE
  float* Ps = reinterpret_cast<float*>(KV + 2 * STAGE);    // WD > 1: P
  float* Xs = Ps + BM * LDP;               // WD > 1: [wd][row] max, then l
  const int bh = blockIdx.x, n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;   // heaviest first
  const size_t bk = (size_t)bh * S * DK, bv = (size_t)bh * S * DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp % WM, wd = warp / WM;
  const int n_kv = (S + BN - 1) / BN;
  const int kv_lo = window ? max(0, q0 - window + 1) / BN : 0;
  const int kv_hi = causal ? min(n_kv, (min(q0 + BM, S) - 1) / BN + 1)
                           : n_kv;

  load_rows<T, DK, BM, LDK, NTH>(Qs, q + bk, q0, S);
  if (kv_lo < kv_hi) {
    load_rows<T, DK, BN, LDK, NTH>(KV, k + bk, kv_lo * BN, S);
    load_rows<T, DV, BN, LDV, NTH>(KV + BN * LDK, v + bv, kv_lo * BN, S);
  }
  cp_commit();

  const int r0 = q0 + wm * 16, pr = wm * 16 + g;
  const float sl2 = scale * LOG2E;
  // rows g and g + 8: running max (base 2), this lane's share of l
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DW / 8][4] = {};
  for (int it = kv_lo; it < kv_hi; ++it) {
    const int st = (it - kv_lo) & 1;
    if (it + 1 < kv_hi) {
      T* nxt = KV + (st ^ 1) * STAGE;
      load_rows<T, DK, BN, LDK, NTH>(nxt, k + bk, (it + 1) * BN, S);
      load_rows<T, DV, BN, LDV, NTH>(nxt + BN * LDK, v + bv, (it + 1) * BN,
                                     S);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Ks = KV + st * STAGE;
    const T* Vs = Ks + BN * LDK;
    const int k0 = it * BN, c0 = k0 + wd * BNW;
    const bool none = r0 >= S || (causal && k0 > r0 + 15) ||
                      (window && r0 - (k0 + BN - 1) >= window);
    const bool edge = (causal && k0 + BN - 1 > r0) ||
                      (window && r0 + 15 - k0 >= window) || k0 + BN > S;
    float s[BNW / 8][4], mx[2] = {NEG_INF, NEG_INF};
    if (!none) {
      score<T, DK, LDK, BNW>(s, Qs + wm * 16 * LDK, Ks + wd * BNW * LDK,
                             lane);
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge && !visible(r0 + g + 8 * (e >> 1),
                               c0 + 8 * j + 2 * t + (e & 1), S, causal,
                               window))
            s[j][e] = NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
        if (WD > 1 && t == 0) Xs[wd * BM + pr + 8 * h] = mx[h];
      }
    }
    if constexpr (WD > 1) {
      __syncthreads();
      if (!none) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(mx[h], Xs[(wd ^ 1) * BM + pr + 8 * h]);
      }
    }
    float corr[2] = {1.f, 1.f};
    if (!none) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], mx[h] * sl2);
        corr[h] = exp2f(m[h] - mn);
        m[h] = mn;
        l[h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // an invisible key counts 0 even where the row has seen no key
          // yet (m = NEG_INF, so exp2 of the difference would be 1)
          const float p = edge && s[j][e] == NEG_INF
                              ? 0.f
                              : exp2f(fmaf(s[j][e], sl2, -m[e >> 1]));
          l[e >> 1] += p;
          s[j][e] = p;
        }
      if constexpr (WD > 1) {
#pragma unroll
        for (int j = 0; j < BNW / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(Ps + (pr + 8 * h) * LDP + wd * BNW +
                                       8 * j + 2 * t) =
                make_float2(s[j][2 * h], s[j][2 * h + 1]);
      }
    }
    if constexpr (WD > 1) __syncthreads();
    if (!none) {
#pragma unroll
      for (int j = 0; j < DW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
      if constexpr (WD == 1) {
        outer<T, BN, DV, LDV>(acc, s, Vs, lane);
      } else {
        float rows[BN / 8][4];             // the full rows of P
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 a = *reinterpret_cast<const float2*>(
                Ps + (pr + 8 * h) * LDP + 8 * j + 2 * t);
            rows[j][2 * h] = a.x;
            rows[j][2 * h + 1] = a.y;
          }
        outer<T, BN, DW, LDV>(acc, rows, Vs + wd * DW, lane);
      }
    }
    __syncthreads();                       // stage st free for it + 2
  }
  cp_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
    if (WD > 1 && t == 0) Xs[wd * BM + pr + 8 * h] = l[h];
  }
  if constexpr (WD > 1) {
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] += Xs[(wd ^ 1) * BM + pr + 8 * h];
  }
  // 1 / den by the approximate reciprocal (within 2 ulp): an IEEE
  // division's slow path is a call, around which the live accumulator
  // spills
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = fmaxf(l[h], 1e-30f);
    inv[h] = __fdividef(1.f, den);
    const int row = r0 + g + 8 * h;
    if (wd == 0 && t == 0 && row < S)
      lse[(size_t)bh * S + row] = m[h] * LN2 + logf(den);
  }
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  store_rows<T, DV, DW>(o + bv, acc, r0, wd * DW, S, 1.f, lane);
}

template <typename T, int DK, int DV, int BM, int BN, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const float* __restrict__ lse, const T* __restrict__ dout,
              T* __restrict__ dq, float* __restrict__ delta, int S,
              int causal, int window, float scale) {
  static_assert(BM == 16 * NW, "dq: one warp per 16 q rows");
  constexpr int NTH = NW * 32;
  constexpr int LDK = tile_ld<T, DK>(), LDV = tile_ld<T, DV>();
  constexpr int STAGE = BN * (LDK + LDV);  // a ring stage: K, then V
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BM * LDK;
  T* KV = dOs + BM * LDV;                  // stage s: K at KV + s STAGE
  const int bh = blockIdx.x, n_qt = (S + BM - 1) / BM;
  const int q0 = (n_qt - 1 - (int)blockIdx.y) * BM;   // heaviest first
  const size_t bk = (size_t)bh * S * DK, bv = (size_t)bh * S * DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_kv = (S + BN - 1) / BN;
  const int kv_lo = window ? max(0, q0 - window + 1) / BN : 0;
  const int kv_hi = causal ? min(n_kv, (min(q0 + BM, S) - 1) / BN + 1)
                           : n_kv;

  load_rows<T, DK, BM, LDK, NTH>(Qs, q + bk, q0, S);
  load_rows<T, DV, BM, LDV, NTH>(dOs, dout + bv, q0, S);
  if (kv_lo < kv_hi) {
    load_rows<T, DK, BN, LDK, NTH>(KV, k + bk, kv_lo * BN, S);
    load_rows<T, DV, BN, LDV, NTH>(KV + BN * LDK, v + bv, kv_lo * BN, S);
  }
  cp_commit();

  // D_i = rowsum(dO_i * O_i) and lse_i for the warp's 16 rows while the
  // copies fly; lane (g, t) keeps rows g and g + 8.
  const int r0 = q0 + warp * 16;
  float dl[2] = {0.f, 0.f}, l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    l2[h] = row < S ? lse[(size_t)bh * S + row] * LOG2E : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int row = r0 + i;
    float acc = 0.f;
    if (row < S)
      for (int d = lane; d < DV; d += 32)
        acc += to_f(dout[bv + (size_t)row * DV + d]) *
               to_f(o[bv + (size_t)row * DV + d]);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0 && row < S) delta[(size_t)bh * S + row] = acc;
    if (i == g) dl[0] = acc;
    if (i == g + 8) dl[1] = acc;
  }

  const float sl2 = scale * LOG2E;
  float acc[DK / 8][4];
#pragma unroll
  for (int j = 0; j < DK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int it = kv_lo; it < kv_hi; ++it) {
    const int st = (it - kv_lo) & 1;
    if (it + 1 < kv_hi) {
      T* nxt = KV + (st ^ 1) * STAGE;
      load_rows<T, DK, BN, LDK, NTH>(nxt, k + bk, (it + 1) * BN, S);
      load_rows<T, DV, BN, LDV, NTH>(nxt + BN * LDK, v + bv, (it + 1) * BN,
                                     S);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Ks = KV + st * STAGE;
    const T* Vs = Ks + BN * LDK;
    float s[BN / 8][4], dp[BN / 8][4];
    score<T, DK, LDK, BN>(s, Qs + warp * 16 * LDK, Ks, lane);
    score<T, DV, LDV, BN>(dp, dOs + warp * 16 * LDV, Vs, lane);
    const int k0 = it * BN;
    const bool edge = (causal && k0 + BN - 1 > q0) ||
                      (window && q0 + BM - 1 - k0 >= window) || k0 + BN > S;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[j][e], sl2, -l2[e >> 1]));
        if (edge && !visible(r0 + g + 8 * (e >> 1),
                             k0 + 8 * j + 2 * t + (e & 1), S, causal,
                             window))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[e >> 1]);         // dS
      }
    outer<T, BN, DK, LDK>(acc, s, Ks, lane);
    __syncthreads();                       // stage st free for it + 2
  }
  cp_wait<0>();
  store_rows<T, DK, DK>(dq + bk, acc, r0, 0, S, scale, lane);
}

template <typename T, int DK, int DV, int BM, int BN, int NW, int WD>
__global__ void __launch_bounds__(NW * 32, 1)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ delta,
                const float* __restrict__ lse, const T* __restrict__ dout,
                T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                int window, float scale) {
  constexpr int WM = NW / WD, NTH = NW * 32;
  constexpr int LDK = tile_ld<T, DK>(), LDV = tile_ld<T, DV>();
  constexpr int STAGE = BN * (LDK + LDV);  // a ring stage: Q, then dO
  constexpr int BNW = BN / WD, DKW = DK / WD, DVW = DV / WD, LDP = BN + 8;
  static_assert(BM == 16 * WM && BNW % 16 == 0 && DKW % 16 == 0 &&
                    DVW % 16 == 0,
                "tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + BM * LDK;
  T* QD = Vs + BM * LDV;                   // stage s: Q at QD + s STAGE
  float* LDl = reinterpret_cast<float*>(QD + 2 * STAGE);    // [s][lse, D]
  float* Ps = LDl + 4 * BN;                // WD > 1: P, then dS, staged
  const int bh = blockIdx.x, k0 = blockIdx.y * BM;     // heaviest first
  const size_t bk = (size_t)bh * S * DK, bv = (size_t)bh * S * DV;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* dl_bh = delta + (size_t)bh * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp % WM, wd = warp / WM;
  const int n_q = (S + BN - 1) / BN;
  const int q_lo = causal ? k0 / BN : 0;
  // the last query that sees a key of this tile is its last key + window - 1
  const int q_hi =
      window ? min(n_q, (min(k0 + BM, S) + window - 2) / BN + 1) : n_q;

  load_rows<T, DK, BM, LDK, NTH>(Ks, k + bk, k0, S);
  load_rows<T, DV, BM, LDV, NTH>(Vs, v + bv, k0, S);
  if (q_lo < q_hi) {
    load_rows<T, DK, BN, LDK, NTH>(QD, q + bk, q_lo * BN, S);
    load_rows<T, DV, BN, LDV, NTH>(QD + BN * LDK, dout + bv, q_lo * BN, S);
    load_vec<NTH>(LDl, lse_bh, q_lo * BN, BN, S);
    load_vec<NTH>(LDl + BN, dl_bh, q_lo * BN, BN, S);
  }
  cp_commit();

  const float sl2 = scale * LOG2E;
  const int r0 = k0 + wm * 16;
  float gk[DKW / 8][4], gv[DVW / 8][4];
#pragma unroll
  for (int j = 0; j < DKW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < DVW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) gv[j][e] = 0.f;
  for (int it = q_lo; it < q_hi; ++it) {
    const int st = (it - q_lo) & 1;
    if (it + 1 < q_hi) {
      T* nxt = QD + (st ^ 1) * STAGE;
      float* nl = LDl + (st ^ 1) * 2 * BN;
      load_rows<T, DK, BN, LDK, NTH>(nxt, q + bk, (it + 1) * BN, S);
      load_rows<T, DV, BN, LDV, NTH>(nxt + BN * LDK, dout + bv,
                                     (it + 1) * BN, S);
      load_vec<NTH>(nl, lse_bh, (it + 1) * BN, BN, S);
      load_vec<NTH>(nl + BN, dl_bh, (it + 1) * BN, BN, S);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Qs = QD + st * STAGE;
    const T* dOs = Qs + BN * LDK;
    const float* Ls = LDl + st * 2 * BN;
    const float* Dls = Ls + BN;
    // S^T and dP^T for the warp's 16 keys and its BNW queries
    float s[BNW / 8][4], dp[BNW / 8][4];
    score<T, DK, LDK, BNW>(s, Ks + wm * 16 * LDK, Qs + wd * BNW * LDK,
                           lane);
    score<T, DV, LDV, BNW>(dp, Vs + wm * 16 * LDV, dOs + wd * BNW * LDV,
                           lane);
    const int q0 = it * BN;
    const bool edge = (causal && q0 < k0 + BM - 1) ||
                      (window && q0 + BN - 1 - k0 >= window) || q0 + BN > S;
#pragma unroll
    for (int j = 0; j < BNW / 8; ++j) {
      const int c = wd * BNW + 8 * j + 2 * t;
      const float2 lq = *reinterpret_cast<const float2*>(Ls + c);
      const float2 dd = *reinterpret_cast<const float2*>(Dls + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + c + (e & 1);
        float p = exp2f(fmaf(s[j][e], sl2, -(e & 1 ? lq.y : lq.x) * LOG2E));
        if (edge && !(qi < S && visible(qi, r0 + g + 8 * (e >> 1), S, causal,
                                        window)))
          p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (e & 1 ? dd.y : dd.x));   // dS^T
      }
    }
    if constexpr (WD == 1) {
      outer<T, BN, DVW, LDV>(gv, s, dOs, lane);
      outer<T, BN, DKW, LDK>(gk, dp, Qs, lane);
    } else {
      // the warps of a row group exchange their column slices of P, dS
      float* dSs = Ps + BM * LDP;
      const int pr = wm * 16 + g;
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j) {
        const int c = wd * BNW + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float2*>(Ps + (pr + 8 * h) * LDP + c) =
              make_float2(s[j][2 * h], s[j][2 * h + 1]);
          *reinterpret_cast<float2*>(dSs + (pr + 8 * h) * LDP + c) =
              make_float2(dp[j][2 * h], dp[j][2 * h + 1]);
        }
      }
      __syncthreads();
      float rows[BN / 8][4];               // the full rows of P, then dS
#pragma unroll 1
      for (int x = 0; x < 2; ++x) {
        const float* src = x ? dSs : Ps;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 a = *reinterpret_cast<const float2*>(
                src + (pr + 8 * h) * LDP + 8 * j + 2 * t);
            rows[j][2 * h] = a.x;
            rows[j][2 * h + 1] = a.y;
          }
        if (x)
          outer<T, BN, DKW, LDK>(gk, rows, Qs + wd * DKW, lane);
        else
          outer<T, BN, DVW, LDV>(gv, rows, dOs + wd * DVW, lane);
      }
    }
    __syncthreads();                       // stage st free for it + 2
  }
  cp_wait<0>();
  store_rows<T, DK, DKW>(dk + bk, gk, r0, wd * DKW, S, scale, lane);
  store_rows<T, DV, DVW>(dv + bv, gv, r0, wd * DVW, S, 1.f, lane);
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

template <typename K>
int launch_prep(K kern, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Shared memory of an instance: `own` rows of the block's own tiles at
// each width (q in the forward; q and dO in dq; k and v in dkdv) and a
// ring of two stages of BN rows at both widths, in T.
template <typename T, int DK, int DV>
constexpr size_t tile_bytes(int own_k, int own_v, int bn) {
  return ((size_t)own_k * tile_ld<T, DK>() + (size_t)own_v * tile_ld<T, DV>() +
          2 * (size_t)bn * (tile_ld<T, DK>() + tile_ld<T, DV>())) *
         sizeof(T);
}

template <typename T, int DK, int DV>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        int bh, int S, int causal, int window, float scale,
        cudaStream_t st) {
  constexpr Tiles c = attn_tiles<T, DK, DV, FWD>();
  const size_t smem =
      tile_bytes<T, DK, DV>(c.bm, 0, c.bn) +
      (c.wd > 1 ? (c.bm * (c.bn + 8) + 2 * c.bm) * sizeof(float) : 0);
  auto kern = fwd_kernel<T, DK, DV, c.bm, c.bn, c.nw, c.wd>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid(bh, (S + c.bm - 1) / c.bm);
  kern<<<grid, c.nw * 32, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                      (T*)o, lse, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK, int DV>
int dkdv(const void* q, const void* k, const void* v, const float* delta,
         const float* lse, const void* dout, void* dk, void* dv, int bh,
         int S, int causal, int window, float scale, cudaStream_t st) {
  constexpr Tiles c = attn_tiles<T, DK, DV, DKDV>();
  const size_t smem =
      tile_bytes<T, DK, DV>(c.bm, c.bm, c.bn) + 4 * c.bn * sizeof(float) +
      (c.wd > 1 ? 2 * c.bm * (c.bn + 8) * sizeof(float) : 0);
  auto kern = bwd_dkdv_kernel<T, DK, DV, c.bm, c.bn, c.nw, c.wd>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid(bh, (S + c.bm - 1) / c.bm);
  kern<<<grid, c.nw * 32, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                      delta, lse, (const T*)dout, (T*)dk,
                                      (T*)dv, S, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int DK, int DV>
int dq(const void* q, const void* k, const void* v, const void* o,
       const float* lse, const void* dout, void* dqp, float* delta, int bh,
       int S, int causal, int window, float scale, cudaStream_t st) {
  constexpr Tiles c = attn_tiles<T, DK, DV, DQ>();
  static_assert(c.wd == 1, "dq: a warp owns all of its rows' columns");
  const size_t smem = tile_bytes<T, DK, DV>(c.bm, c.bm, c.bn);
  auto kern = bwd_dq_kernel<T, DK, DV, c.bm, c.bn, c.nw>;
  if (int rc = launch_prep(kern, smem)) return rc;
  dim3 grid(bh, (S + c.bm - 1) / c.bm);
  kern<<<grid, c.nw * 32, smem, st>>>((const T*)q, (const T*)k, (const T*)v,
                                      (const T*)o, lse, (const T*)dout,
                                      (T*)dqp, delta, S, causal, window,
                                      scale);
  return (int)cudaGetLastError();
}

// The instances, by (q.k width, v width) and dtype (0 = float32, 1 =
// bfloat16): one width for both in (16, 32, 64, 128, 256), or (192, 128).
#define DISPATCH(FN, ...)                                                 \
  if (dk == dv) {                                                         \
    switch (dk * 2 + dtype) {                                             \
      case 32: return FN<float, 16, 16>(__VA_ARGS__);                     \
      case 33: return FN<__nv_bfloat16, 16, 16>(__VA_ARGS__);             \
      case 64: return FN<float, 32, 32>(__VA_ARGS__);                     \
      case 65: return FN<__nv_bfloat16, 32, 32>(__VA_ARGS__);             \
      case 128: return FN<float, 64, 64>(__VA_ARGS__);                    \
      case 129: return FN<__nv_bfloat16, 64, 64>(__VA_ARGS__);            \
      case 256: return FN<float, 128, 128>(__VA_ARGS__);                  \
      case 257: return FN<__nv_bfloat16, 128, 128>(__VA_ARGS__);          \
      case 512: return FN<float, 256, 256>(__VA_ARGS__);                  \
      case 513: return FN<__nv_bfloat16, 256, 256>(__VA_ARGS__);          \
    }                                                                     \
  } else if (dk == 192 && dv == 128) {                                    \
    return dtype ? FN<__nv_bfloat16, 192, 128>(__VA_ARGS__)               \
                 : FN<float, 192, 128>(__VA_ARGS__);                      \
  }                                                                       \
  return kUnsupported;

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// 100000 for a width pair (dk, dv) / dtype / window with no instance.
// dk is the width of q and k (and dq, dk), dv that of v and o (and dO,
// dv). window = 0 means no window.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int bh, int s, int dk, int dv, int dtype,
              int causal, int window, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(fwd, q, k, v, o, (float*)lse, bh, s, causal, window, scale,
           (cudaStream_t)stream)
}

// Run flash_bwd_dq first: it writes delta, which flash_bwd_dkdv reads.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* o, const void* lse, const void* dout,
                 void* dqp, void* delta, int bh, int s, int dk, int dv,
                 int dtype, int causal, int window, float scale,
                 void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(dq, q, k, v, o, (const float*)lse, dout, dqp, (float*)delta, bh,
           s, causal, window, scale, (cudaStream_t)stream)
}

int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* delta, const void* lse, const void* dout,
                   void* dkp, void* dvp, int bh, int s, int dk, int dv,
                   int dtype, int causal, int window, float scale,
                   void* stream) {
  if ((dtype != 0 && dtype != 1) || window < 0) return kUnsupported;
  DISPATCH(dkdv, q, k, v, (const float*)delta, (const float*)lse, dout, dkp,
           dvp, bh, s, causal, window, scale, (cudaStream_t)stream)
}

}  // extern "C"
