// Chunkwise stabilized mLSTM for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernel `_mlstm_kernel` / `mlstm_chunkwise` in
// src/repro/kernels/mlstm.py, which is forward-only and keeps one head's
// (C, n, m) state in VMEM scratch across a sequential grid axis of
// chunks. Here blocks run in no order, and one head's C (K x K f32, 1 MiB
// at K = 512) is four times what a block may hold in shared memory. So a
// block owns one head and one 64-wide column tile of its state and walks
// the chunks in order (forward) or in reverse (backward) inside the
// block:
//
//   mlstm_fwd       block (column tile j of C, head). Keeps C[:, j]
//                   (K x 64 f32, 128 KB at K = 512) and all of n in
//                   shared memory. Per chunk it streams q and k through
//                   shared memory in 64-wide slices, accumulating
//                   q k^T (L x L, recomputed by every tile of the head),
//                   q C[:, j] and q.n in registers; builds the decay
//                   matrix D and the row stabilizers m_loc from the
//                   chunk's inclusive cumsum of log_f; writes h[:, j];
//                   then advances C[:, j] and n to the chunk's end. With
//                   aux pointers it also writes each chunk's starting
//                   (C, n, m) and each row's m_loc and den, which is
//                   what the backward reads.
//   mlstm_bwd_dqdk  block (row tile r of C, head), chunks in reverse,
//                   carrying dC[r, :] (64 x K) and dn[r] in shared
//                   memory: dq[:, r] and dk[:, r]. Every reduction over
//                   v (dh.h, v.dnum^T, C dnum, dC v) is taken in-block,
//                   streaming the v axis in 64-wide slices.
//   mlstm_bwd_dv    block (column tile j, head), chunks in reverse,
//                   carrying dC[:, j] (K x 64): dv[:, j]. The head's
//                   first tile also writes dlog_i_s = k_s.dk_s and
//                   dlog_f_t = sum_{j>=t} (q_j.dq_j - k_j.dk_j), a
//                   cumulative sum carried across chunks in reverse;
//                   it runs after mlstm_bwd_dqdk, whose dq and dk it
//                   reads.
// The backward treats every stabilizer as a constant (they cancel from
// h exactly; see kernels/mlstm.py). Cumulative sums are taken in-kernel
// by one thread in order; every block owns its outputs: no atomics and
// one fixed order, so results repeat bitwise from run to run.
//
// Layout: q, k, v, h, dh contiguous (BH, S, K) in T (float or bf16);
// log_i, log_f, m_loc, den, dlog_i, dlog_f (BH, S) f32; C states (BH,
// nc, K, K), n states (BH, nc, K), m states (BH, nc), f32; dq, dk, dv
// (BH, S, K) f32. K is a multiple of 64 up to 512; the chunk L is at
// most 64 and divides S (rows past L are zero-padded in the tiles).
//
// What bounds it on an H100: at the xLSTM-350M path's shape (BH 16, S
// 4096, K 512, L 64, f32) the forward does about 75.5 MFLOP per (head,
// chunk) -- q C and the C update 33.6 M each, q k^T and (D * qk) v 4.2 M
// each -- 77 GFLOP in all, 1.15 ms at the 67 TFLOP/s f32 rate, against
// 0.54 GB of q, k, v, h (0.16 ms) plus 1.07 GB of per-chunk states
// (0.32 ms): bound by arithmetic. The backward does about 6 L K^2 (dq,
// dk) plus 4 L K^2 (dv) per (head, chunk), 168 GFLOP, 2.5 ms. This
// first version runs plain FMA loops over shared-memory tiles (a 4 x 4
// register tile per thread, 256 threads, one block of ~200 KB per SM,
// 128 blocks at the path's shape) and recomputes q k^T (and in the
// backward v dnum^T) in each of a head's K/64 tiles, about 40 % more
// arithmetic than the function needs. Tensor cores (TF32/bf16 wgmma)
// and a chunk-parallel form are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block: 16 x 16
constexpr int TILE = 64;          // column tile of C and K/V slice
constexpr int LMAX = 64;          // largest chunk
constexpr int PAD = TILE + 1;     // row stride of [64][64] tiles
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

// Inclusive cumsum of F[0..L) in place, by thread 0 in order.
__device__ __forceinline__ void cumsum_serial(float* F, int L) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int t = 0; t < L; ++t) {
      acc += F[t];
      F[t] = acc;
    }
  }
}

// m_new = max(m + Ftot, max_s(li_s + Ftot - F_s)) and the decay of the
// carried state exp(m + Ftot - m_new), by thread 0: sc = {m_new, decay,
// Ftot}.
__device__ __forceinline__ void carry_scalars(const float* F,
                                              const float* li, float m,
                                              int L, float* sc) {
  if (threadIdx.x == 0) {
    const float Ftot = F[L - 1];
    float mn = m + Ftot;
    for (int s = 0; s < L; ++s) mn = fmaxf(mn, li[s] + Ftot - F[s]);
    sc[0] = mn;
    sc[1] = expf(m + Ftot - mn);
    sc[2] = Ftot;
  }
}

// ------------------------------------------------------------- forward
template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ li_g,
                 const float* __restrict__ lf_g, T* __restrict__ h,
                 float* __restrict__ Cst, float* __restrict__ nst,
                 float* __restrict__ mst, float* __restrict__ mloc_g,
                 float* __restrict__ den_g, int S, int K, int L,
                 float scale) {
  extern __shared__ float sm[];
  float* Cs = sm;                       // [K][TILE]  C[:, this tile]
  float* ns = Cs + K * TILE;            // [K]        n
  float* qs = ns + K;                   // [LMAX][PAD] q slice
  float* ks = qs + LMAX * PAD;          // [LMAX][PAD] k slice
  float* vs = ks + LMAX * PAD;          // [LMAX][TILE] v[:, this tile]
  float* Ps = vs + LMAX * TILE;         // [LMAX][PAD] D * qk
  float* F = Ps + LMAX * PAD;           // [LMAX] each from here
  float* li = F + LMAX;
  float* mloc = li + LMAX;
  float* cint = mloc + LMAX;
  float* den = cint + LMAX;
  float* w = den + LMAX;
  float* sc = w + LMAX;                 // [4]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int jt = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int nc = S / L;
  const int64_t col = (int64_t)jt * TILE;

  for (int i = tid; i < K * TILE; i += NT) Cs[i] = 0.f;
  for (int i = tid; i < K; i += NT) ns[i] = 0.f;
  float m = NEG;
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    const int64_t row0 = b * S + (int64_t)c * L;
    if (Cst) {        // this chunk's starting state, for the backward
      const int64_t st = b * nc + c;
      float* dst = Cst + st * K * K + col;
      for (int i = tid; i < K * TILE; i += NT)
        dst[(int64_t)(i / TILE) * K + i % TILE] = Cs[i];
      if (jt == 0) {
        for (int i = tid; i < K; i += NT) nst[st * K + i] = ns[i];
        if (tid == 0) mst[st] = m;
      }
    }
    if (tid < L) {
      li[tid] = li_g[row0 + tid];
      F[tid] = lf_g[row0 + tid];
    }
    __syncthreads();
    cumsum_serial(F, L);
    __syncthreads();
    if (tid < L) {
      const int t = tid;
      float mx = m + F[t];
      for (int s = 0; s <= t; ++s) mx = fmaxf(mx, F[t] - F[s] + li[s]);
      mloc[t] = mx;
      cint[t] = expf(m + F[t] - mx);
    }

    // q k^T, q C[:, tile] and q.n over K in 64-wide slices
    float aqk[4][4], aqc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) aqk[i][j] = aqc[i][j] = 0.f;
    float qn = 0.f;
    for (int k0 = 0; k0 < K; k0 += TILE) {
      __syncthreads();
      for (int i = tid; i < LMAX * TILE; i += NT) {
        const int t = i / TILE, kk = i % TILE;
        float a = 0.f, bb = 0.f;
        if (t < L) {
          a = to_f(q[(row0 + t) * K + k0 + kk]);
          bb = to_f(k[(row0 + t) * K + k0 + kk]);
        }
        qs[t * PAD + kk] = a;
        ks[t * PAD + kk] = bb;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TILE; ++kk) {
        float a[4], bk[4], bc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * PAD + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = ks[(tx + 16 * j) * PAD + kk];
          bc[j] = Cs[(k0 + kk) * TILE + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            aqk[i][j] = fmaf(a[i], bk[j], aqk[i][j]);
            aqc[i][j] = fmaf(a[i], bc[j], aqc[i][j]);
          }
      }
      if (tid < L)
        for (int kk = 0; kk < TILE; ++kk)
          qn = fmaf(qs[tid * PAD + kk], ns[k0 + kk], qn);
    }

    // P = D * qk (causal), and v[:, tile]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        float p = 0.f;
        if (s <= t && t < L)
          p = expf(F[t] - F[s] + li[s] - mloc[t]) * (aqk[i][j] * scale);
        Ps[t * PAD + s] = p;
      }
    for (int i = tid; i < LMAX * TILE; i += NT) {
      const int s = i / TILE;
      vs[i] = s < L ? to_f(v[(row0 + s) * K + col + i % TILE]) : 0.f;
    }
    __syncthreads();
    if (tid < L) {
      float rs = 0.f;
      for (int s = 0; s < L; ++s) rs += Ps[tid * PAD + s];
      den[tid] = cint[tid] * (qn * scale) + rs;
    }
    float ah[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ah[i][j] = 0.f;
    for (int s = 0; s < L; ++s) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[(ty + 16 * i) * PAD + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = vs[s * TILE + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ah[i][j] = fmaf(a[i], bv[j], ah[i][j]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= L) continue;
      const float dn = fmaxf(fabsf(den[t]), expf(-mloc[t]));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float num = cint[t] * (aqc[i][j] * scale) + ah[i][j];
        h[(row0 + t) * K + col + tx + 16 * j] = from_f<T>(num / dn);
      }
    }
    if (mloc_g && jt == 0 && tid < L) {
      mloc_g[row0 + tid] = mloc[tid];
      den_g[row0 + tid] = den[tid];
    }

    // carry C[:, tile] and n to the chunk's end
    carry_scalars(F, li, m, L, sc);
    __syncthreads();
    const float m_new = sc[0], decay = sc[1], Ftot = sc[2];
    if (tid < L) w[tid] = expf(li[tid] + Ftot - F[tid] - m_new);
    __syncthreads();
    for (int k0 = 0; k0 < K; k0 += TILE) {
      for (int i = tid; i < LMAX * TILE; i += NT) {
        const int s = i / TILE, r = i % TILE;
        ks[s * PAD + r] =
            s < L ? w[s] * to_f(k[(row0 + s) * K + k0 + r]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cc = tx + 16 * j;
          float acc = 0.f;
          for (int s = 0; s < L; ++s)
            acc = fmaf(ks[s * PAD + r], vs[s * TILE + cc], acc);
          float* cp = &Cs[(k0 + r) * TILE + cc];
          *cp = decay * *cp + acc;
        }
      if (tid < TILE) {
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc += ks[s * PAD + tid];
        ns[k0 + tid] = decay * ns[k0 + tid] + acc;
      }
      __syncthreads();
    }
    m = m_new;
  }
}

// Per-chunk row quantities both backward kernels need, in shared
// memory: F (inclusive cumsum), li, mloc, cint = exp(m + F - mloc),
// denom = max(|den|, exp(-mloc)), dden (the gradient of den, zero where
// the floor wins), w = exp(li + Ftot - F - m_new); sc = {m_new, decay,
// Ftot}. `part` ([LMAX][4]) takes the dh.h partial sums. Ends synced.
template <typename T>
__device__ void bwd_rows(const T* __restrict__ h, const T* __restrict__ dh,
                         const float* __restrict__ li_g,
                         const float* __restrict__ lf_g,
                         const float* __restrict__ mloc_g,
                         const float* __restrict__ den_g, float m,
                         int64_t row0, int K, int L, float* F, float* li,
                         float* mloc, float* cint, float* denom,
                         float* dden, float* w, float* part, float* sc) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < L) {
    li[tid] = li_g[row0 + tid];
    F[tid] = lf_g[row0 + tid];
    mloc[tid] = mloc_g[row0 + tid];
    denom[tid] = den_g[row0 + tid];
  }
  {
    const int t = tid / 4, p = tid % 4;
    float acc = 0.f;
    if (t < L)
      for (int j = p; j < K; j += 4)
        acc = fmaf(to_f(dh[(row0 + t) * K + j]), to_f(h[(row0 + t) * K + j]),
                   acc);
    part[t * 4 + p] = acc;
  }
  __syncthreads();
  cumsum_serial(F, L);
  __syncthreads();
  carry_scalars(F, li, m, L, sc);
  __syncthreads();
  if (tid < L) {
    const int t = tid;
    const float d = denom[t], fl = expf(-mloc[t]);
    const float dd = fmaxf(fabsf(d), fl);
    const float hd = ((part[4 * t] + part[4 * t + 1]) + part[4 * t + 2]) +
                     part[4 * t + 3];
    dden[t] = fabsf(d) > fl ? (d > 0.f ? -hd / dd : hd / dd) : 0.f;
    denom[t] = dd;
    cint[t] = expf(m + F[t] - mloc[t]);
    w[t] = expf(li[t] + sc[2] - F[t] - sc[0]);
  }
  __syncthreads();
}

// ------------------------------------------------- backward: dq and dk
template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_bwd_dqdk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const float* __restrict__ li_g,
                      const float* __restrict__ lf_g,
                      const T* __restrict__ h, const T* __restrict__ dh,
                      const float* __restrict__ Cst,
                      const float* __restrict__ nst,
                      const float* __restrict__ mst,
                      const float* __restrict__ mloc_g,
                      const float* __restrict__ den_g,
                      float* __restrict__ dq, float* __restrict__ dk,
                      int S, int K, int L, float scale) {
  extern __shared__ float sm[];
  const int DCP = K + 1;                // dC row stride (no bank clash)
  float* dCs = sm;                      // [TILE][K+1] dC[this tile, :]
  float* bA = dCs + TILE * DCP;         // [LMAX][PAD] dnum slice, then dP
  float* bB = bA + LMAX * PAD;          // [LMAX][PAD] v slice, then k tile
  float* bC = bB + LMAX * PAD;          // [TILE][PAD] C[tile, v slice]
  float* qt = bC + TILE * PAD;          // [LMAX][PAD] q[:, tile] * scale
  float* dn = qt + LMAX * PAD;          // [TILE]
  float* nct = dn + TILE;               // [TILE] n[tile] at chunk start
  float* F = nct + TILE;                // [LMAX] each from here
  float* li = F + LMAX;
  float* mloc = li + LMAX;
  float* cint = mloc + LMAX;
  float* denom = cint + LMAX;
  float* dden = denom + LMAX;
  float* w = dden + LMAX;
  float* part = w + LMAX;               // [LMAX][4]
  float* sc = part + 4 * LMAX;          // [4]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t b = blockIdx.y;
  const int64_t rt = (int64_t)blockIdx.x * TILE;   // this tile's rows
  const int nc = S / L;

  for (int i = tid; i < TILE * DCP; i += NT) dCs[i] = 0.f;
  if (tid < TILE) dn[tid] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int64_t row0 = b * S + (int64_t)c * L, st = b * nc + c;
    bwd_rows(h, dh, li_g, lf_g, mloc_g, den_g, mst[st], row0, K, L, F, li,
             mloc, cint, denom, dden, w, part, sc);
    const float decay = sc[1];
    if (tid < TILE) nct[tid] = nst[st * K + rt + tid];
    for (int i = tid; i < LMAX * TILE; i += NT) {
      const int t = i / TILE, r = i % TILE;
      qt[t * PAD + r] = t < L ? to_f(q[(row0 + t) * K + rt + r]) * scale
                              : 0.f;
    }

    // over v in 64-wide slices: v dnum^T, dnum C^T, v dC^T (dC as
    // carried in), then dC[tile, slice] += (cint q)^T dnum
    float avd[4][4], adq[4][4], adk[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) avd[i][j] = adq[i][j] = adk[i][j] = 0.f;
    for (int v0 = 0; v0 < K; v0 += TILE) {
      __syncthreads();
      for (int i = tid; i < LMAX * TILE; i += NT) {
        const int t = i / TILE, vv = i % TILE;
        float a = 0.f, bb = 0.f;
        if (t < L) {
          a = to_f(dh[(row0 + t) * K + v0 + vv]) / denom[t];
          bb = to_f(v[(row0 + t) * K + v0 + vv]);
        }
        bA[t * PAD + vv] = a;
        bB[t * PAD + vv] = bb;
        bC[t * PAD + vv] = Cst[(st * K + rt + t) * K + v0 + vv];
      }
      __syncthreads();
#pragma unroll 4
      for (int vv = 0; vv < TILE; ++vv) {
        float dnr[4], vr[4], vcl[4], ccl[4], dcc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dnr[i] = bA[(ty + 16 * i) * PAD + vv];
          vr[i] = bB[(ty + 16 * i) * PAD + vv];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vcl[j] = bB[(tx + 16 * j) * PAD + vv];
          ccl[j] = bC[(tx + 16 * j) * PAD + vv];
          dcc[j] = dCs[(tx + 16 * j) * DCP + v0 + vv];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            avd[i][j] = fmaf(dnr[i], vcl[j], avd[i][j]);
            adq[i][j] = fmaf(dnr[i], ccl[j], adq[i][j]);
            adk[i][j] = fmaf(vr[i], dcc[j], adk[i][j]);
          }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, vv = tx + 16 * j;
          float acc = 0.f;
          for (int t = 0; t < L; ++t)
            acc = fmaf(cint[t] * qt[t * PAD + r], bA[t * PAD + vv], acc);
          float* dp = &dCs[r * DCP + v0 + vv];
          *dp = decay * *dp + acc;
        }
    }
    __syncthreads();

    // dP = A * (v.dnum + dden) into bA, k[:, tile] into bB
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        float p = 0.f;
        if (s <= t && t < L)
          p = expf(F[t] - F[s] + li[s] - mloc[t]) * (avd[i][j] + dden[t]);
        bA[t * PAD + s] = p;
      }
    for (int i = tid; i < LMAX * TILE; i += NT) {
      const int s = i / TILE, r = i % TILE;
      bB[s * PAD + r] = s < L ? to_f(k[(row0 + s) * K + rt + r]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, r = tx + 16 * j;
        float acc = 0.f;
        for (int s = 0; s < L; ++s)
          acc = fmaf(bA[t * PAD + s], bB[s * PAD + r], acc);
        if (t < L)
          dq[(row0 + t) * K + rt + r] =
              (cint[t] * (adq[i][j] + nct[r] * dden[t]) + acc) * scale;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = ty + 16 * i, r = tx + 16 * j;
        float acc = 0.f;
        for (int t = 0; t < L; ++t)
          acc = fmaf(bA[t * PAD + s], qt[t * PAD + r], acc);
        if (s < L)
          dk[(row0 + s) * K + rt + r] = w[s] * (adk[i][j] + dn[r]) + acc;
      }
    __syncthreads();
    if (tid < TILE) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t)
        acc = fmaf(cint[t] * dden[t], qt[t * PAD + tid], acc);
      dn[tid] = decay * dn[tid] + acc;
    }
  }
}

// ------------------------------------- backward: dv and the log gates
template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_bwd_dv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const float* __restrict__ li_g,
                    const float* __restrict__ lf_g,
                    const T* __restrict__ h, const T* __restrict__ dh,
                    const float* __restrict__ mst,
                    const float* __restrict__ mloc_g,
                    const float* __restrict__ den_g,
                    const float* __restrict__ dq,
                    const float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ dli, float* __restrict__ dlf,
                    int S, int K, int L, float scale) {
  extern __shared__ float sm[];
  float* dCs = sm;                      // [K][TILE] dC[:, this tile]
  float* qs = dCs + K * TILE;           // [LMAX][PAD] q slice
  float* ks = qs + LMAX * PAD;          // [LMAX][PAD] k slice
  float* dnm = ks + LMAX * PAD;         // [LMAX][PAD] dnum[:, tile]
  float* Ps = dnm + LMAX * PAD;         // [LMAX][PAD] A * qk
  float* F = Ps + LMAX * PAD;           // [LMAX] each from here
  float* li = F + LMAX;
  float* mloc = li + LMAX;
  float* cint = mloc + LMAX;
  float* denom = cint + LMAX;
  float* dden = denom + LMAX;
  float* w = dden + LMAX;
  float* part = w + LMAX;               // [LMAX][4]
  float* part2 = part + 4 * LMAX;       // [LMAX][4]
  float* sc = part2 + 4 * LMAX;         // [4]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int vt = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t col = (int64_t)vt * TILE;
  const int nc = S / L;
  float carry = 0.f;                    // thread 0 of tile 0: sum of dF

  for (int i = tid; i < K * TILE; i += NT) dCs[i] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int64_t row0 = b * S + (int64_t)c * L;
    bwd_rows(h, dh, li_g, lf_g, mloc_g, den_g, mst[b * nc + c], row0, K,
             L, F, li, mloc, cint, denom, dden, w, part, sc);
    const float decay = sc[1];
    for (int i = tid; i < LMAX * TILE; i += NT) {
      const int t = i / TILE, j = i % TILE;
      dnm[t * PAD + j] =
          t < L ? to_f(dh[(row0 + t) * K + col + j]) / denom[t] : 0.f;
    }

    // over k in 64-wide slices: q k^T, k dC[:, tile] (as carried in),
    // then dC[slice, tile] += (cint q)^T dnum
    float aqk[4][4], adv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) aqk[i][j] = adv[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TILE) {
      __syncthreads();
      for (int i = tid; i < LMAX * TILE; i += NT) {
        const int t = i / TILE, kk = i % TILE;
        float a = 0.f, bb = 0.f;
        if (t < L) {
          a = to_f(q[(row0 + t) * K + k0 + kk]);
          bb = to_f(k[(row0 + t) * K + k0 + kk]);
        }
        qs[t * PAD + kk] = a;
        ks[t * PAD + kk] = bb;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TILE; ++kk) {
        float a[4], kr[4], bk[4], dc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = qs[(ty + 16 * i) * PAD + kk];
          kr[i] = ks[(ty + 16 * i) * PAD + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = ks[(tx + 16 * j) * PAD + kk];
          dc[j] = dCs[(k0 + kk) * TILE + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            aqk[i][j] = fmaf(a[i], bk[j], aqk[i][j]);
            adv[i][j] = fmaf(kr[i], dc[j], adv[i][j]);
          }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, cc = tx + 16 * j;
          float acc = 0.f;
          for (int t = 0; t < L; ++t)
            acc = fmaf(cint[t] * (qs[t * PAD + r] * scale),
                       dnm[t * PAD + cc], acc);
          float* dp = &dCs[(k0 + r) * TILE + cc];
          *dp = decay * *dp + acc;
        }
    }

    // dv = w * (k dC) + (A * qk)^T dnum
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = ty + 16 * i, s = tx + 16 * j;
        float p = 0.f;
        if (s <= t && t < L)
          p = expf(F[t] - F[s] + li[s] - mloc[t]) * (aqk[i][j] * scale);
        Ps[t * PAD + s] = p;
      }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = ty + 16 * i, cc = tx + 16 * j;
        float acc = 0.f;
        for (int t = 0; t < L; ++t)
          acc = fmaf(Ps[t * PAD + s], dnm[t * PAD + cc], acc);
        if (s < L) dv[(row0 + s) * K + col + cc] = w[s] * adv[i][j] + acc;
      }

    if (vt == 0) {    // the log gates, from the finished dq and dk
      const int t = tid / 4, p = tid % 4;
      float a1 = 0.f, a2 = 0.f;
      if (t < L)
        for (int j = p; j < K; j += 4) {
          const int64_t o = (row0 + t) * K + j;
          a1 = fmaf(to_f(q[o]), dq[o], a1);
          a2 = fmaf(to_f(k[o]), dk[o], a2);
        }
      part[t * 4 + p] = a1;
      part2[t * 4 + p] = a2;
      __syncthreads();
      if (tid == 0)
        for (int s = L - 1; s >= 0; --s) {
          const float qdq = ((part[4 * s] + part[4 * s + 1]) +
                             part[4 * s + 2]) + part[4 * s + 3];
          const float kdk = ((part2[4 * s] + part2[4 * s + 1]) +
                             part2[4 * s + 2]) + part2[4 * s + 3];
          dli[row0 + s] = kdk;
          carry += qdq - kdk;
          dlf[row0 + s] = carry;
        }
    }
  }
}

constexpr int kUnsupported = 100000;   // not a cudaError_t value

size_t fwd_smem(int K) {
  return sizeof(float) *
         ((size_t)K * TILE + K + 3 * LMAX * PAD + LMAX * TILE + 6 * LMAX + 4);
}
size_t dqdk_smem(int K) {
  return sizeof(float) * ((size_t)TILE * (K + 1) + 3 * LMAX * PAD +
                          TILE * PAD + 2 * TILE + 11 * LMAX + 4);
}
size_t dv_smem(int K) {
  return sizeof(float) *
         ((size_t)K * TILE + 4 * LMAX * PAD + 15 * LMAX + 4);
}

template <typename Kern>
int set_smem(Kern kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* li,
        const void* lf, void* h, void* Cst, void* nst, void* mst,
        void* mloc, void* den, int BH, int S, int K, int L, float scale,
        cudaStream_t st) {
  const size_t smem = fwd_smem(K);
  if (int rc = set_smem(mlstm_fwd_kernel<T>, smem)) return rc;
  mlstm_fwd_kernel<T><<<dim3(K / TILE, BH), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)li,
      (const float*)lf, (T*)h, (float*)Cst, (float*)nst, (float*)mst,
      (float*)mloc, (float*)den, S, K, L, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dqdk(const void* q, const void* k, const void* v, const void* li,
             const void* lf, const void* h, const void* dh,
             const void* Cst, const void* nst, const void* mst,
             const void* mloc, const void* den, void* dq, void* dk, int BH,
             int S, int K, int L, float scale, cudaStream_t st) {
  const size_t smem = dqdk_smem(K);
  if (int rc = set_smem(mlstm_bwd_dqdk_kernel<T>, smem)) return rc;
  mlstm_bwd_dqdk_kernel<T><<<dim3(K / TILE, BH), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)li,
      (const float*)lf, (const T*)h, (const T*)dh, (const float*)Cst,
      (const float*)nst, (const float*)mst, (const float*)mloc,
      (const float*)den, (float*)dq, (float*)dk, S, K, L, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_dv(const void* q, const void* k, const void* li, const void* lf,
           const void* h, const void* dh, const void* mst,
           const void* mloc, const void* den, const void* dq,
           const void* dk, void* dv, void* dli, void* dlf, int BH, int S,
           int K, int L, float scale, cudaStream_t st) {
  const size_t smem = dv_smem(K);
  if (int rc = set_smem(mlstm_bwd_dv_kernel<T>, smem)) return rc;
  mlstm_bwd_dv_kernel<T><<<dim3(K / TILE, BH), NT, smem, st>>>(
      (const T*)q, (const T*)k, (const float*)li, (const float*)lf,
      (const T*)h, (const T*)dh, (const float*)mst, (const float*)mloc,
      (const float*)den, (const float*)dq, (const float*)dk, (float*)dv,
      (float*)dli, (float*)dlf, S, K, L, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int bh, int s, int kd, int chunk, int dtype) {
  return bh > 0 && bh <= 65535 && s > 0 && kd > 0 && kd % TILE == 0 &&
         kd <= 512 && chunk >= 1 && chunk <= LMAX && s % chunk == 0 &&
         (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched), or
// 100000 for a shape or dtype (0 = float32, 1 = bfloat16 for q, k, v, h
// and dh) the kernels do not take. The aux pointers of mlstm_fwd (C, n,
// m states, m_loc, den) may all be null: then only h is written.
int mlstm_fwd(const void* q, const void* k, const void* v, const void* li,
              const void* lf, void* h, void* Cst, void* nst, void* mst,
              void* mloc, void* den, int bh, int s, int kd, int chunk,
              int dtype, float scale, void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype)) return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd<float>(q, k, v, li, lf, h, Cst, nst, mst, mloc, den, bh, s,
                      kd, chunk, scale, st);
  return fwd<__nv_bfloat16>(q, k, v, li, lf, h, Cst, nst, mst, mloc, den,
                            bh, s, kd, chunk, scale, st);
}

int mlstm_bwd_dqdk(const void* q, const void* k, const void* v,
                   const void* li, const void* lf, const void* h,
                   const void* dh, const void* Cst, const void* nst,
                   const void* mst, const void* mloc, const void* den,
                   void* dq, void* dk, int bh, int s, int kd, int chunk,
                   int dtype, float scale, void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype)) return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dqdk<float>(q, k, v, li, lf, h, dh, Cst, nst, mst, mloc,
                           den, dq, dk, bh, s, kd, chunk, scale, st);
  return bwd_dqdk<__nv_bfloat16>(q, k, v, li, lf, h, dh, Cst, nst, mst,
                                 mloc, den, dq, dk, bh, s, kd, chunk, scale,
                                 st);
}

int mlstm_bwd_dv(const void* q, const void* k, const void* li,
                 const void* lf, const void* h, const void* dh,
                 const void* mst, const void* mloc, const void* den,
                 const void* dq, const void* dk, void* dv, void* dli,
                 void* dlf, int bh, int s, int kd, int chunk, int dtype,
                 float scale, void* stream) {
  if (!shape_ok(bh, s, kd, chunk, dtype)) return kUnsupported;
  auto st = (cudaStream_t)stream;
  if (dtype == 0)
    return bwd_dv<float>(q, k, li, lf, h, dh, mst, mloc, den, dq, dk, dv,
                         dli, dlf, bh, s, kd, chunk, scale, st);
  return bwd_dv<__nv_bfloat16>(q, k, li, lf, h, dh, mst, mloc, den, dq, dk,
                               dv, dli, dlf, bh, s, kd, chunk, scale, st);
}

}  // extern "C"
