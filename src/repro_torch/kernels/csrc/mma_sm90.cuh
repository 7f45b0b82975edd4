// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by
// the kernels that run on mma.sync: flash_attention.cu (the attention
// backward) and moe_gmm.cu (the grouped matmul's forward and input
// gradient).
//
//  - cp.async copies from device memory into shared memory, 16 or 4
//    bytes a thread, zero-filled where the source is out of range;
//  - ldmatrix (plain and transposed) reads of 8 x 16-byte rows;
//  - fragments of one m16n8 product: bf16 m16n8k16, and f32 as 3xTF32
//    m16n8k8, each operand split into a TF32 big and small part.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory, or 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* s, const void* g, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes from device memory into shared memory, or 4 zero bytes.
__device__ __forceinline__ void cp_async4(void* s, const void* g, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(s)),
               "l"(g), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Fragments of one warp-level product: A is 16 x k, B k x 8, with k = 16
// (bf16, m16n8k16) or 8 (TF32, m16n8k8; held as big and small parts).
template <typename T> struct FragA;
template <> struct FragA<__nv_bfloat16> { uint32_t x[4]; };
template <> struct FragA<float> { uint32_t hi[4], lo[4]; };
template <typename T> struct FragB;
template <> struct FragB<__nv_bfloat16> { uint32_t x[2]; };
template <> struct FragB<float> { uint32_t hi[2], lo[2]; };

// x = big + small: big = tf32(x) rounded to nearest, small = x - big
// exactly in f32 (|small| <= 2^-11 |x|), which the tensor cores read to
// TF32 precision by dropping its low 13 bits, an error of at most 2^-21
// |x| in a product's small term.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA<float> frag_a_tf32(float a0, float a1,
                                                    float a2, float a3) {
  FragA<float> f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

// A fragment as ldmatrix.x4 leaves it (16 rows x 32 bytes).
template <typename T> __device__ __forceinline__ FragA<T> frag_a_raw(
    const uint32_t (&r)[4]);
template <> __device__ __forceinline__ FragA<__nv_bfloat16>
frag_a_raw<__nv_bfloat16>(const uint32_t (&r)[4]) {
  return {{r[0], r[1], r[2], r[3]}};
}
template <> __device__ __forceinline__ FragA<float> frag_a_raw<float>(
    const uint32_t (&r)[4]) {
  return frag_a_tf32(__uint_as_float(r[0]), __uint_as_float(r[1]),
                     __uint_as_float(r[2]), __uint_as_float(r[3]));
}

template <typename T> __device__ __forceinline__ FragB<T> frag_b_raw(
    uint32_t b0, uint32_t b1);
template <> __device__ __forceinline__ FragB<__nv_bfloat16>
frag_b_raw<__nv_bfloat16>(uint32_t b0, uint32_t b1) {
  return {{b0, b1}};
}
template <> __device__ __forceinline__ FragB<float> frag_b_raw<float>(
    uint32_t b0, uint32_t b1) {
  FragB<float> f;
  split_tf32(__uint_as_float(b0), f.hi[0], f.lo[0]);
  split_tf32(__uint_as_float(b1), f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_op(float (&c)[4],
                                       const FragA<__nv_bfloat16>& a,
                                       const FragB<__nv_bfloat16>& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b.x[0]),
        "r"(b.x[1]));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: the small cross terms first, then big * big.
__device__ __forceinline__ void mma_op(float (&c)[4], const FragA<float>& a,
                                       const FragB<float>& b) {
  mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.lo, b.hi);
  mma_tf32(c, a.hi, b.hi);
}

// Two adjacent f32 values of an accumulator row, stored in T.
template <typename T> __device__ __forceinline__ void store2(T* p, float a,
                                                            float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a,
                                                          float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace
