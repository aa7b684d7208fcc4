// Tensor-core building blocks of the port's bfloat16 kernels (sm_90a):
// warp-level mma.sync m16n8k16 (bf16 operands, float32 sums), ldmatrix
// loads of its fragments from shared memory, and cp.async copies from
// device memory into shared memory; prod16, one 16-deep step of a product
// in the fragment layout, on the tensor cores for bf16 and as float32 FMA
// for float, so that one kernel body serves both storage types.
//
// Fragments of one m16n8k16 product D = A B + C, A (16 x 16), B (16 x 8),
// lane l of the warp, g = l / 4, t = l % 4 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"):
//   A: a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..],
//      a[3] = A[g+8][2t+8..]
//   B: b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g]
//   C: c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// Each 32-bit register holds two bf16, the lower index in the low half.
//
// Shared-memory tiles are row-major bf16 with a row stride `ld` (elements)
// whose byte size is 16 mod 128, so that the 8 rows an ldmatrix reads at
// once fall in 8 different 16-byte bank groups.  The loaders name the
// stored layout: load_a for A stored (M, K), load_a_t for A stored (K, M)
// (the transpose: the product of X^T), load_b for B stored (N, K), load_b_t
// for B stored (K, N); the x4 B loaders fill two neighbouring n-tiles of 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory; with !valid the 16 bytes
// are zero-filled and nothing is read (src may then be any address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// 4 bytes, zero-filled with !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a b on the tensor cores, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows m0.., columns k0.. of A stored (M, K).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8);
}

// The A fragment of rows m0.., columns k0.. of A = S^T, S stored (K, M).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* s, int ld, int m0,
                                         int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(a, s + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 + ((l >> 3) & 1) * 8);
}

// B fragments of columns n0.. and n0 + 8.. (b[0..1] and b[2..3]), rows
// k0.., of B = S^T, S stored (N, K).
__device__ __forceinline__ void load_b_x4(uint32_t (&b)[4], const bf16* s, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(b, s + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 + ((l >> 3) & 1) * 8);
}

// The same for one n-tile: b[0..1] of columns n0.., S stored (N, K).
__device__ __forceinline__ void load_b_x2(uint32_t (&b)[2], const bf16* s, int ld, int n0,
                                          int k0) {
  const int l = threadIdx.x & 15;  // lanes 16..31 give no address to an x2 load
  ldsm_x2(b, s + (n0 + (l & 7)) * ld + k0 + (l >> 3) * 8);
}

// B fragments of columns n0.. and n0 + 8.., rows k0.., of B stored (K, N).
__device__ __forceinline__ void load_b_t_x4(uint32_t (&b)[4], const bf16* s, int ld, int n0,
                                            int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4_t(b, s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 + (l >> 4) * 8);
}

// The same for one n-tile, B stored (K, N).
__device__ __forceinline__ void load_b_t_x2(uint32_t (&b)[2], const bf16* s, int ld, int n0,
                                            int k0) {
  const int l = threadIdx.x & 15;
  ldsm_x2_t(b, s + (k0 + (l & 7) + (l >> 3) * 8) * ld + n0);
}

// acc[j] += a B[k0.., n0 + 8 j..] for j < NJ (1 or even), B stored (K, N)
// (KN) or (N, K).
template <int NJ, bool KN>
__device__ __forceinline__ void mma_row(float (&acc)[NJ][4], const uint32_t (&a)[4],
                                        const bf16* s, int ld, int n0, int k0) {
  if constexpr (NJ == 1) {
    uint32_t b[2];
    if constexpr (KN) load_b_t_x2(b, s, ld, n0, k0);
    else load_b_x2(b, s, ld, n0, k0);
    mma(acc[0], a, b[0], b[1]);
  } else {
    static_assert(NJ % 2 == 0, "n-tiles in pairs");
#pragma unroll
    for (int np = 0; np < NJ / 2; ++np) {
      uint32_t b[4];
      if constexpr (KN) load_b_t_x4(b, s, ld, n0 + 16 * np, k0);
      else load_b_x4(b, s, ld, n0 + 16 * np, k0);
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Two neighbouring bf16 of device or shared memory as float32 (p 4-byte aligned).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack(*reinterpret_cast<const uint32_t*>(p));
}
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack(lo, hi);
}

// The same for the storage type of a kernel that runs in float32 or bf16.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const bf16* p) { return load2(p); }
__device__ __forceinline__ void st2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void st2(bf16* p, float lo, float hi) { store2(p, lo, hi); }

// acc[j] += A[m0.., k0..k0+16) B[k0.., n0 + 8 j..] for j < NJ, in the mma
// fragment layout: A stored (K, M) (AT) or (M, K), B stored (K, N) (KN) or
// (N, K), row strides lda, ldb.  bf16 (shared memory): on the tensor
// cores.  float (shared or device memory): float32 FMA, each thread
// summing over k in order the entries its fragment holds; the k loop is
// unrolled 4 deep, not 16 (the same sums in the same order; fully unrolled,
// the float32 instantiations made nvcc several times slower).
template <int NJ, bool AT, bool KN>
__device__ __forceinline__ void prod16(float (&acc)[NJ][4], const bf16* A, int lda, int m0,
                                       const bf16* B, int ldb, int n0, int k0) {
  uint32_t a[4];
  if constexpr (AT) load_a_t(a, A, lda, m0, k0);
  else load_a(a, A, lda, m0, k0);
  mma_row<NJ, KN>(acc, a, B, ldb, n0, k0);
}
template <int NJ, bool AT, bool KN>
__device__ __forceinline__ void prod16(float (&acc)[NJ][4], const float* A, int lda, int m0,
                                       const float* B, int ldb, int n0, int k0) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int am = AT ? 1 : lda, ak = AT ? lda : 1;  // element strides of A (m, k)
  const int bk = KN ? ldb : 1, bn = KN ? 1 : ldb;  // and of B (k, n)
  const float* a0 = A + (m0 + gq) * am + k0 * ak;
  const float* a1 = a0 + 8 * am;
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    const float x0 = a0[k * ak], x1 = a1[k * ak];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* b = B + (k0 + k) * bk + (n0 + 8 * j + 2 * tq) * bn;
      const float b0 = b[0], b1 = b[bn];
      acc[j][0] = fmaf(x0, b0, acc[j][0]);
      acc[j][1] = fmaf(x0, b1, acc[j][1]);
      acc[j][2] = fmaf(x1, b0, acc[j][2]);
      acc[j][3] = fmaf(x1, b1, acc[j][3]);
    }
  }
}

// Shared-memory row padding of a kernel's tiles in T: bf16 rows 16 mod 128
// bytes (ldmatrix bank groups), float32 rows 4 mod 32 floats (the FMA
// products' reads).
template <typename T>
__host__ __device__ constexpr int pad() { return sizeof(T) == 2 ? 8 : 4; }

// Sums over the lanes of a warp that hold one column (the 8 lanes of one
// t = lane % 4) or one row (the 4 lanes of one g = lane / 4) of an
// accumulator fragment.
__device__ __forceinline__ float sum_over_rows(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}
__device__ __forceinline__ float sum_over_cols(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace tc
