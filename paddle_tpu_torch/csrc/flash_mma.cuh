// Tensor-core building blocks of the bf16 flash-attention kernels for
// Hopper (sm_90a): 16-byte cp.async with zero-fill, ldmatrix, the warp-level
// mma.sync m16n8k16 bf16 product with f32 accumulation, the conversion of an
// f32 accumulator fragment into a bf16 A-operand fragment, and the quad
// reductions of a row held by four threads.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4):
//   A 16x16 (row-major), 4 registers of two bf16: a0 = (g, 2t..2t+1),
//     a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..);
//   B 16x8 (k x n), 2 registers: b0 = (k 2t..2t+1, n g), b1 = (k 2t+8.., n g);
//   C/D 16x8 f32, 4 floats: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// So the C fragments of two neighbouring n-tiles are, rounded to bf16, the A
// fragment of one 16-wide k-chunk (acc_to_a): the FlashAttention-2 register
// trick that keeps P and dS out of shared memory.
//
// Shared-memory tiles are bf16 [rows][DP + 8]: DP is the head dim rounded up
// to 16 (columns past dh are zero-filled), and the 8-element (16-byte) pad
// spreads the eight 16-byte rows an ldmatrix reads over all 32 banks.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fa_mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with pred false the 16 bytes
// are zero-filled and nothing is read (src-size 0)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled with pred false (the f32 row stats,
// whose rows need not be 16-byte aligned)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i receives matrix i in the A/B fragment layout
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed: rows of k (keys or queries) in shared
// memory become the k pairs of a B fragment
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a b, 16x8x16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the C fragments of n-tiles 2kk and 2kk+1 as the A fragment of k-chunk kk
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// a row of a C fragment lives in the four lanes of a quad
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issue the copies of rows [r0, r0 + ROWS) of one head (token stride `st`
// elements, dh columns) into s[ROWS][DP + 8]: rows at or past t_len and
// columns at or past dh are zero-filled.  Every thread of the block calls it.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* x, long long st, int r0,
                                          int t_len, int dh) {
  constexpr int CH = DP / 8;  // 16-byte chunks per row
  constexpr int LD = DP + 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const int p = r0 + r;
    const bool ok = p < t_len && c * 8 < dh;
    cp_async_16(s + r * LD + c * 8, ok ? x + p * st + c * 8 : x, ok);
  }
}

// Write a warp's 16 rows, staged in s (row stride DP + 8), to rows
// [r0, r0 + 16) of a dense [.., H, dh] output (row stride `st` elements) in
// 16-byte stores; rows at or past t_len are not written.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long st, const bf16* s, int r0,
                                           int t_len, int dh) {
  constexpr int CH = DP / 8;
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    if (r0 + r < t_len && c * 8 < dh)
      *reinterpret_cast<uint4*>(out + (r0 + r) * st + c * 8) =
          *reinterpret_cast<const uint4*>(s + r * LD + c * 8);
  }
}

// Stage a warp's 16 x DP f32 accumulator (DP / 8 C fragments), scaled by
// `mul` per row half, as bf16 rows of s (row stride DP + 8).
template <int DP>
__device__ __forceinline__ void stage_acc(bf16* s, const float (&acc)[DP / 8][4], float mul0,
                                          float mul1) {
  constexpr int LD = DP + 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    *reinterpret_cast<uint32_t*>(s + g * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<uint32_t*>(s + (g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

}  // namespace fa_mma
