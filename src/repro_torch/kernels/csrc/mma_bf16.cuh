// Warp-level tensor-core building blocks for Hopper (sm_90a), shared by the
// bf16 kernels of flash_attention.cu and ssd_scan.cu:
//
// - mma_bf16: mma.sync.m16n8k16, bf16 A (16 x 16, row-major) times bf16 B
//   (16 x 8, column-major) into a float32 16 x 8 accumulator. Fragment
//   layouts (lane = threadIdx.x % 32, r = lane / 4, c = 2 * (lane % 4)):
//     C/D: c[0], c[1] at (r, c), (r, c + 1); c[2], c[3] at (r + 8, ...)
//     A:   a[0] (r, c..c+1), a[1] (r + 8, c..), a[2] (r, c + 8..),
//          a[3] (r + 8, c + 8..), two bf16 per register, lower k first
//     B:   b[0] (k = c..c+1, n = r), b[1] (k = c + 8.., n = r)
//   so an accumulator's registers, rounded to bf16 in pairs, are the A
//   fragment of the next product (the FlashAttention-2 register reuse);
// - ldmatrix_x4 / ldmatrix_x4_trans: four 8 x 8 bf16 matrices from shared
//   memory, each lane giving one 16-byte row address;
// - cp_async16 / cp_async4: a 16- or 4-byte global -> shared copy that
//   zero-fills when src_bytes is 0 (ragged edges), with commit / wait.
//
// Row strides of the shared tiles are padded by 8 elements (16 bytes), so
// the eight row addresses of one ldmatrix matrix fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b for one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// a 4-byte copy (cp.async.ca), zero-filling when src_bytes is 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
