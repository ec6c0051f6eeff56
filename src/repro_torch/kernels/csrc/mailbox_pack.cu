// mailbox_pack: fused wire pack + mailbox bucket scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mailbox_pack/kernel.py
// (_pack_kernel / mailbox_pack_pallas). For every virtual PE `pe` and
// message `i` of a routing hop:
//
//     out[pe, w, slots[pe, i]] = cols[w][pe, i]   if 0 <= slots[pe, i] < n_rows
//     out[pe, w, r]            = 0                everywhere else
//
// What bounds it: bytes. It moves 4*p*(W*n_rows + (W+1)*Q) bytes and does
// no arithmetic. The Pallas kernel walked the messages one at a time with
// the whole buffer resident in VMEM; here the exchange's bucket sort gives
// every shipping message its own mailbox cell (exchange._bucket_indices),
// so the scatter has no conflicts and runs fully parallel: one thread per
// (PE, message), each writing its W words. The zero fill is one
// cudaMemsetAsync at full memory rate. Reads of slots and word-planes are
// coalesced; the writes land at scattered cells (bucket-sorted slots of a
// random message order), which is what keeps it above the byte bound.
// The word-planes are taken as W separate pointers (passed by value), so
// the bit-cast views of the payload leaves need no stacking copy.
#include <cuda_runtime.h>
#include <cstdint>

#define MAILBOX_PACK_MAX_COLS 16

struct Planes {
  const int32_t* ptr[MAILBOX_PACK_MAX_COLS];
};

__global__ void mailbox_pack_kernel(Planes planes, int n_cols,
                                    const int32_t* __restrict__ slots,
                                    int64_t q, int64_t total, int64_t n_rows,
                                    int32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int32_t f = slots[i];
    if (f < 0 || (int64_t)f >= n_rows) continue;  // does not ship this hop
    const int64_t pe = i / q;
    int32_t* cell = out + pe * n_cols * n_rows + f;
    for (int w = 0; w < n_cols; ++w) cell[w * n_rows] = planes.ptr[w][i];
  }
}

extern "C" int mailbox_pack_launch(const void* const* cols, int n_cols,
                                   const void* slots, long long p, long long q,
                                   long long n_rows, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_cols < 1 || n_cols > MAILBOX_PACK_MAX_COLS || p < 0 || q < 0 ||
      n_rows < 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)p * (size_t)n_cols * (size_t)n_rows * 4;
  cudaError_t err = cudaMemsetAsync(out, 0, bytes, st);
  if (err != cudaSuccess) return (int)err;
  const long long total = p * q;
  if (total > 0) {
    Planes planes;
    for (int w = 0; w < n_cols; ++w)
      planes.ptr[w] = static_cast<const int32_t*>(cols[w]);
    const int threads = 256;
    long long blocks = (total + threads - 1) / threads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
    mailbox_pack_kernel<<<(unsigned)blocks, threads, 0, st>>>(
        planes, n_cols, static_cast<const int32_t*>(slots), q, total, n_rows,
        static_cast<int32_t*>(out));
  }
  return (int)cudaGetLastError();
}
