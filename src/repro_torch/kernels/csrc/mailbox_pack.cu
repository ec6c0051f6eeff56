// mailbox_pack: fused wire pack + mailbox bucket fill for Hopper (sm_90a),
// written as a gather over the send buffer's cells.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mailbox_pack/kernel.py
// (_pack_kernel / mailbox_pack_pallas), which walks the messages one at a
// time and scatters each into its mailbox cell. Here the exchange's bucket
// sort (exchange._bucket_indices) hands over its sorted keys `skey` and
// permutation `order`: the messages bound for bucket b are one contiguous
// run of `order`, starting at start_b = (first i with skey[i] >= b), and
// the mailbox cell (b, c) holds run element c while c < min(run_b, cap).
// Invalid messages sort last under the key n_buckets, so a shipping
// message is always valid. For every virtual PE `pe`, bucket b < n_buckets
// and cell c < cap, at column r = b * cap + c of the (p, W, n_rows) buffer:
//
//     out[pe, w, r]     = cols[w][pe, order[pe, start_b + c]]   (w < W-1)
//     out[pe, W - 1, r] = 1                 if c < min(run_b, cap)
//     out[pe, w, r]     = 0                 for every w otherwise
//
// What bounds it: bytes. The buffer is written once (4 * p * W * n_rows
// bytes) and each shipping message's W - 1 payload words and its 8-byte
// index are read once. A scatter in input order after a memset would
// make every write a partial sector, and would need the exchange to
// unpermute the slots and cast the validity plane first. Here one block
// owns a tile of kTile (1024) consecutive cells of one (PE, bucket): it
// finds the bucket's run with two warps doing 32-ary searches of `skey`
// (about four dependent loads each at Q = 196 800), then every thread
// writes its cells' words coalesced, zeros included. The only scattered
// accesses left are the payload gathers through `order`, which go through
// the read-only path; within a bucket the stable sort keeps `order`
// increasing, so they walk each plane forwards. Offsets inside one PE's
// planes are 32-bit (the wrapper keeps them below 2^31); only a PE's base
// is 64-bit.
// The payload planes are taken as separate pointers (passed by value), so
// the bit-cast views of the payload leaves need no stacking copy.
#include <cuda_runtime.h>
#include <cstdint>

#define MAILBOX_PACK_MAX_COLS 16

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 4;
constexpr int kTile = kThreads * kCellsPerThread;

struct Planes {
  const int32_t* ptr[MAILBOX_PACK_MAX_COLS];
};

// First index i of the ascending skey[0, q) with skey[i] >= key, found by
// one whole warp: each round the 32 lanes probe 32 evenly spaced points of
// the open interval and keep the gap where the predicate flips.
__device__ __forceinline__ int warp_lower_bound(const int32_t* __restrict__ skey,
                                                int q, int key) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned lo = 0, hi = (unsigned)q;  // skey[< lo] < key <= skey[>= hi]
  while (lo < hi) {
    const unsigned step = (hi - lo + 31u) >> 5;
    const unsigned pos = lo + (lane + 1u) * step - 1u;
    const bool below = pos < hi && __ldg(skey + pos) < key;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const unsigned first_not = lo + (unsigned)(c + 1) * step - 1u;
    if (c < 32 && first_not < hi) hi = first_not;
    lo += (unsigned)c * step;
  }
  return (int)lo;
}

// N payload planes, a compile-time count: the pointer table is indexed
// with constants only (a runtime index would copy it to local memory),
// and every gather of a thread is issued before its first store.
template <int N>
__global__ void __launch_bounds__(kThreads)
    mailbox_pack_kernel(Planes planes, const int64_t* __restrict__ order,
                        const int32_t* __restrict__ skey, int q,
                        int n_buckets, int cap, int tiles_per_bucket,
                        int32_t* __restrict__ out) {
  const int pe = blockIdx.y;
  const int bucket = blockIdx.x / tiles_per_bucket;
  const int c0 = (blockIdx.x - bucket * tiles_per_bucket) * kTile;
  __shared__ int bounds[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int at = warp_lower_bound(skey + (size_t)pe * q, q, bucket + warp);
    if ((threadIdx.x & 31) == 0) bounds[warp] = at;
  }
  __syncthreads();
  const int start = bounds[0];
  const int fill = min(bounds[1] - start, cap);
  const int64_t* run = order + (size_t)pe * q + start;
  const int n_rows = n_buckets * cap;
  int32_t* dst = out + (size_t)pe * (size_t)(N + 1) * n_rows +
                 (size_t)bucket * cap;

  int cell[kCellsPerThread], src[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    cell[k] = c0 + k * kThreads + (int)threadIdx.x;
    src[k] = cell[k] < fill ? (int)__ldg(run + cell[k]) : -1;
  }
  int32_t v[N > 0 ? N : 1][kCellsPerThread];
#pragma unroll
  for (int w = 0; w < N; ++w) {
    const int32_t* plane = planes.ptr[w] + (size_t)pe * q;
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k)
      v[w][k] = src[k] >= 0 ? __ldg(plane + src[k]) : 0;
  }
#pragma unroll
  for (int w = 0; w < N; ++w)
#pragma unroll
    for (int k = 0; k < kCellsPerThread; ++k)
      if (cell[k] < cap) dst[w * n_rows + cell[k]] = v[w][k];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k)
    if (cell[k] < cap) dst[N * n_rows + cell[k]] = src[k] >= 0;
}

using Kernel = void (*)(Planes, const int64_t*, const int32_t*, int, int, int,
                        int, int32_t*);
const Kernel kKernels[MAILBOX_PACK_MAX_COLS] = {
    mailbox_pack_kernel<0>,  mailbox_pack_kernel<1>,  mailbox_pack_kernel<2>,
    mailbox_pack_kernel<3>,  mailbox_pack_kernel<4>,  mailbox_pack_kernel<5>,
    mailbox_pack_kernel<6>,  mailbox_pack_kernel<7>,  mailbox_pack_kernel<8>,
    mailbox_pack_kernel<9>,  mailbox_pack_kernel<10>, mailbox_pack_kernel<11>,
    mailbox_pack_kernel<12>, mailbox_pack_kernel<13>, mailbox_pack_kernel<14>,
    mailbox_pack_kernel<15>};

}  // namespace

// cols: n_payload (p, q) int32 payload planes; order: (p, q) int64 sort
// permutation; skey: (p, q) int32 sorted keys (n_buckets for rows that
// never ship); out: (p, n_payload + 1, n_buckets * cap) int32, written
// whole. The caller skips the launch when the buffer is empty and keeps
// p <= 65535 and (n_payload + 1) * n_buckets * cap, q below 2^31.
extern "C" int mailbox_pack_launch(const void* const* cols, int n_payload,
                                   const void* order, const void* skey,
                                   int p, int q, int n_buckets, int cap,
                                   void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_payload < 0 || n_payload + 1 > MAILBOX_PACK_MAX_COLS || p < 1 ||
      p > 65535 || q < 0 || n_buckets < 1 || cap < 1)
    return (int)cudaErrorInvalidValue;
  Planes planes = {};
  for (int w = 0; w < n_payload; ++w)
    planes.ptr[w] = static_cast<const int32_t*>(cols[w]);
  const int tiles = (cap + kTile - 1) / kTile;
  const long long blocks_x = (long long)n_buckets * tiles;
  if (blocks_x >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kKernels[n_payload]<<<dim3((unsigned)blocks_x, (unsigned)p), kThreads, 0,
                        st>>>(planes, static_cast<const int64_t*>(order),
                              static_cast<const int32_t*>(skey), q, n_buckets,
                              cap, tiles, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
