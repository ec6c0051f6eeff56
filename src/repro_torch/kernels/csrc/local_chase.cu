// local_chase: batched Wyllie pointer doubling with self-absorbing stops,
// for Hopper (sm_90a): one persistent cooperative launch per call that
// stops at the doubling's fixed point.
//
// Replaces the Pallas TPU kernel src/repro/kernels/local_chase/kernel.py
// (_chase_kernel / local_chase_pallas). For each of B independent rows of
// m local indices, up to `steps` times:
//
//     d <- d + d[s];  s <- s[s]      (both read the OLD s and d)
//
// What bounds it: device-memory bytes and gather latency. Each step reads
// s[i], d[i] (coalesced), gathers s[s[i]], d[s[i]] (random within the
// row) and writes the new s, d. The TPU design keeps one row resident in
// VMEM for all steps; a row of the main path (m = 2^20, 8 MB of s and d)
// is far beyond the 227 KB of shared memory one block can hold, but two
// such rows in both ping-pong buffers fit the 50 MB L2. So:
//
// - One cooperative launch runs every step: the grid is as many blocks as
//   are co-resident (occupancy x SMs) and grid.sync() is the barrier
//   between steps, so a call costs one launch whatever its step count.
// - Rows are walked in groups of `group_rows` (the wrapper sizes a group
//   so that its two buffer pairs fit in L2): after the first step reads
//   a group's input from device memory, its later steps hit L2.
// - Fixed-point exit. A step is a deterministic function of the state
//   (s, d), so once a step leaves every bit of a group's state as it was,
//   every later step would too: the group stops there, with the same bits
//   as running all `steps`. The test is on bits (__float_as_int), never
//   `==`, which calls -0.0 equal to +0.0 and a NaN unequal to itself; and
//   it is on the whole state, since "every successor is a stop" is not
//   enough (a self-loop with weight x doubles every step). The main
//   path's List(2^24, gamma=1) reaches its fixed point on the 4th of its
//   20 steps.
// - The "changed" flag of a group is one int in `ctrl`, zeroed by the
//   wrapper. Each block reduces its threads' flags (__syncthreads_or) and
//   raises the group's flag with one atomicMax to k + 1 at step k. The
//   flag only grows, so it is never reset, and nothing races a reset:
//   after grid.sync(), the flag is > k exactly when step k changed
//   something (a block can raise it to k + 2 only after reading it > k).
//   Each group has its own flag, so a fast block that moved on to the
//   next group cannot disturb a slow block still reading this one's.
// - Ping-pong: step k writes the output pair when (steps - 1 - k) is
//   even, so a group that runs all its steps ends in the output pair.
//   One that stops at an unchanged step k >= 1 has equal bits in both
//   pairs. Only a stop at step 0 that wrote the scratch pair needs a copy
//   into the output pair.
//
// Exactness: one add per element per step in a fixed order. int32 adds
// wrap (done in uint32, as jax's int32 adds do); float32 adds use
// __fadd_rn, which the compiler never contracts or reassociates. So the
// result is bit-equal to the plain torch version.
//
// Buffers written during the launch are read with plain loads (never the
// non-coherent read-only path): grid.sync() orders them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ int32_t add_exact(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ float add_exact(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ int32_t bits(int32_t x) { return x; }
__device__ __forceinline__ int32_t bits(float x) { return __float_as_int(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    chase_persistent_kernel(const int32_t* in_s, const T* in_d, int32_t* out_s,
                            T* out_d, int32_t* tmp_s, T* tmp_d, int b, int m,
                            int steps, int group_rows, int* ctrl) {
  cg::grid_group grid = cg::this_grid();
  const int n_groups = (b + group_rows - 1) / group_rows;
  int* steps_run = ctrl + n_groups;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned um = (unsigned)m;
  // element e of a group sits in row e / m at column e % m; both advance
  // by a constant per grid-stride step, so no division in the loop
  const unsigned row0 = tid / um, col0 = tid % um;
  const unsigned drow = stride / um, dcol = stride % um;

  for (int g = 0; g < n_groups; ++g) {
    const int r0 = g * group_rows;
    const int rows = min(group_rows, b - r0);
    const unsigned n = (unsigned)rows * um;
    const size_t off = (size_t)r0 * (size_t)m;
    int* flag = ctrl + g;
    const int32_t* src_s = in_s + off;
    const T* src_d = in_d + off;
    int k = 0;
    for (;;) {
      const bool to_out = ((steps - 1 - k) & 1) == 0;
      int32_t* dst_s = (to_out ? out_s : tmp_s) + off;
      T* dst_d = (to_out ? out_d : tmp_d) + off;
      bool changed = false;
      unsigned row = row0, col = col0;
      for (unsigned e = tid; e < n; e += stride) {
        const int32_t s = src_s[e];
        // indices outside [0, m) are a caller error; clamp so they
        // cannot fault
        const unsigned sc = (unsigned)min(max(s, 0), m - 1);
        const unsigned j = row * um + sc;
        const int32_t ns = src_s[j];
        const T d = src_d[e];
        const T nd = add_exact(d, src_d[j]);
        dst_s[e] = ns;
        dst_d[e] = nd;
        changed |= (ns != s) | (bits(nd) != bits(d));
        col += dcol;
        row += drow;
        if (col >= um) {
          col -= um;
          ++row;
        }
      }
      if (__syncthreads_or(changed) && threadIdx.x == 0) atomicMax(flag, k + 1);
      grid.sync();
      const bool again = *(volatile int*)flag > k;
      ++k;
      src_s = dst_s;
      src_d = dst_d;
      if (!again || k == steps) break;
    }
    if (k == 1 && ((steps - 1) & 1)) {
      // stopped at step 0, which wrote the scratch pair
      for (unsigned e = tid; e < n; e += stride) {
        out_s[off + e] = src_s[e];
        out_d[off + e] = src_d[e];
      }
    }
    if (tid == 0)
      for (int r = 0; r < rows; ++r) steps_run[r0 + r] = k;
  }
}

template <typename T>
int launch(const void* succ, const void* dist, int b, int m, int steps,
           int group_rows, void* out_s, void* out_d, void* tmp_s, void* tmp_d,
           void* ctrl, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, chase_persistent_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // co-resident blocks, but no more than the largest group has elements
  const long long elems = (long long)(group_rows < b ? group_rows : b) * m;
  long long blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  const int32_t* in_s = static_cast<const int32_t*>(succ);
  const T* in_d = static_cast<const T*>(dist);
  int32_t* os = static_cast<int32_t*>(out_s);
  T* od = static_cast<T*>(out_d);
  int32_t* ts = static_cast<int32_t*>(tmp_s);
  T* td = static_cast<T*>(tmp_d);
  int* c = static_cast<int*>(ctrl);
  void* args[] = {&in_s, &in_d, &os, &od, &ts, &td, &b, &m, &steps,
                  &group_rows, &c};
  err = cudaLaunchCooperativeKernel((const void*)chase_persistent_kernel<T>,
                                    dim3((unsigned)blocks), dim3(kThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: 0 = int32 weights, 1 = float32 weights. `ctrl` holds
// ceil(b / group_rows) zeroed flags, then b ints that receive the steps
// each row's group ran. The caller handles steps == 0 and empty inputs
// (no launch) and keeps b * m and group_rows * m below 2^31.
extern "C" int local_chase_launch(const void* succ, const void* dist,
                                  int dtype_code, int b, int m, int steps,
                                  int group_rows, void* out_s, void* out_d,
                                  void* tmp_s, void* tmp_d, void* ctrl,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (b < 1 || m < 1 || steps < 1 || group_rows < 1 ||
      (long long)group_rows * m >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return launch<int32_t>(succ, dist, b, m, steps, group_rows, out_s, out_d,
                           tmp_s, tmp_d, ctrl, st);
  if (dtype_code == 1)
    return launch<float>(succ, dist, b, m, steps, group_rows, out_s, out_d,
                         tmp_s, tmp_d, ctrl, st);
  return (int)cudaErrorInvalidValue;
}
