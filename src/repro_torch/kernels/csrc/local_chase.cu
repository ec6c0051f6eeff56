// local_chase: batched Wyllie pointer doubling with self-absorbing stops,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/local_chase/kernel.py
// (_chase_kernel / local_chase_pallas). For each of B independent rows of
// m local indices, `steps` times:
//
//     d <- d + d[s];  s <- s[s]      (both read the OLD s and d)
//
// What bounds it: device-memory bytes and gather latency. Each step reads
// s[i], d[i] (coalesced), gathers s[s[i]], d[s[i]] (random within the
// row) and writes the new s, d: about 24 bytes per element per step, and
// each random 4-byte gather costs a whole 32-byte sector. The TPU design
// keeps one row resident in VMEM for all steps; at the main path's shape
// (m = 2^20, 8 MB per row) a row is far beyond the 227 KB of shared
// memory one block can hold, so here every step is one grid-wide launch
// over the flattened (B, m) grid, ping-ponging between two buffer pairs
// in device memory. The kernel boundary is the barrier between steps.
// The 50 MB L2 holds a good part of the 128 MB working set at the main
// path's size, which softens the random gathers.
//
// Exactness: one add per element per step in a fixed order. int32 adds
// wrap (done in uint32, as jax's int32 adds do); float32 adds use
// __fadd_rn, which the compiler never contracts or reassociates. So the
// result is bit-equal to the plain torch version.
#include <cuda_runtime.h>
#include <cstdint>

__device__ __forceinline__ int32_t add_exact(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ float add_exact(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void chase_step_kernel(const int32_t* __restrict__ s_in,
                                  const T* __restrict__ d_in,
                                  int32_t* __restrict__ s_out,
                                  T* __restrict__ d_out, int64_t m,
                                  int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    int32_t s = s_in[i];
    // indices outside [0, m) are a caller error; clamp so they cannot fault
    s = s < 0 ? 0 : (s >= m ? (int32_t)(m - 1) : s);
    const int64_t j = i - (i % m) + s;
    s_out[i] = s_in[j];
    d_out[i] = add_exact(d_in[i], d_in[j]);
  }
}

template <typename T>
static int run_steps(const void* succ, const void* dist, long long b,
                     long long m, int steps, void* out_s, void* out_d,
                     void* tmp_s, void* tmp_d, cudaStream_t st) {
  const long long total = b * m;
  if (steps == 0 || total == 0) {
    cudaError_t err = cudaMemcpyAsync(out_s, succ, total * 4,
                                      cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemcpyAsync(out_d, dist, total * sizeof(T),
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  const int32_t* src_s = static_cast<const int32_t*>(succ);
  const T* src_d = static_cast<const T*>(dist);
  for (int k = 0; k < steps; ++k) {
    // the last step writes the output pair
    const bool to_out = ((steps - 1 - k) % 2) == 0;
    int32_t* dst_s = static_cast<int32_t*>(to_out ? out_s : tmp_s);
    T* dst_d = static_cast<T*>(to_out ? out_d : tmp_d);
    chase_step_kernel<T><<<(unsigned)blocks, threads, 0, st>>>(
        src_s, src_d, dst_s, dst_d, m, total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src_s = dst_s;
    src_d = dst_d;
  }
  return (int)cudaSuccess;
}

// dtype_code: 0 = int32 weights, 1 = float32 weights.
extern "C" int local_chase_launch(const void* succ, const void* dist,
                                  int dtype_code, long long b, long long m,
                                  int steps, void* out_s, void* out_d,
                                  void* tmp_s, void* tmp_d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (b < 0 || m < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  if (dtype_code == 0)
    return run_steps<int32_t>(succ, dist, b, m, steps, out_s, out_d, tmp_s,
                              tmp_d, st);
  if (dtype_code == 1)
    return run_steps<float>(succ, dist, b, m, steps, out_s, out_d, tmp_s,
                            tmp_d, st);
  return (int)cudaErrorInvalidValue;
}
