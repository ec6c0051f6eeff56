// flash_attention: blockwise forward attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel / flash_attention_pallas). For q (B, Hq, Lq, D) and k, v
// (B, Hkv, Lk, D), query head h reading kv head h / (Hq/Hkv), and query row
// i at absolute position q_pos = q_offset[b] + i:
//
//     s   = scale * q . k                       (float32)
//     s   = softcap * tanh(s / softcap)         (optional)
//     keep  k_pos < Lk, causal q_pos >= k_pos, window q_pos - k_pos < window
//     out = softmax over the kept keys of s, times v; 0 for a row with none
//
// with the online softmax of the Pallas kernel: running max m, sum l and
// accumulator acc in float32, masked logits NEG_INF (never -inf: exp of
// -inf - -inf is NaN) and their p forced to 0, output acc / (l > 0 ? l : 1).
//
// What bounds it: at the serving path's prefill (Lq = 1024 over a 2048-key
// cache) operations, 4 * D per unmasked (q, k) pair; at decode (Lq = 1)
// bytes, the unmasked K/V rows. This first design is simple and right:
//
// - one CTA per (q tile, kv head, batch). The Hq/Hkv query heads that share
//   a kv head are folded into the tile's rows (the GPU form of the Pallas
//   `h // group` index map), so every K/V tile staged in shared memory
//   serves all of them; a decode tile of tinyllama (group 8) has 8 rows;
// - K/V tiles of 64 keys staged through shared memory as float32 (16-byte
//   loads), K padded to a stride of D + 1 so the lanes of a warp, each
//   reading its own key, hit distinct banks;
// - eight warps, each owning up to eight interleaved rows; a lane scores
//   two keys per row, the row's max and sum are warp shuffles, and a lane
//   accumulates the output columns lane, lane + 32, ...;
// - every warp computes all its eight row slots, valid or not: per-row
//   guards that skip a decode tile's empty slots measured slower on the
//   H100 (branches cost more than the shared-memory loads they save;
//   tools/ab_flash_attention.py). The shared-memory loads of q and p,
//   one per FMA pair, are what bounds a tile;
// - float32 FMA on CUDA cores; KV tiles that the causal or window mask
//   blanks for every row of the tile are not visited (the result is the
//   same), and ragged edges are masked in place of the Pallas wrapper's
//   padding copies.
//
// Tensor cores (mma.sync / wgmma), TMA, a K/V pipeline and split-K decode
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                 // rows (q position x head) a tile
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 64;                 // keys a K/V tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int32_t* q_offset;  // (B,) or null: then q_offset_scalar
  int q_offset_scalar;
  int b, hq, hkv, lq, lk;
  int causal;
  int window;  // < 0: none
  int use_softcap;
  float softcap;
  float scale;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    out[2 * u] = f.x;
    out[2 * u + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q tile, K tile (padded), V tile, per-warp probabilities
  return sizeof(float) *
         (kRows * D + kKeys * (D + 1) + kKeys * D + kWarps * kRowsPerWarp * kKeys);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params prm) {
  constexpr int kCols = (D + 31) / 32;  // output columns a lane owns
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  extern __shared__ float smem[];
  float* qs = smem;                      // kRows x D
  float* ks = qs + kRows * D;            // kKeys x (D + 1)
  float* vs = ks + kKeys * (D + 1);      // kKeys x D
  float* ps = vs + kKeys * D;            // kWarps x kRowsPerWarp x kKeys

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = prm.hq / prm.hkv;
  const int tq = kRows / group;          // query positions a tile
  const int q0 = blockIdx.x * tq;
  const int nq = min(tq, prm.lq - q0);
  const int rows = nq * group;           // valid rows: row = qi * group + g
  const int off = prm.q_offset ? prm.q_offset[b] : prm.q_offset_scalar;

  const T* qg = static_cast<const T*>(prm.q);
  const T* kg = static_cast<const T*>(prm.k) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;
  const T* vg = static_cast<const T*>(prm.v) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;
  T* og = static_cast<T*>(prm.o);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, d = i % D;
    float x = 0.f;
    if (row < rows) {
      const int h = kvh * group + row % group, qi = q0 + row / group;
      x = to_float(qg[((size_t)(b * prm.hq + h) * prm.lq + qi) * D + d]);
    }
    qs[i] = x;
  }

  // keys any row of this tile may keep
  const int pos_lo = off + q0, pos_hi = off + q0 + nq - 1;
  int k_end = prm.lk;
  if (prm.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (prm.window >= 0) k_begin = max(0, pos_lo - prm.window + 1);
  k_begin = (k_begin / kKeys) * kKeys;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + warp * kRowsPerWarp * kKeys;

  for (int kt = k_begin; kt < k_end; kt += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * D / kVec; i += kThreads) {
      const int e = i * kVec, key = e / D, d = e % D;
      float kv[kVec], vv[kVec];
      if (kt + key < prm.lk) {
        load16(kg + (size_t)(kt + key) * D + d, kv);
        load16(vg + (size_t)(kt + key) * D + d, vv);
      } else {
#pragma unroll
        for (int u = 0; u < kVec; ++u) kv[u] = vv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        ks[key * (D + 1) + d + u] = kv[u];
        vs[key * D + d + u] = vv[u];
      }
    }
    __syncthreads();

    // scores of this warp's rows against keys kt + lane and kt + lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0 = ks[lane * (D + 1) + d];
      const float k1 = ks[(lane + 32) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = qs[(warp + r * kWarps) * D + d];
        s[r][0] = fmaf(qv, k0, s[r][0]);
        s[r][1] = fmaf(qv, k1, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp + r * kWarps;
      const int q_pos = off + q0 + row / group;
      float p[2];
      bool keep[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k_pos = kt + lane + 32 * j;
        float x = s[r][j] * prm.scale;
        if (prm.use_softcap) x = prm.softcap * tanhf(x / prm.softcap);
        keep[j] = row < rows && k_pos < prm.lk &&
                  (!prm.causal || q_pos >= k_pos) &&
                  (prm.window < 0 || q_pos - k_pos < prm.window);
        s[r][j] = keep[j] ? x : kNegInf;
      }
      const float m_cur = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      const float alpha = expf(m[r] - m_cur);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j] = keep[j] ? expf(s[r][j] - m_cur) : 0.f;
        pw[r * kKeys + lane + 32 * j] = p[j];
      }
      l[r] = l[r] * alpha + warp_sum(p[0] + p[1]);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    const int n_keys = min(kKeys, prm.lk - kt);
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float vv = vs[j * D + col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            acc[r][c] = fmaf(pw[r * kKeys + j], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp + r * kWarps;
    if (row >= rows) continue;
    const int h = kvh * group + row % group, qi = q0 + row / group;
    T* orow = og + ((size_t)(b * prm.hq + h) * prm.lq + qi) * D;
    const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) store(orow + col, acc[r][c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const Params& prm, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int group = prm.hq / prm.hkv;
  const int tq = kRows / group;
  const dim3 grid((prm.lq + tq - 1) / tq, prm.hkv, prm.b);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, st>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const Params& prm, cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(prm, st);
    case 24: return launch<T, 24>(prm, st);
    case 32: return launch<T, 32>(prm, st);
    case 64: return launch<T, 64>(prm, st);
    case 112: return launch<T, 112>(prm, st);
    case 128: return launch<T, 128>(prm, st);
    case 256: return launch<T, 256>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. q_offset: (B,) int32 on the device, or null
// to use q_offset_scalar for every batch row. window < 0: no window.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* q_offset,
    int q_offset_scalar, int b, int hq, int hkv, int lq, int lk, int d,
    int dtype, int causal, int window, int use_softcap, float softcap,
    float scale, void* stream) {
  if (b < 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || lq < 0 ||
      lk < 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || lq == 0) return (int)cudaSuccess;
  Params prm{q, k, v, o, static_cast<const int32_t*>(q_offset),
             q_offset_scalar, b, hq, hkv, lq, lk, causal, window,
             use_softcap, softcap, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(d, prm, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(d, prm, st);
  return (int)cudaErrorInvalidValue;
}
