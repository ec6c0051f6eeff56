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
// cache) operations, 4 * D per unmasked (q, k) pair, which only the tensor
// cores deliver at rate; at decode (Lq = 1) bytes, the unmasked K/V rows,
// which only many CTAs in flight can stream.
//
// Three kernels, chosen by the wrapper (ops.py) by dtype and Lq:
//
// bfloat16, Lq > 1: flash_fwd_mma_kernel, FlashAttention-2 on mma.sync
// m16n8k16 (bf16 in, float32 accumulate; mma_bf16.cuh):
// - one CTA of eight warps of 16 rows per (128-row q tile, kv head,
//   batch); the Hq/Hkv query heads sharing a kv head are
//   folded into the tile's rows (row = query position * group + head in
//   group, the GPU form of the Pallas `h // group` index map), so every
//   K/V tile serves all of them;
// - the q tiles that visit the most keys under a causal mask are
//   scheduled first; two CTAs an SM at head dims up to 64;
// - Q fragments are loaded once with ldmatrix and stay in registers for
//   the CTA's life (head dims up to 128; at 256 the 64 registers they
//   would take are read from shared memory per K/V tile instead);
// - K/V tiles of 64 keys (32 at head dim 256) flow through a cp.async ring
//   of 4 stages (3 above head dim 64) with one barrier a tile; S = Q K^T
//   lands in float32 registers, where scale, softcap and the causal /
//   window / length masks are applied (masks only on tiles that straddle
//   a boundary); the row max and sum are quad shuffles; P is rounded to
//   bf16 in registers and is directly the A operand of P V, V read with
//   ldmatrix.trans. Nothing of S or P goes through shared memory: the
//   loads of q and p per FMA pair that bound the CUDA-core design are gone;
// - a head dim that is not a multiple of 16 (24) is zero-padded to 32 in
//   shared memory; the padded columns add 0 to Q K^T and are not stored;
// - K/V tiles that the causal or window mask blanks for every row of the
//   tile are not visited, ragged edges are zero-filled by cp.async.
// wgmma, not mma.sync, is the way to the card's full tensor-core rate; at
// the serving prefill this kernel stays slower than cuDNN's wgmma kernel
// behind SDPA (a TMA-fed wgmma ring is the next design).
//
// bfloat16, Lq = 1 (decode): split-K. flash_decode_split_kernel runs a
// grid of (splits, kv head x 16-row tiles of the group, batch), four warps
// a CTA, each warp its own contiguous part of the keys with its own K/V
// tiles (no block barriers after Q is loaded), and writes its partial
// (m, l, acc) in float32 to scratch the wrapper allocates; parts wholly
// past a slot's offset (or before its window) write l = 0 at once.
// flash_decode_merge_kernel merges the parts of each row by log-sum-exp,
// skipping parts with l = 0 (no exp(NEG_INF - NEG_INF), no 0 / 0), so a
// row with no kept key is exactly 0 (lanes over the parts, then over the
// columns, parts with l = 0 weighted 0). The split count comes from
// ops.decode_splits (two or more CTAs per SM at the serving shape).
//
// float32: flash_fwd_kernel, the first design, kept as it was: float32 FMA
// on CUDA cores, one CTA per (64-row q tile, kv head, batch), K/V tiles of
// 64 keys staged as float32, q and p read from shared memory per FMA pair.
// TF32 tensor cores would keep about three decimal digits, not the 2e-5 the
// float32 tests hold the kernel to.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;                 // rows (q position x head) a tile
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeys = 64;                 // keys a K/V tile
constexpr float kNegInf = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kMmaWarps = 8;              // bf16 prefill: warps a CTA
constexpr int kMmaRows = kMmaWarps * 16;  // rows a CTA
constexpr int kDecWarps = 4;              // bf16 decode: warps (parts) a CTA

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
  // decode only: keys a part (a multiple of the tile), parts a row, and the
  // (B, Hq, parts, 2) float32 (m, l) and (B, Hq, parts, D) float32 acc
  int part_len, nparts;
  float* part_ml;
  float* part_acc;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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


// ------------------------------------------------- bf16: tensor-core path
using bf16 = __nv_bfloat16;

template <int D>
struct Shape {
  static constexpr int DP = (D + 15) / 16 * 16;  // contraction width
  static constexpr int LD = DP + 8;              // shared row stride
  static constexpr int KEYS = DP > 128 ? 32 : 64;  // keys a K/V tile
  static constexpr bool QREG = DP <= 128;        // Q fragments in registers
  static constexpr int QF = QREG ? DP / 16 : 1;
  // K/V ring depth of the prefill: loads of the next STAGES - 1 tiles are in
  // flight while one is computed
  static constexpr int STAGES = DP <= 64 ? 4 : 3;
};

__device__ __forceinline__ bool kept(const Params& prm, int q_pos, int k_pos) {
  return k_pos < prm.lk && (!prm.causal || q_pos >= k_pos) &&
         (prm.window < 0 || q_pos - k_pos < prm.window);
}

// Copy rows [0, nrows) of a (rows, d) bf16 array into a shared tile of row
// stride LD with cp.async, zero-filling rows >= valid and columns >= d.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          const bf16* any_valid, int d,
                                          int nrows, int valid, int tid,
                                          int nthreads) {
  constexpr int kChunks = DP / 8, LD = DP + 8;
  for (int i = tid; i < nrows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid && c * 8 < d;
    mma::cp_async16(dst + r * LD + c * 8,
                    ok ? src + (size_t)r * d + c * 8 : any_valid, ok ? 16 : 0);
  }
}

// The online-softmax state of one 16-row m tile of a warp: the rows' max m
// and sum l (lane / 4 and lane / 4 + 8) and the float32 accumulator o.
template <int D>
struct Acc {
  float m[2], l[2];
  float o[Shape<D>::DP / 8][4];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < Shape<D>::DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  }
};

// One warp's 16 rows against one K tile: S = Q K^T, scale / softcap / masks,
// the online-softmax update of m, l and o, and P as bf16 A fragments.
template <int D>
__device__ __forceinline__ void score_tile(
    const uint32_t (&qf)[Shape<D>::QF][4], const bf16* qw, const bf16* ks,
    int kt, bool need_mask, const int (&q_pos)[2], const Params& prm,
    Acc<D>& acc, uint32_t (&pf)[Shape<D>::KEYS / 16][4]) {
  using S = Shape<D>;
  constexpr int NT = S::KEYS / 8;
  const int lane = threadIdx.x & 31;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < S::DP / 16; ++kk) {
    uint32_t a[4];
    if constexpr (S::QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      mma::ldmatrix_x4(a, qw + (lane & 15) * S::LD + kk * 16 + (lane >> 4) * 8);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      mma::ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * S::LD +
                              kk * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(s[2 * np], a, b[0], b[1]);
      mma::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
  // the softmax runs in base 2 (exp2f): logits times log2(e)
  const float scale2 = prm.scale * kLog2e;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = prm.use_softcap
                    ? prm.softcap * tanhf(s[nt][e] * prm.scale / prm.softcap) * kLog2e
                    : s[nt][e] * scale2;
      if (need_mask &&
          !kept(prm, q_pos[e >> 1], kt + nt * 8 + 2 * (lane & 3) + (e & 1)))
        x = kNegInf;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(acc.m[r], mx[r]);
    alpha[r] = exp2f(acc.m[r] - m_new);  // 1 while every key so far is masked
    acc.m[r] = m_new;
    acc.l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < S::DP / 8; ++j) {
    acc.o[j][0] *= alpha[0];
    acc.o[j][1] *= alpha[0];
    acc.o[j][2] *= alpha[1];
    acc.o[j][3] *= alpha[1];
  }
  // a masked logit's p is 0 (exp2f of NEG_INF - NEG_INF would be 1); a
  // tile without masks has none
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = !need_mask || s[nt][e] > kNegInf
                          ? exp2f(s[nt][e] - acc.m[e >> 1]) : 0.f;
      acc.l[e >> 1] += p;
      s[nt][e] = p;
    }
#pragma unroll
  for (int kk = 0; kk < S::KEYS / 16; ++kk) {
    pf[kk][0] = mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// o += P V for one warp's 16 rows and one V tile
template <int D>
__device__ __forceinline__ void pv_tile(
    const uint32_t (&pf)[Shape<D>::KEYS / 16][4], const bf16* vs,
    Acc<D>& acc) {
  using S = Shape<D>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < S::KEYS / 16; ++kk)
#pragma unroll
    for (int dp = 0; dp < S::DP / 16; ++dp) {
      uint32_t b[4];
      mma::ldmatrix_x4_trans(
          b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LD +
                 dp * 16 + (lane >> 4) * 8);
      mma::mma_bf16(acc.o[2 * dp], pf[kk], b[0], b[1]);
      mma::mma_bf16(acc.o[2 * dp + 1], pf[kk], b[2], b[3]);
    }
}

template <int D>
__device__ __forceinline__ void load_qf(uint32_t (&qf)[Shape<D>::QF][4],
                                        const bf16* qw) {
  using S = Shape<D>;
  if constexpr (S::QREG) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int kk = 0; kk < S::DP / 16; ++kk)
      mma::ldmatrix_x4(qf[kk], qw + (lane & 15) * S::LD + kk * 16 +
                                   (lane >> 4) * 8);
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  using S = Shape<D>;
  return sizeof(bf16) * (kMmaRows + 2 * S::STAGES * S::KEYS) * S::LD;  // Q, ring
}

// One CTA of the prefill: a (128-row q tile, kv head, batch), the q tiles
// numbered from the last, which visit the most keys under a causal mask,
// so the longest run first.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(Params prm) {
  using S = Shape<D>;
  constexpr int KEYS = S::KEYS, LD = S::LD, kChunks = S::DP / 8;
  constexpr int kT = kMmaWarps * 32, ST = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kMmaRows x LD
  bf16* ks = qs + kMmaRows * LD;                 // STAGES x KEYS x LD
  bf16* vs = ks + ST * KEYS * LD;                // STAGES x KEYS x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = prm.hq / prm.hkv;
  const int tq = kMmaRows / group;  // query positions a tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * tq;
  const int nq = min(tq, prm.lq - q0);
  const int rows = nq * group;      // valid rows: row = qi * group + g
  const int off = prm.q_offset ? prm.q_offset[b] : prm.q_offset_scalar;

  const bf16* qg = static_cast<const bf16*>(prm.q);
  const bf16* kg = static_cast<const bf16*>(prm.k) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;
  const bf16* vg = static_cast<const bf16*>(prm.v) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;

  for (int i = tid; i < kMmaRows * kChunks; i += kT) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && c * 8 < D;
    const size_t row = ((size_t)b * prm.hq + kvh * group + r % group) * prm.lq +
                       q0 + r / group;
    mma::cp_async16(qs + r * LD + c * 8, ok ? qg + row * D + c * 8 : qg,
                    ok ? 16 : 0);
  }
  mma::cp_async_commit();

  // keys any row of this tile may keep
  const int pos_lo = off + q0, pos_hi = off + q0 + nq - 1;
  int k_end = prm.lk;
  if (prm.causal) k_end = min(k_end, pos_hi + 1);
  int k_begin = 0;
  if (prm.window >= 0) k_begin = max(0, pos_lo - prm.window + 1);
  k_begin = (k_begin / KEYS) * KEYS;
  const int ntiles = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS : 0;

  auto load_kv = [&](int it) {  // K/V tile `it` into its ring slot
    const int kt = k_begin + it * KEYS, slot = it % ST;
    load_rows<S::DP>(ks + slot * KEYS * LD, kg + (size_t)kt * D, kg, D, KEYS,
                     prm.lk - kt, tid, kT);
    load_rows<S::DP>(vs + slot * KEYS * LD, vg + (size_t)kt * D, vg, D, KEYS,
                     prm.lk - kt, tid, kT);
  };
  // one cp.async group per tile (empty past the last), ST - 1 in flight
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {
    if (it < ntiles) load_kv(it);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<ST - 1>();  // Q has landed
  __syncthreads();

  const bf16* qw = qs + warp * 16 * LD;
  uint32_t qf[S::QF][4];
  load_qf<D>(qf, qw);
  const int r0 = warp * 16 + lane / 4;
  const int q_pos[2] = {off + q0 + r0 / group, off + q0 + (r0 + 8) / group};
  Acc<D> acc;
  acc.init();

  for (int it = 0; it < ntiles; ++it) {
    const int kt = k_begin + it * KEYS;
    mma::cp_async_wait<ST - 2>();  // tile `it` has landed
    // one barrier: every thread's part of tile `it` is visible, and every
    // warp is done with tile it - 1, whose slot is refilled now
    __syncthreads();
    if (it + ST - 1 < ntiles) load_kv(it + ST - 1);
    mma::cp_async_commit();
    const bool need_mask =
        kt + KEYS > prm.lk || (prm.causal && kt + KEYS - 1 > pos_lo) ||
        (prm.window >= 0 && pos_hi - kt >= prm.window);
    uint32_t pf[KEYS / 16][4];
    const int slot = it % ST;
    score_tile<D>(qf, qw, ks + slot * KEYS * LD, kt, need_mask, q_pos, prm,
                  acc, pf);
    pv_tile<D>(pf, vs + slot * KEYS * LD, acc);
  }
  mma::cp_async_wait<0>();

  bf16* og = static_cast<bf16*>(prm.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc.l[r] += __shfl_xor_sync(0xffffffffu, acc.l[r], 1);
    acc.l[r] += __shfl_xor_sync(0xffffffffu, acc.l[r], 2);
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    const int h = kvh * group + row % group, qi = q0 + row / group;
    bf16* orow = og + ((size_t)(b * prm.hq + h) * prm.lq + qi) * D;
    const float inv = 1.f / (acc.l[r] > 0.f ? acc.l[r] : 1.f);
#pragma unroll
    for (int j = 0; j < S::DP / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            acc.o[j][2 * r] * inv, acc.o[j][2 * r + 1] * inv);
    }
  }
}

template <int D>
constexpr size_t decode_smem_bytes() {
  using S = Shape<D>;
  return sizeof(bf16) * (16 + kDecWarps * 2 * S::KEYS) * S::LD;
}

// Decode (Lq = 1): grid (splits, Hkv x 16-row tiles of the group, B). Warp
// w of split s takes keys [part * part_len, (part + 1) * part_len), part =
// s * kDecWarps + w, and writes that part's (m, l, acc) unnormalised.
template <int D>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_split_kernel(Params prm) {
  using S = Shape<D>;
  constexpr int KEYS = S::KEYS, LD = S::LD, kChunks = S::DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // 16 x LD
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* ks = qs + 16 * LD + warp * 2 * KEYS * LD;  // this warp's K tile
  bf16* vs = ks + KEYS * LD;                       // and V tile

  const int group = prm.hq / prm.hkv;
  const int row_tiles = (group + 15) / 16;
  const int kvh = blockIdx.y / row_tiles, rt = blockIdx.y % row_tiles;
  const int b = blockIdx.z;
  const int h0 = kvh * group + rt * 16;  // query head of row 0
  const int rows = min(16, group - rt * 16);
  const int off = prm.q_offset ? prm.q_offset[b] : prm.q_offset_scalar;

  const bf16* qg = static_cast<const bf16*>(prm.q);
  const bf16* kg = static_cast<const bf16*>(prm.k) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;
  const bf16* vg = static_cast<const bf16*>(prm.v) + (size_t)(b * prm.hkv + kvh) * prm.lk * D;

  for (int i = tid; i < 16 * kChunks; i += kDecWarps * 32) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows && c * 8 < D;
    mma::cp_async16(qs + r * LD + c * 8,
                    ok ? qg + ((size_t)b * prm.hq + h0 + r) * D + c * 8 : qg,
                    ok ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[S::QF][4];
  load_qf<D>(qf, qs);
  const int q_pos[2] = {off, off};
  Acc<D> acc;
  acc.init();

  const int part = blockIdx.x * kDecWarps + warp;
  const int p_begin = part * prm.part_len;
  int k_end = min(prm.lk, p_begin + prm.part_len);
  if (prm.causal) k_end = min(k_end, off + 1);
  int k_begin = p_begin;
  if (prm.window >= 0) k_begin = max(k_begin, off - prm.window + 1);
  k_begin = p_begin + (k_begin - p_begin) / KEYS * KEYS;

  for (int kt = k_begin; kt < k_end; kt += KEYS) {
    load_rows<S::DP>(ks, kg + (size_t)kt * D, kg, D, KEYS, prm.lk - kt, lane,
                     32);
    mma::cp_async_commit();
    load_rows<S::DP>(vs, vg + (size_t)kt * D, vg, D, KEYS, prm.lk - kt, lane,
                     32);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // K has landed; V is on its way
    __syncwarp();
    const bool need_mask = kt + KEYS > prm.lk ||
                           (prm.causal && kt + KEYS - 1 > off) ||
                           (prm.window >= 0 && off - kt >= prm.window);
    uint32_t pf[KEYS / 16][4];
    score_tile<D>(qf, qs, ks, kt, need_mask, q_pos, prm, acc, pf);
    mma::cp_async_wait<0>();
    __syncwarp();
    pv_tile<D>(pf, vs, acc);
    __syncwarp();  // the tiles are refilled next
  }

  float (&l)[2] = acc.l;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = lane / 4 + 8 * r;
    if (row >= rows) continue;
    const size_t slot = ((size_t)b * prm.hq + h0 + row) * prm.nparts + part;
    if ((lane & 3) == 0) {
      prm.part_ml[2 * slot] = acc.m[r];
      prm.part_ml[2 * slot + 1] = l[r];
    }
    float* out = prm.part_acc + slot * D;
#pragma unroll
    for (int j = 0; j < S::DP / 8; ++j) {
      const int col = j * 8 + 2 * (lane & 3);
      if (col < D)
        *reinterpret_cast<float2*>(out + col) =
            make_float2(acc.o[j][2 * r], acc.o[j][2 * r + 1]);
    }
  }
}

// One warp a (batch, head) row: out = sum_i 2^(m_i - M) acc_i / sum_i
// 2^(m_i - M) l_i over the parts with l_i > 0; 0 if there is none. Lanes
// take the parts for the max and the sum, then the columns, eight parts'
// loads in flight at a time; a part with no kept key weighs 0 (its acc is
// written as 0 by the split kernel, never left unset).
__global__ void __launch_bounds__(128)
flash_decode_merge_kernel(const float* __restrict__ ml,
                          const float* __restrict__ acc, bf16* __restrict__ o,
                          int nrows, int nparts, int d) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= nrows) return;
  const float* mlr = ml + (size_t)row * nparts * 2;
  float mx = kNegInf;
  for (int i = lane; i < nparts; i += 32)
    if (mlr[2 * i + 1] > 0.f) mx = fmaxf(mx, mlr[2 * i]);
  mx = warp_max(mx);
  float den = 0.f;
  for (int i = lane; i < nparts; i += 32)
    if (mlr[2 * i + 1] > 0.f) den += exp2f(mlr[2 * i] - mx) * mlr[2 * i + 1];
  den = warp_sum(den);
  const float inv = den > 0.f ? 1.f / den : 0.f;
  const float* accr = acc + (size_t)row * nparts * d;
  for (int col0 = 0; col0 < d; col0 += 32) {
    const int col = min(col0 + lane, d - 1);  // lanes past d repeat the last
    float num = 0.f;
    for (int base = 0; base < nparts; base += 32) {
      const int i = base + lane;
      // every part's acc is written (0 where l = 0), so all are read
      const float w = i < nparts && mlr[2 * i + 1] > 0.f
                          ? exp2f(mlr[2 * i] - mx) : 0.f;
      const int n = min(32, nparts - base);
      for (int j0 = 0; j0 < n; j0 += 8) {
        float a[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          a[u] = j0 + u < n ? accr[(size_t)(base + j0 + u) * d + col] : 0.f;
#pragma unroll
        for (int u = 0; u < 8; ++u)
          num += __shfl_sync(0xffffffffu, w, (j0 + u) & 31) * a[u];
      }
    }
    if (col0 + lane < d) o[(size_t)row * d + col] = __float2bfloat16_rn(num * inv);
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <int D>
int launch_mma(const Params& prm, cudaStream_t st) {
  static bool attr_set = false;
  if (int err = set_smem(flash_fwd_mma_kernel<D>, mma_smem_bytes<D>(), attr_set))
    return err;
  const int tq = kMmaRows / (prm.hq / prm.hkv);
  const dim3 grid((prm.lq + tq - 1) / tq, prm.hkv, prm.b);
  flash_fwd_mma_kernel<D><<<grid, kMmaWarps * 32, mma_smem_bytes<D>(), st>>>(prm);
  return (int)cudaGetLastError();
}

template <int D>
int launch_decode(const Params& prm, int splits, cudaStream_t st) {
  static bool attr_set = false;
  if (int err = set_smem(flash_decode_split_kernel<D>, decode_smem_bytes<D>(),
                         attr_set))
    return err;
  const int row_tiles = (prm.hq / prm.hkv + 15) / 16;
  const dim3 grid(splits, prm.hkv * row_tiles, prm.b);
  flash_decode_split_kernel<D><<<grid, kDecWarps * 32, decode_smem_bytes<D>(), st>>>(prm);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const int nrows = prm.b * prm.hq;
  flash_decode_merge_kernel<<<(nrows + 3) / 4, 128, 0, st>>>(
      prm.part_ml, prm.part_acc, static_cast<bf16*>(prm.o), nrows, prm.nparts,
      D);
  return (int)cudaGetLastError();
}

template <template <int> class Fn, typename... Args>
int by_head_dim(int d, Args... args) {
  switch (d) {
    case 16: return Fn<16>::run(args...);
    case 24: return Fn<24>::run(args...);
    case 32: return Fn<32>::run(args...);
    case 64: return Fn<64>::run(args...);
    case 112: return Fn<112>::run(args...);
    case 128: return Fn<128>::run(args...);
    case 256: return Fn<256>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
struct RunF32 {
  static int run(const Params& prm, cudaStream_t st) { return launch<float, D>(prm, st); }
};
template <int D>
struct RunMma {
  static int run(const Params& prm, cudaStream_t st) { return launch_mma<D>(prm, st); }
};
template <int D>
struct RunDecode {
  static int run(const Params& prm, int splits, cudaStream_t st) {
    return launch_decode<D>(prm, splits, st);
  }
};

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; Lq > 1 here,
// decode goes through flash_attention_decode_launch). q_offset: (B,) int32
// on the device, or null to use q_offset_scalar for every batch row.
// window < 0: no window.
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
             use_softcap, softcap, scale, 0, 0, nullptr, nullptr};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_head_dim<RunF32>(d, prm, st);
  if (dtype == 1) return by_head_dim<RunMma>(d, prm, st);
  return (int)cudaErrorInvalidValue;
}

// bfloat16 decode (Lq = 1), split-K: `splits` CTAs along the keys, each of
// parts_per_split (= kDecWarps, checked) parts of part_len keys (a multiple
// of 64), partials in part_ml ((B, Hq, splits * parts_per_split, 2)
// float32) and part_acc ((B, Hq, splits * parts_per_split, D) float32),
// merged into o.
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, const void* q_offset,
    int q_offset_scalar, int b, int hq, int hkv, int lk, int d, int causal,
    int window, int use_softcap, float softcap, float scale, int splits,
    int parts_per_split, int part_len, void* part_ml, void* part_acc,
    void* stream) {
  if (b < 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || lk < 0 ||
      splits <= 0 || parts_per_split != kDecWarps || part_len <= 0 ||
      part_len % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return (int)cudaSuccess;
  Params prm{q, k, v, o, static_cast<const int32_t*>(q_offset),
             q_offset_scalar, b, hq, hkv, 1, lk, causal, window,
             use_softcap, softcap, scale, part_len, splits * kDecWarps,
             static_cast<float*>(part_ml), static_cast<float*>(part_acc)};
  return by_head_dim<RunDecode>(d, prm, splits,
                                reinterpret_cast<cudaStream_t>(stream));
}
