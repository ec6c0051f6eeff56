// ssd_scan: the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan_pallas). For x (Bt, L, H, P), dt (Bt, L, H),
// A and D (H,), B and C (Bt, L, G, N), head h reading group g = h / (H/G):
//
//     S_t = exp(dt_t A_h) S_{t-1} + dt_t B_t^T x_t        (N x P state)
//     y_t = C_t S_t + D_h x_t
//
// computed chunkwise as the Pallas kernel does, per chunk of Q steps:
//
//     lc[t]   = sum_{s<=t} dt[s] A                   (log-decay prefix)
//     y_intra = ((C B^T) . M) (dt . x),  M[t,s] = exp(lc[t]-lc[s]) [s<=t]
//     y_inter = exp(lc[t]) C[t] S_prev
//     S_new   = exp(lc[Q-1]) S_prev + sum_s exp(lc[Q-1]-lc[s]) dt[s] B[s]^T x[s]
//
// and the D skip, accumulating in float32 whatever x's type.
//
// What bounds it: at mamba2-130m's training shape (H = 24, P = 64, G = 1,
// N = 128, Q = 256) the products of a chunk over its causal triangle are
// about 21 MFLOP per (batch, head, chunk), 16 GFLOP in all, against 55 MB
// of bytes (x, y, B, C, dt, each once in bf16): at the tensor peak the
// bytes bound it, at this design's CUDA-core FMA the operations. This
// first design is simple and right:
//
// - one CTA per (head, batch) walks the chunks in order and keeps the
//   (N, P) float32 state in shared memory (32 KB at N = 128, P = 64): the
//   GPU form of the Pallas grid's "arbitrary" chunk axis;
// - a chunk is cut into row blocks of 64 steps. For each t-block the CTA
//   stages C_t, starts y_t from exp(lc_t) C_t S_prev, then for every
//   s-block s <= t stages B_s (transposed) and dt x_s, forms one 64 x 64
//   block of C_t B_s^T times the masked decay, and accumulates it times
//   dt x_s into y_t. The (Q, Q) decay matrix (256 KB at Q = 256) and a
//   whole chunk's B and C (128 KB each in float32) never sit in shared
//   memory at once;
// - the decay is exponentiated only where s <= t (exponent <= 0 for
//   A < 0): a masked entry is 0, never 0 * inf;
// - the prefix lc is summed and kept in float64: in training dt A is about
//   -0.7 a step, so lc reaches -180 within a chunk, where a float32 ulp is
//   1.5e-5 and 256 rounded additions put errors of 1e-4 into the short-range
//   exponents lc[t] - lc[s] that carry y (about 1e-3 in y against the
//   sequential scan). Only the differences are rounded to float32;
// - every y of the chunk is written before the state moves on: the state
//   is then scaled by exp(lc_end) in place and the chunk's contribution
//   added s-block by s-block (sum_s B_s^T (w_s x_s), w_s = dt_s
//   exp(lc_end - lc_s));
// - a ragged last chunk (L % Q != 0) is masked: rows past L are staged as
//   zeros and never written;
// - 256 threads as 16 x 16, each holding a 4 x JT register tile of a
//   64-row product (rows ty + 16 i, columns tx + 16 j), float32 FMA on
//   CUDA cores.
//
// Tensor cores (mma.sync / wgmma), TMA, and sharing C B^T across the heads
// of a group are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // steps of a row block
constexpr int kLdW = kRows + 4;  // row stride of the W block
constexpr int kLdBT = kRows + 1;  // row stride of B_s transposed

struct Params {
  const void* x;
  const float* dt;
  const float* a;
  const void* bm;
  const void* cm;
  const float* d;  // null: no skip
  void* y;
  int bt, l, h, g, n, p, chunk;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// acc[i][j] += sum_k a[(ty + 16 i) * lda + k] * b[k * ldb + tx + 16 j] for
// rows ty + 16 i < a_rows and columns tx + 16 j < ncols.
template <int JT>
__device__ __forceinline__ void mm_acc(float (&acc)[4][JT],
                                       const float* __restrict__ a, int lda,
                                       int a_rows, const float* __restrict__ b,
                                       int ldb, int k_len, int ncols, int ty,
                                       int tx) {
  for (int k = 0; k < k_len; ++k) {
    float av[4], bv[JT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      av[i] = r < a_rows ? a[r * lda + k] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < JT; ++j) {
      const int c = tx + 16 * j;
      bv[j] = c < ncols ? b[k * ldb + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JT; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Stage rows s0 .. s0+63 of the chunk starting at step c0: B transposed
// into bt_s[n * kLdBT + r], and w[r] * x into xs[r * P + p], where w is
// dt[s] (intra products) or dt[s] exp(lc_end - lc[s]) (state update).
template <typename T>
__device__ void stage_b_x(const Params& prm, int b, int hh, int gg, int c0,
                          int s0, int qn, const float* dts, const double* lc,
                          bool to_end, double lc_end, float* bt_s, float* xs) {
  const T* bm = static_cast<const T*>(prm.bm);
  const T* x = static_cast<const T*>(prm.x);
  const int n = prm.n, p = prm.p;
  for (int idx = threadIdx.x; idx < kRows * n; idx += kThreads) {
    const int r = idx / n, k = idx % n;
    const int s = s0 + r;
    float v = 0.f;
    if (s < qn)
      v = to_f(bm[(((int64_t)b * prm.l + c0 + s) * prm.g + gg) * n + k]);
    bt_s[k * kLdBT + r] = v;
  }
  for (int idx = threadIdx.x; idx < kRows * p; idx += kThreads) {
    const int r = idx / p, c = idx % p;
    const int s = s0 + r;
    float v = 0.f;
    if (s < qn) {
      float w = dts[s];
      if (to_end) w *= expf((float)(lc_end - lc[s]));
      v = w * to_f(x[(((int64_t)b * prm.l + c0 + s) * prm.h + hh) * p + c]);
    }
    xs[r * p + c] = v;
  }
}

template <typename T, int JT>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(Params prm) {
  const int hh = blockIdx.x, b = blockIdx.y;
  const int gg = hh / (prm.h / prm.g);
  const int n = prm.n, p = prm.p, q = prm.chunk;
  const int qpad = (q + kRows - 1) / kRows * kRows;
  const int ldc = n + 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* x = static_cast<const T*>(prm.x);
  const T* cm = static_cast<const T*>(prm.cm);
  T* y = static_cast<T*>(prm.y);
  const float a = prm.a[hh];
  const float dskip = prm.d != nullptr ? prm.d[hh] : 0.f;

  extern __shared__ double smem[];
  double* lc = smem;                  // (qpad) log-decay prefix, float64
  float* st = reinterpret_cast<float*>(lc + qpad);  // (N, P) carried state
  float* ct = st + n * p;             // (64, N + 4) C of the t-block
  float* bt_s = ct + kRows * ldc;     // (N, 65) B of the s-block, transposed
  float* wblk = bt_s + n * kLdBT;     // (64, 68) masked C B^T block
  float* xs = wblk + kRows * kLdW;    // (64, P) weighted x of the s-block
  float* dts = xs + kRows * p;        // (qpad) dt of the chunk

  for (int i = tid; i < n * p; i += kThreads) st[i] = 0.f;

  for (int c0 = 0; c0 < prm.l; c0 += q) {
    const int qn = min(q, prm.l - c0);
    for (int i = tid; i < qpad; i += kThreads)
      dts[i] = i < qn ? prm.dt[((int64_t)b * prm.l + c0 + i) * prm.h + hh]
                      : 0.f;
    __syncthreads();
    if (tid < 32) {  // inclusive prefix of dt * A, 32 steps at a time
      double carry = 0.0;
      for (int base = 0; base < qpad; base += 32) {
        double v = dts[base + tid] * a;  // dt A rounded as the reference does
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        lc[base + tid] = v;  // past qn: stays lc[qn - 1]
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const double lc_end = lc[qn - 1];
    const int nblk = (qn + kRows - 1) / kRows;

    for (int tb = 0; tb < nblk; ++tb) {
      const int t0 = tb * kRows;
      for (int idx = tid; idx < kRows * n; idx += kThreads) {
        const int r = idx / n, k = idx % n;
        const int t = t0 + r;
        ct[r * ldc + k] =
            t < qn ? to_f(cm[(((int64_t)b * prm.l + c0 + t) * prm.g + gg) * n +
                             k])
                   : 0.f;
      }
      __syncthreads();
      // inter-chunk term: exp(lc_t) C_t S_prev
      float acc[4][JT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < JT; ++j) acc[i][j] = 0.f;
      mm_acc<JT>(acc, ct, ldc, kRows, st, p, n, p, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf((float)lc[t0 + ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < JT; ++j) acc[i][j] *= e;
      }
      // intra-chunk term, s-block by s-block
      for (int sb = 0; sb <= tb; ++sb) {
        const int s0 = sb * kRows;
        stage_b_x<T>(prm, b, hh, gg, c0, s0, qn, dts, lc, false, 0.0, bt_s,
                     xs);
        __syncthreads();
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        mm_acc<4>(w, ct, ldc, kRows, bt_s, kLdBT, n, kRows, ty, tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            // exponentiate only where s <= t: the exponent is <= 0 there
            const float m =
                (s <= t && t < qn) ? expf((float)(lc[t] - lc[s])) : 0.f;
            wblk[(ty + 16 * i) * kLdW + tx + 16 * j] = w[i][j] * m;
          }
        }
        __syncthreads();
        mm_acc<JT>(acc, wblk, kLdW, kRows, xs, p, kRows, p, ty, tx);
        __syncthreads();  // bt_s, xs and wblk are restaged next
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= qn) continue;
        const int64_t row = ((int64_t)b * prm.l + c0 + t) * prm.h + hh;
#pragma unroll
        for (int j = 0; j < JT; ++j) {
          const int c = tx + 16 * j;
          if (c < p) {
            float v = acc[i][j];
            if (prm.d != nullptr) v += dskip * to_f(x[row * p + c]);
            y[row * p + c] = from_f<T>(v);
          }
        }
      }
      __syncthreads();  // ct is restaged next
    }

    // carry: S = exp(lc_end) S_prev + sum_s B_s^T (dt_s exp(lc_end - lc_s) x_s)
    const float e_end = expf((float)lc_end);
    for (int i = tid; i < n * p; i += kThreads) st[i] *= e_end;
    __syncthreads();
    for (int sb = 0; sb < nblk; ++sb) {
      stage_b_x<T>(prm, b, hh, gg, c0, sb * kRows, qn, dts, lc, true, lc_end,
                   bt_s, xs);
      __syncthreads();
      for (int n0 = 0; n0 < n; n0 += kRows) {
        float acc[4][JT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < JT; ++j) acc[i][j] = 0.f;
        mm_acc<JT>(acc, bt_s + n0 * kLdBT, kLdBT, n - n0, xs, p, kRows, p, ty,
                   tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = n0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < JT; ++j) {
            const int c = tx + 16 * j;
            if (r < n && c < p) st[r * p + c] += acc[i][j];
          }
        }
      }
      __syncthreads();  // bt_s and xs are restaged next
    }
  }
}

size_t smem_bytes(int n, int p, int chunk) {
  const size_t qpad = (chunk + kRows - 1) / kRows * kRows;
  return sizeof(double) * qpad +
         sizeof(float) * ((size_t)n * p + (size_t)kRows * (n + 4) +
                          (size_t)n * kLdBT + (size_t)kRows * kLdW +
                          (size_t)kRows * p + qpad);
}

template <typename T, int JT>
int launch(const Params& prm, cudaStream_t st) {
  const size_t bytes = smem_bytes(prm.n, prm.p, prm.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, JT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(prm.h, prm.bt);
  ssd_scan_kernel<T, JT><<<grid, kThreads, bytes, st>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& prm, cudaStream_t st) {
  switch ((prm.p + 15) / 16) {
    case 1: return launch<T, 1>(prm, st);
    case 2: return launch<T, 2>(prm, st);
    case 3:
    case 4: return launch<T, 4>(prm, st);
    case 5:
    case 6:
    case 7:
    case 8: return launch<T, 8>(prm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory (bytes) the kernel needs for state dim n, head dim p and
// chunk length chunk; the wrapper checks it against the card's limit.
extern "C" long long ssd_scan_smem_bytes(int n, int p, int chunk) {
  return (long long)smem_bytes(n, p, chunk);
}

// dtype: 0 float32, 1 bfloat16 (x, B, C and y); dt, A and D are float32,
// d may be null. Every array is contiguous in the documented layout.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* d,
                               void* y, int bt, int l, int h, int g, int n,
                               int p, int chunk, int dtype, void* stream) {
  if (bt < 0 || l < 0 || h <= 0 || g <= 0 || h % g != 0 || n <= 0 ||
      p <= 0 || p > 128 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (bt == 0 || l == 0) return (int)cudaSuccess;
  Params prm{x, static_cast<const float*>(dt), static_cast<const float*>(a),
             bm, cm, static_cast<const float*>(d), y, bt, l, h, g, n, p,
             chunk};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(prm, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(prm, st);
  return (int)cudaErrorInvalidValue;
}
