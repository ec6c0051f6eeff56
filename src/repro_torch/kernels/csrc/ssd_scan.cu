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
// N = 128, Q = 256) the products over the causal triangle are about 16
// GFLOP against 55 MB of bytes (x, y, B, C, dt, each once in bf16): at
// the tensor-core rate the bytes bound it (16.5 us), at CUDA-core FMA
// the operations (the first design: 2.6-3.1 ms, one CTA per (head,
// batch) walking its chunks in order).
//
// bfloat16: the chunked decomposition, so that chunks run in parallel and
// only a small state pass is sequential; four launches, every product on
// mma.sync m16n8k16 (bf16 in, float32 accumulate; mma_bf16.cuh):
//
// 1. ssd_cb_kernel, grid (chunk x 64-row t blocks, group, batch): C B^T
//    over the causal block triangle, float32, into an L2-sized scratch
//    (its 16 x 16 blocks in mma fragment order, so a warp reads a block as
//    two coalesced float4 a lane: 4.5 MB at the training shape). C B^T
//    does not depend on the head, so it is formed once per (batch, chunk,
//    group) and read by the group's H / G heads (24 at G = 1) instead of
//    being recomputed by each: a scratch, not a loop over heads inside one
//    CTA, because such a CTA would leave 32 CTAs for 132 SMs at G = 1;
// 2. ssd_state_kernel, grid (chunk, head, batch): the chunk's contribution
//    B^T (w . x), w_s = dt_s exp(lc_end - lc_s), (N, P) float32, and
//    exp(lc_end), into scratch;
// 3. ssd_pass_kernel, grid (N P / 1024, head, batch): the only sequential
//    part, S_c = exp(lc_end,c-1) S_{c-1} + contribution_{c-1} in float32
//    over the chunks (4 at the training shape), the state entering each
//    chunk stored in bf16, the chunk scan's operand;
// 4. ssd_chunk_scan_kernel, grid (chunk, head, batch), 768 CTAs at the
//    training shape: y = exp(lc_t) C_t S_prev + (W . dt_s) x + D x with W
//    = C B^T . M read from the scratch, over the causal block triangle
//    only; eight warps each own 16-row slabs of t, paired from both ends
//    of the triangle so the warps get equal work; W is formed in registers
//    and is directly the A operand of its product with x (ldmatrix.trans).
//    C comes as A fragments straight from L2 (no shared copy), so two CTAs
//    fit an SM; the prologue's copies (dt, x, S_prev) are one cp.async
//    group.
//
// Numerics kept from the first design: the prefix lc is summed and kept
// in float64 (in training dt A is about -0.7 a step, so lc reaches -180
// within a chunk, where a float32 ulp is 1.5e-5 and 256 rounded additions
// put about 1e-3 into y); only differences are rounded to float32. A decay
// is exponentiated only where s <= t (exponent <= 0 for A < 0), so a
// masked entry is 0, never 0 * inf; off the diagonal blocks it is taken as
// exp(lc_t - lc_e) exp(lc_e - lc_s), e the last step of s's 16-step block,
// both exponents <= 0 (two exp a thread and block instead of eight). A
// ragged last chunk (L % Q != 0) is zero-filled past L and never written.
// Rounding points new in bf16, rehearsed on the CPU in
// ref.ssd_three_stage_ref against the 2e-2 gate at log-decays of -200:
// w . x and the entering state S_prev are rounded to bf16 (S's low part
// changed the worst error little); W . dt_s is split into a high and a low
// bf16 part, two products (rounded once it took most of the gate, and
// with dt . x rounded as well the gate was missed); x itself is bf16 and
// enters its product exactly (dt is folded into W, not into x).
//
// float32: ssd_scan_kernel, the first design, kept as it was for the
// float32 checks (atol 1e-5): one CTA per (head, batch) walks the chunks
// in order with the (N, P) float32 state in shared memory; a chunk is cut
// into 64-step row blocks, C_t B_s^T . M formed block by block for s <= t,
// float32 FMA on CUDA cores (bf16 tensor cores would not hold 1e-5).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "mma_bf16.cuh"

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
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

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



// ------------------------------------------------- bf16: tensor-core path
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;  // eight warps
constexpr int kCbThreads = 128;  // four warps, one 16-row slab each
constexpr int kCbRows = 64;      // t rows of C B^T a CTA of the cb kernel

struct TcParams {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* bm;
  const bf16* cm;
  const float* d;  // null: no skip
  bf16* y;
  float* cb;       // (Bt, nc, G, cb_floats(QP)): C B^T of each chunk and group
  float* states;   // (Bt, H, nc, N, P): each chunk's state contribution
  bf16* entering;  // (Bt, H, nc, N, P): the state entering each chunk, bf16
  float* decay;    // (Bt, H, nc): exp(lc_end) of each chunk
  int bt, l, h, g, n, p, chunk, nc, qp;
};

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// dt of chunk c0 into dts with cp.async (zeros past qn, up to qp); the
// caller commits and waits
__device__ void stage_dt(const TcParams& prm, int b, int hh, int c0, int qn,
                         float* dts) {
  for (int i = threadIdx.x; i < prm.qp; i += blockDim.x) {
    const bool ok = i < qn;
    mma::cp_async4(dts + i,
                   ok ? prm.dt + ((int64_t)b * prm.l + c0 + i) * prm.h + hh
                      : prm.dt,
                   ok ? 4 : 0);
  }
}

// the inclusive float64 prefix of dt * A over the staged dts into lc (lc
// past qn stays lc[qn - 1], dt being 0 there); qp % 32 == 0. Warp 0 scans,
// 32 steps at a time; the block synchronises after.
__device__ void prefix_scan(int qp, float a, const float* dts, double* lc) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    double carry = 0.0;
    for (int base = 0; base < qp; base += 32) {
      double v = dts[base + tid] * a;  // dt A rounded as the reference does
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      lc[base + tid] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// rows [0, nrows) of chunk c0's (L, G, N) bf16 array B or C for group gg
// into a shared tile of row stride NP + 8; rows >= qn and columns >= n zero
template <int NP>
__device__ void load_bc(bf16* dst, const bf16* src, const TcParams& prm,
                        int b, int c0, int gg, int row0, int nrows, int qn,
                        int tid, int nthreads) {
  constexpr int kChunks = NP / 8, LD = NP + 8;
  for (int i = tid; i < nrows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks, t = row0 + r;
    const bool ok = t < qn && c * 8 < prm.n;
    mma::cp_async16(
        dst + r * LD + c * 8,
        ok ? src + (((int64_t)b * prm.l + c0 + t) * prm.g + gg) * prm.n + c * 8
           : src,
        ok ? 16 : 0);
  }
}

// The C B^T scratch of one (batch, chunk, group): the 16 x 16 blocks (t16,
// s16 <= t16) of the lower block triangle, block (t16, s16) at index
// t16 (t16 + 1) / 2 + s16, 256 floats each in mma fragment order.
__host__ __device__ constexpr int64_t cb_block(int t16, int s16) {
  return (int64_t)t16 * (t16 + 1) / 2 + s16;
}
__host__ __device__ constexpr int64_t cb_floats(int qp) {
  return cb_block(qp / 16, 0) * 256;
}

// C B^T of every (chunk, group, batch), lower block triangle, in float32:
// grid (nc x QP / 64, G, Bt), warp w of CTA z computing rows t0 = 64 z +
// 16 w against s < t0 + 16. Shared by the H / G heads of the group.
template <int NP>
__global__ void __launch_bounds__(kCbThreads) ssd_cb_kernel(TcParams prm) {
  constexpr int LD = NP + 8;
  const int tg = (prm.qp + kCbRows - 1) / kCbRows;
  const int c = blockIdx.x / tg, z = blockIdx.x % tg;
  const int gg = blockIdx.y, b = blockIdx.z;
  const int c0 = c * prm.chunk, qn = min(prm.chunk, prm.l - c0);
  const int t_lo = z * kCbRows;
  if (t_lo >= qn) return;
  const int s_rows = min(t_lo + kCbRows, prm.qp);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // kCbRows x LD
  bf16* bs = cs + kCbRows * LD;                  // s_rows x LD
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  load_bc<NP>(cs, prm.cm, prm, b, c0, gg, t_lo, kCbRows, qn, tid, kCbThreads);
  load_bc<NP>(bs, prm.bm, prm, b, c0, gg, 0, s_rows, qn, tid, kCbThreads);
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();

  const int t0 = t_lo + warp * 16;
  if (t0 >= qn) return;
  uint32_t cf[NP / 16][4];
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
    mma::ldmatrix_x4(cf[kk], cs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                 (lane >> 4) * 8);
  float* out = prm.cb + (((int64_t)b * prm.nc + c) * prm.g + gg) * cb_floats(prm.qp);
  for (int s16 = 0; s16 <= t0 / 16; ++s16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      uint32_t bf[4];
      mma::ldmatrix_x4(bf, bs + (s16 * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      mma::mma_bf16(acc[0], cf[kk], bf[0], bf[1]);
      mma::mma_bf16(acc[1], cf[kk], bf[2], bf[3]);
    }
    // fragment-major: the block's A fragment registers e = 0..3 of lane L
    // (rows + 8 (e & 1), columns + 8 (e >> 1)) at 8 L .. 8 L + 7
    float4* blk = reinterpret_cast<float4*>(out + cb_block(t0 / 16, s16) * 256) + 2 * lane;
    blk[0] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
    blk[1] = make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
  }
}

// rows [0, qp) of chunk c0's x for head hh into a shared tile of row
// stride PP + 8 with cp.async; rows >= qn and columns >= p zero
template <int PP>
__device__ void load_x(bf16* dst, const TcParams& prm, int b, int c0, int hh,
                       int qn, int tid) {
  for (int i = tid; i < prm.qp * (PP / 8); i += kTcThreads) {
    const int s = i / (PP / 8), c8 = i % (PP / 8);
    const bool ok = s < qn && c8 * 8 < prm.p;
    mma::cp_async16(
        dst + s * (PP + 8) + c8 * 8,
        ok ? prm.x + (((int64_t)b * prm.l + c0 + s) * prm.h + hh) * prm.p + c8 * 8
           : prm.x,
        ok ? 16 : 0);
  }
}

// 8 bf16 in shared memory times w, rounded to bf16 in place
__device__ __forceinline__ void scale8(bf16* p, float w) {
  uint4 v = *reinterpret_cast<uint4*>(p);
  uint32_t* u = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u[j]));
    u[j] = mma::pack_bf16(w * f.x, w * f.y);
  }
  *reinterpret_cast<uint4*>(p) = v;
}

template <int NP, int PP>
struct TcShape {
  static constexpr int LDN = NP + 8, LDP = PP + 8;
  static size_t state_smem(int qp) {
    return sizeof(double) * qp + sizeof(float) * qp +
           sizeof(bf16) * (size_t)qp * (LDN + LDP);
  }
  static size_t scan_smem(int qp) {
    return sizeof(double) * qp + 2 * sizeof(float) * qp +
           sizeof(bf16) * ((size_t)qp * LDP + (size_t)NP * LDP);
  }
  static size_t cb_smem(int qp) {
    return sizeof(bf16) * (size_t)(kCbRows + qp) * LDN;
  }
};

// Each chunk's state contribution sum_s B_s^T (w_s x_s), w_s = dt_s
// exp(lc_end - lc_s), float32 into states, and exp(lc_end) into decay:
// grid (nc, H, Bt), warps over 16-row slabs of N.
template <int NP, int PP>
__global__ void __launch_bounds__(kTcThreads) ssd_state_kernel(TcParams prm) {
  using S = TcShape<NP, PP>;
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int gg = hh / (prm.h / prm.g);
  const int c0 = c * prm.chunk, qn = min(prm.chunk, prm.l - c0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* lc = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(lc + prm.qp);
  bf16* bs = reinterpret_cast<bf16*>(dts + prm.qp);  // qp x LDN
  bf16* wx = bs + prm.qp * S::LDN;                   // qp x LDP
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_dt(prm, b, hh, c0, qn, dts);
  mma::cp_async_commit();
  load_bc<NP>(bs, prm.bm, prm, b, c0, gg, 0, prm.qp, qn, tid, kTcThreads);
  load_x<PP>(wx, prm, b, c0, hh, qn, tid);
  mma::cp_async_commit();
  mma::cp_async_wait<1>();  // dt has landed; B and x are on their way
  __syncthreads();
  prefix_scan(prm.qp, prm.a[hh], dts, lc);
  const double lc_end = lc[qn - 1];
  if (tid == 0)
    prm.decay[((int64_t)b * prm.h + hh) * prm.nc + c] = (float)exp(lc_end);
  // w_s = dt_s exp(lc_end - lc_s) in place of dt_s (0 past qn)
  for (int i = tid; i < prm.qp; i += kTcThreads)
    dts[i] *= expf((float)(lc_end - lc[i]));
  mma::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < prm.qp * (PP / 8); i += kTcThreads) {
    const int s = i / (PP / 8);  // past qn: zeros stay zeros
    scale8(wx + s * S::LDP + (i % (PP / 8)) * 8, dts[s]);
  }
  __syncthreads();

  const int ksteps = (qn + 15) / 16;
  float* out = prm.states + (((int64_t)b * prm.h + hh) * prm.nc + c) * prm.n * prm.p;
  for (int slab = warp; slab < NP / 16; slab += kTcThreads / 32) {
    float acc[PP / 8][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];  // B^T: the (s, n) tile read transposed
      mma::ldmatrix_x4_trans(af, bs + (ks * 16 + (lane >> 4) * 8 + (lane & 7)) * S::LDN +
                                     slab * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, wx + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LDP +
                                       pp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * pp], af, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * pp + 1], af, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int nrow = slab * 16 + lane / 4 + 8 * r;
      if (nrow >= prm.n) continue;
#pragma unroll
      for (int j = 0; j < PP / 8; ++j) {
        const int col = j * 8 + 2 * (lane & 3);
        if (col < prm.p)
          *reinterpret_cast<float2*>(out + (int64_t)nrow * prm.p + col) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// The sequential pass over chunks: entering[c] = S_c, the state entering
// chunk c, S_c = exp(lc_end,c-1) S_{c-1} + contribution_{c-1}, S_0 = 0,
// summed in float32 and stored rounded to bf16 (the chunk scan's operand).
// grid (N P / 1024, H, Bt), four elements a thread.
__global__ void __launch_bounds__(256) ssd_pass_kernel(TcParams prm) {
  const int64_t np = (int64_t)prm.n * prm.p;
  const int64_t i = ((int64_t)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= np) return;
  const int64_t bh = (int64_t)blockIdx.z * prm.h + blockIdx.y;
  const float* contrib = prm.states + bh * prm.nc * np + i;
  bf16* out = prm.entering + bh * prm.nc * np + i;
  const float* dec = prm.decay + bh * prm.nc;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < prm.nc; ++c) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(s.x, s.y),
                           __floats2bfloat162_rn(s.z, s.w)};
    *reinterpret_cast<uint2*>(out + c * np) = *reinterpret_cast<uint2*>(h);
    const float4 v = __ldg(reinterpret_cast<const float4*>(contrib + c * np));
    const float e = dec[c];
    s = make_float4(e * s.x + v.x, e * s.y + v.y, e * s.z + v.z, e * s.w + v.w);
  }
}

// y of each chunk: exp(lc_t) C_t S_prev + ((C B^T) . M . dt_s) x + D x on
// the causal block triangle, grid (nc, H, Bt), warps over 16-row slabs of
// t paired from both ends of the triangle (w and 15 - w) for balance.
template <int NP, int PP>
__global__ void __launch_bounds__(kTcThreads, PP <= 64 ? 2 : 1)
ssd_chunk_scan_kernel(TcParams prm) {
  using S = TcShape<NP, PP>;
  const int c = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int gg = hh / (prm.h / prm.g);
  const int c0 = c * prm.chunk, qn = min(prm.chunk, prm.l - c0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* lc = reinterpret_cast<double*>(smem_raw);
  float* dts = reinterpret_cast<float*>(lc + prm.qp);
  float* gs = dts + prm.qp;  // dt_s exp(lc_end(block of s) - lc_s)
  bf16* xs = reinterpret_cast<bf16*>(gs + prm.qp);   // qp x LDP
  bf16* sb = xs + prm.qp * S::LDP;                   // NP x LDP: S_prev
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_dt(prm, b, hh, c0, qn, dts);
  load_x<PP>(xs, prm, b, c0, hh, qn, tid);
  // the state entering the chunk, rounded to bf16 by the pass (its low part
  // changes the bf16 gate's worst error little: ref.ssd_three_stage_ref);
  // rows >= N and columns >= P zero
  const bf16* sg = prm.entering + (((int64_t)b * prm.h + hh) * prm.nc + c) * prm.n * prm.p;
  for (int i = tid; i < NP * (PP / 8); i += kTcThreads) {
    const int r = i / (PP / 8), c8 = i % (PP / 8);
    const bool ok = r < prm.n && c8 * 8 < prm.p;
    mma::cp_async16(sb + r * S::LDP + c8 * 8,
                    ok ? sg + (int64_t)r * prm.p + c8 * 8 : sg, ok ? 16 : 0);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
  prefix_scan(prm.qp, prm.a[hh], dts, lc);
  // off the diagonal M[t,s] dt_s = exp(lc_t - lc_e) g_s, e the last step of
  // s's 16-step block: both exponents <= 0, so the factors cannot overflow
  for (int i = tid; i < prm.qp; i += kTcThreads)
    gs[i] = dts[i] * expf((float)(lc[i | 15] - lc[i]));
  __syncthreads();

  const int nslab = (qn + 15) / 16;
  const float* cbg = prm.cb + (((int64_t)b * prm.nc + c) * prm.g + gg) * cb_floats(prm.qp);
  const float dskip = prm.d != nullptr ? prm.d[hh] : 0.f;
  constexpr int kW = kTcThreads / 32;
  for (int j = 0; kW * j < nslab; ++j) {
    const int slab = kW * j + ((j & 1) ? kW - 1 - warp : warp);
    if (slab >= nslab) continue;
    const int t0 = slab * 16, tr = t0 + lane / 4;
    float acc[PP / 8][4] = {};
    // inter-chunk term: C_t S_prev, then times exp(lc_t). C is read
    // as A fragments straight from global memory (L2: a chunk's C serves
    // the group's heads), all of the slab's at once
    const bf16* crow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tr + 8 * r;
      crow[r] = t < qn ? prm.cm + (((int64_t)b * prm.l + c0 + t) * prm.g + gg) * prm.n
                       : nullptr;
    }
    auto c_frag = [&](int kk, uint32_t (&af)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kk * 16 + 8 * (e >> 1) + 2 * (lane & 3);
        const bf16* row = crow[e & 1];
        af[e] = row != nullptr && col < prm.n
                    ? __ldg(reinterpret_cast<const unsigned int*>(row + col))
                    : 0u;
      }
    };
    uint32_t cf[NP / 16][4];  // every C fragment of the slab in one round trip
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) c_frag(kk, cf[kk]);
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, sb + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LDP +
                                       pp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * pp], cf[kk], bf[0], bf[1]);
        mma::mma_bf16(acc[2 * pp + 1], cf[kk], bf[2], bf[3]);
      }
    }
    const double lt[2] = {lc[tr], lc[tr + 8]};
    const float et[2] = {expf((float)lt[0]), expf((float)lt[1])};
#pragma unroll
    for (int q = 0; q < PP / 8; ++q) {
      acc[q][0] *= et[0];
      acc[q][1] *= et[0];
      acc[q][2] *= et[1];
      acc[q][3] *= et[1];
    }
    // intra-chunk term, 16 steps s at a time up to the diagonal; the C B^T
    // blocks (fragment order: two coalesced float4 a lane) are loaded from
    // L2 two blocks ahead of the one computed
    const float4* cb_slab = reinterpret_cast<const float4*>(cbg + cb_block(slab, 0) * 256) + 2 * lane;
    const int col0 = 2 * (lane & 3);
    float4 n0 = __ldg(cb_slab), n1 = __ldg(cb_slab + 1);  // block s16 + 1
    float4 m0 = n0, m1 = n1;                                 // block s16 + 2
    if (slab >= 1) {
      m0 = __ldg(cb_slab + 64);
      m1 = __ldg(cb_slab + 65);
    }
    for (int s16 = 0; s16 <= slab; ++s16) {
      const float4 c0 = n0, c1 = n1;
      n0 = m0;
      n1 = m1;
      if (s16 + 2 <= slab) {
        m0 = __ldg(cb_slab + 64 * (s16 + 2));
        m1 = __ldg(cb_slab + 64 * (s16 + 2) + 1);
      }
      const float2 cur[4] = {make_float2(c0.x, c0.y), make_float2(c0.z, c0.w),
                             make_float2(c1.x, c1.y), make_float2(c1.z, c1.w)};
      uint32_t whi[4], wlo[4];
      const bool diag = s16 == slab;
      float ht[2] = {0.f, 0.f};  // exp(lc_t - lc_e), e = 16 s16 + 15 < t
      if (!diag) {
        const double le = lc[s16 * 16 + 15];
        ht[0] = expf((float)(lt[0] - le));
        ht[1] = expf((float)(lt[1] - le));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + 8 * (e & 1);
        const int s = s16 * 16 + 8 * (e >> 1) + col0;
        float w0, w1;
        if (diag) {
          // exponentiate only where s <= t: the exponent is <= 0 there
          w0 = s <= t ? cur[e].x * expf((float)(lt[e & 1] - lc[s])) * dts[s] : 0.f;
          w1 = s + 1 <= t ? cur[e].y * expf((float)(lt[e & 1] - lc[s + 1])) * dts[s + 1] : 0.f;
        } else {
          const float2 g = *reinterpret_cast<const float2*>(gs + s);
          w0 = cur[e].x * ht[e & 1] * g.x;
          w1 = cur[e].y * ht[e & 1] * g.y;
        }
        const __nv_bfloat162 hi = __floats2bfloat162_rn(w0, w1);
        const float2 hf = __bfloat1622float2(hi);
        whi[e] = *reinterpret_cast<const uint32_t*>(&hi);
        wlo[e] = mma::pack_bf16(w0 - hf.x, w1 - hf.y);
      }
#pragma unroll
      for (int pp = 0; pp < PP / 16; ++pp) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, xs + (s16 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S::LDP +
                                       pp * 16 + (lane >> 4) * 8);
        mma::mma_bf16(acc[2 * pp], whi, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * pp + 1], whi, bf[2], bf[3]);
        mma::mma_bf16(acc[2 * pp], wlo, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * pp + 1], wlo, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = tr + 8 * r;
      if (t >= qn) continue;
      const int64_t row = (((int64_t)b * prm.l + c0 + t) * prm.h + hh) * prm.p;
#pragma unroll
      for (int q = 0; q < PP / 8; ++q) {
        const int col = q * 8 + 2 * (lane & 3);
        if (col >= prm.p) continue;
        float v0 = acc[q][2 * r], v1 = acc[q][2 * r + 1];
        if (prm.d != nullptr) {  // x from its shared tile
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + t * S::LDP + col));
          v0 += dskip * xv.x;
          v1 += dskip * xv.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(prm.y + row + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// raise a kernel's dynamic shared memory limit to `bytes` if it is lower
// (`limit` remembers what was set, so a repeated shape costs no call)
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, size_t& limit) {
  if (bytes <= limit) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) limit = bytes;
  return err;
}

template <int NP, int PP>
int launch_tc(const TcParams& prm, cudaStream_t st) {
  using S = TcShape<NP, PP>;
  const size_t cb_b = S::cb_smem(prm.qp), state_b = S::state_smem(prm.qp),
               scan_b = S::scan_smem(prm.qp);
  static size_t limit[3] = {0, 0, 0};
  cudaError_t err;
  if ((err = set_smem(ssd_cb_kernel<NP>, cb_b, limit[0])) ||
      (err = set_smem(ssd_state_kernel<NP, PP>, state_b, limit[1])) ||
      (err = set_smem(ssd_chunk_scan_kernel<NP, PP>, scan_b, limit[2])))
    return (int)err;
  ssd_cb_kernel<NP><<<dim3(prm.nc * ((prm.qp + kCbRows - 1) / kCbRows), prm.g, prm.bt),
                      kCbThreads, cb_b, st>>>(prm);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_state_kernel<NP, PP><<<dim3(prm.nc, prm.h, prm.bt), kTcThreads, state_b, st>>>(prm);
  if ((err = cudaGetLastError())) return (int)err;
  const int np4 = (prm.n * prm.p / 4 + 255) / 256;
  ssd_pass_kernel<<<dim3(np4, prm.h, prm.bt), 256, 0, st>>>(prm);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_chunk_scan_kernel<NP, PP><<<dim3(prm.nc, prm.h, prm.bt), kTcThreads, scan_b, st>>>(prm);
  return (int)cudaGetLastError();
}

// the padded widths a shape runs at: powers of two from 16
constexpr int pad_np(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : n <= 128 ? 128 : 256; }
constexpr int pad_pp(int p) { return p <= 16 ? 16 : p <= 32 ? 32 : p <= 64 ? 64 : 128; }

template <int NP>
int tc_by_p(int p, const TcParams& prm, cudaStream_t st, size_t* smem) {
  switch (pad_pp(p)) {
#define SSD_CASE(PP)                                                        \
  case PP:                                                                  \
    if (smem) {                                                             \
      using S = TcShape<NP, PP>;                                            \
      size_t m = S::cb_smem(prm.qp);                                        \
      if (S::state_smem(prm.qp) > m) m = S::state_smem(prm.qp);             \
      if (S::scan_smem(prm.qp) > m) m = S::scan_smem(prm.qp);               \
      *smem = m;                                                            \
      return 0;                                                             \
    }                                                                       \
    return launch_tc<NP, PP>(prm, st);
    SSD_CASE(16)
    SSD_CASE(32)
    SSD_CASE(64)
    SSD_CASE(128)
#undef SSD_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// launch (smem == null) or report the shared memory the launch needs
int tc_dispatch(const TcParams& prm, cudaStream_t st, size_t* smem) {
  switch (pad_np(prm.n)) {
    case 16: return tc_by_p<16>(prm.p, prm, st, smem);
    case 32: return tc_by_p<32>(prm.p, prm, st, smem);
    case 64: return tc_by_p<64>(prm.p, prm, st, smem);
    case 128: return tc_by_p<128>(prm.p, prm, st, smem);
    case 256: return tc_by_p<256>(prm.p, prm, st, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool tc_shape_ok(int bt, int l, int h, int g, int n, int p, int chunk,
                 int qp) {
  return bt >= 0 && l >= 0 && h > 0 && g > 0 && h % g == 0 && n > 0 &&
         n <= 256 && n % 8 == 0 && p > 0 && p <= 128 && p % 8 == 0 &&
         chunk > 0 && qp == round_up(chunk, 32);
}

}  // namespace

// Chunk rows rounded up (the cb scratch is (Bt, nc, G) x cb_floats(qp)).
extern "C" int ssd_scan_bf16_chunk_pad(int chunk) { return round_up(chunk, 32); }

// Shared memory (bytes) the bf16 kernels need at state dim n, head dim p
// and chunk length chunk (the largest of the three); -1 if out of range.
extern "C" long long ssd_scan_bf16_smem_bytes(int n, int p, int chunk) {
  const int qp = round_up(chunk, 32);
  if (!tc_shape_ok(1, 1, 1, 1, n, p, chunk, qp)) return -1;
  TcParams prm{};
  prm.n = n;
  prm.p = p;
  prm.chunk = chunk;
  prm.qp = qp;
  size_t bytes = 0;
  if (tc_dispatch(prm, nullptr, &bytes) != 0) return -1;
  return (long long)bytes;
}

// bfloat16 x, B, C and y; float32 dt, A and D (d may be null). Scratch
// from the wrapper: cb (Bt, nc, G, cb_floats(qp)) float32, states (Bt, H,
// nc, N, P) float32 followed by as many bf16, decay (Bt, H, nc) float32,
// nc = ceil(L / chunk), qp =
// ssd_scan_bf16_chunk_pad(chunk). Four launches on the stream: C B^T, the
// chunk states, the state pass, the chunk scan.
extern "C" int ssd_scan_bf16_launch(const void* x, const void* dt,
                                    const void* a, const void* bm,
                                    const void* cm, const void* d, void* y,
                                    void* cb, void* states, void* decay,
                                    int bt, int l, int h, int g, int n, int p,
                                    int chunk, int qp, void* stream) {
  if (!tc_shape_ok(bt, l, h, g, n, p, chunk, qp))
    return (int)cudaErrorInvalidValue;
  if (bt == 0 || l == 0) return (int)cudaSuccess;
  const int64_t n_states = (int64_t)bt * h * ((l + chunk - 1) / chunk) * n * p;
  TcParams prm{static_cast<const bf16*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(a), static_cast<const bf16*>(bm),
               static_cast<const bf16*>(cm), static_cast<const float*>(d),
               static_cast<bf16*>(y), static_cast<float*>(cb),
               static_cast<float*>(states),
               reinterpret_cast<bf16*>(static_cast<float*>(states) + n_states),
               static_cast<float*>(decay),
               bt, l, h, g, n, p, chunk, (l + chunk - 1) / chunk, qp};
  return tc_dispatch(prm, reinterpret_cast<cudaStream_t>(stream), nullptr);
}


// Shared memory (bytes) the float32 kernel needs for state dim n, head dim p and
// chunk length chunk; the wrapper checks it against the card's limit.
extern "C" long long ssd_scan_smem_bytes(int n, int p, int chunk) {
  return (long long)smem_bytes(n, p, chunk);
}

// The float32 kernel (CUDA cores): x, B, C, y, dt, A and D all float32, d
// may be null. Every array is contiguous in the documented layout.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* d,
                               void* y, int bt, int l, int h, int g, int n,
                               int p, int chunk, void* stream) {
  if (bt < 0 || l < 0 || h <= 0 || g <= 0 || h % g != 0 || n <= 0 ||
      p <= 0 || p > 128 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if (bt == 0 || l == 0) return (int)cudaSuccess;
  Params prm{x, static_cast<const float*>(dt), static_cast<const float*>(a),
             bm, cm, static_cast<const float*>(d), y, bt, l, h, g, n, p,
             chunk};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return dispatch<float>(prm, st);
}
