// Blocked attention backward for Hopper (sm_90a): the gradient of
// flash_attention.cu's forward with respect to q, k and v.
//
// The Pallas TPU kernel it belongs to, src/repro/kernels/flash_attention.py
// (pl.pallas_call in flash_attention, file line 139), has no backward: the
// reference trains through models/layers.py::blocked_attention and lets
// XLA differentiate it.  The port's model calls the CUDA forward, so its
// gradient is a kernel too.  For the forward's
//   P[i, j] = exp(q_i . k_j scale - lse_i)  over the visible (i, j),
//   o_i = sum_j P[i, j] v_j,
// with lse_i the row's log-sum-exp that the forward writes, and dO the
// output's gradient:
//   delta_i = sum_d dO[i, d] o[i, d]
//   dP[i, j] = dO_i . v_j,   dS[i, j] = P[i, j] (dP[i, j] - delta_i)
//   dq_i = scale sum_j dS[i, j] k_j
//   dk_j = scale sum_i dS[i, j] q_i,   dv_j = sum_i P[i, j] dO_i
// where k_j and v_j are the kv head of query head h, h / (H / Hkv), and
// dk and dv sum over the H / Hkv query heads of that group.
//
// Two kernels, after FlashAttention-2's split, both scalar float32 FMAs
// from shared memory, for float32 and bfloat16 inputs (accumulation in
// float32, outputs in the input's type), every head dim of the forward:
//  - flash_bwd_dq: one block per (b, h, 64-row q-tile).  It writes delta
//    for its rows, then walks the kv tiles its rows can see, recomputing
//    S and P from the LSE, and accumulates dq in registers.
//  - flash_bwd_dkdv: one block per (b, kv head, 64-row kv tile).  It
//    walks the query heads of its GQA group and, for each, the q-tiles
//    that can see its kv rows, and accumulates dk and dv in registers:
//    no atomics, so the result does not depend on the order of blocks.
//    It reads the delta the first kernel wrote, so it runs second.
// Both apply the forward's masks: causal (i >= j), window (i - j <
// window) and columns >= Sk; a row that sees no key has P = 0 in every
// column, so it adds nothing (its forward output is zeros in bfloat16).
//
// What bounds it on this card: operations.  At qwen2-1.5b's call (2, 4096,
// 12, 2, 128), causal, the least work is five products over the visible
// pairs (S again, dP, dq, dk, dv): 2.5 x the forward's 103.1 GFLOP =
// 257.7 GFLOP, 0.261 ms at 989 TFLOP/s of bf16 tensor-core work.  This
// first version does its products on the float32 pipes, not the tensor
// cores (67 TFLOP/s at most), with a 4 x 4 register tile per thread of
// each 64 x 64 score tile; it is right first and leaves speed (mma or
// wgmma on bf16 tiles, TMA) to a later change.
//
// Layout: q, o, dO, dq are packed (B, Sq, H, D), k, v, dk, dv packed
// (B, Sk, Hkv, D), lse and delta packed (B, H, Sq) float32.  The Python
// wrapper makes every input contiguous before the launch.
//
// Plain C interface, loaded with ctypes: each *_launch returns the
// cudaError_t of its launch (0 on success); a shape, type or head size it
// does not take returns cudaErrorInvalidValue before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64, kBk = 64, kThreads = 256;

struct Problem {
  int B, Sq, Sk, H, Hkv, group, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Problem& p, int row, int col) {
  bool ok = row < p.Sq && col < p.Sk;
  if (p.causal) ok = ok && col <= row;
  if (p.window > 0) ok = ok && row - col < p.window;
  return ok;
}

// rows [s0, s0 + kBq) of head h of a packed (B, S, NH, D) tensor into a
// float32 tile of pitch D + 1 (column reads of 16 rows hit 16 banks);
// rows >= S read as zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int s0, int h, int S, int NH) {
  for (int idx = threadIdx.x; idx < kBq * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    float x = 0.f;
    if (s0 + r < S)
      x = to_f(src[((static_cast<long long>(b) * S + s0 + r) * NH + h) * D +
                   c]);
    dst[r * (D + 1) + c] = x;
  }
}

// Thread (ty, tx) of the 16 x 16 thread grid owns rows ty + 16 a and
// columns tx + 16 c of a 64 x 64 score tile (a, c < 4):
//   s[a][c] = A[ty + 16 a] . X[tx + 16 c],  e[a][c] = E[ty + 16 a] . Y[...]
// over the D features of two pairs of float32 tiles of pitch D + 1.
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* X,
                                             const float* E, const float* Y,
                                             int ty, int tx, float (*s)[4],
                                             float (*e)[4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = e[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], ev[4], xv[4], yv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      av[a] = A[(ty + 16 * a) * DP + d];
      ev[a] = E[(ty + 16 * a) * DP + d];
      xv[a] = X[(tx + 16 * a) * DP + d];
      yv[a] = Y[(tx + 16 * a) * DP + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = fmaf(av[a], xv[c], s[a][c]);
        e[a][c] = fmaf(ev[a], yv[c], e[a][c]);
      }
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * kBq * (D + 1) + kBq * (kBk + 1) + 2 * kBq);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(float) * (4 * kBq * (D + 1) + 2 * kBq * (kBk + 1) + 2 * kBq);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq, Problem p,
                 int n_qt) {
  constexpr int DP = D + 1, PP = kBk + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBq * DP;
  float* sK = sdO + kBq * DP;
  float* sV = sK + kBk * DP;
  float* sdS = sV + kBk * DP;
  float* sL = sdS + kBq * PP;
  float* sD = sL + kBq;

  // heaviest causal q-tiles (the longest kv walk) first
  const int bh = blockIdx.x % (p.B * p.H), it = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? n_qt - 1 - it : it;
  const int h = bh % p.H, b = bh / p.H, hk = h / p.group;
  const int q0 = qt * kBq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long row_base = static_cast<long long>(b) * p.H + h;  // lse

  load_tile<D>(sQ, q, b, q0, h, p.Sq, p.H);
  load_tile<D>(sdO, dout, b, q0, h, p.Sq, p.H);
  {  // delta = rowsum(dO o): four threads per row
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const int row = q0 + r;
    float acc = 0.f;
    if (row < p.Sq) {
      const long long off =
          ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
      for (int c = part; c < D; c += 4)
        acc = fmaf(to_f(o[off + c]), to_f(dout[off + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sD[r] = acc;
      sL[r] = row < p.Sq ? lse[row_base * p.Sq + row] : 0.f;
      if (row < p.Sq) delta[row_base * p.Sq + row] = acc;
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  // the kv tiles rows [q0, q0 + kBq) can see
  int kv_lo = 0, kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + kBq, p.Sq));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  const int t_lo = kv_lo / kBk;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + kBk - 1) / kBk : t_lo;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBk;
    __syncthreads();  // the previous tile's sK, sV and sdS are read
    load_tile<D>(sK, k, b, k0, hk, p.Sk, p.Hkv);
    load_tile<D>(sV, v, b, k0, hk, p.Sk, p.Hkv);
    __syncthreads();
    float s[4][4], dp[4][4];
    two_products<D>(sQ, sK, sdO, sV, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c;
        const float pv = visible(p, q0 + r, k0 + col)
                             ? __expf(fmaf(s[a][c], p.scale, -sL[r]))
                             : 0.f;
        sdS[r * PP + col] = pv * (dp[a][c] - sD[r]);
      }
    }
    __syncthreads();
    // dq[r, tx + 16 c] += sum_j dS[r, j] k[j, tx + 16 c]
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = sdS[(ty + 16 * a) * PP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sK[j * DP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(ds[a], kv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Sq) continue;
    T* dst = dq + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) put(dst + tx + 16 * c, acc[a][c] * p.scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Problem p) {
  constexpr int DP = D + 1, PP = kBk + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBk * DP;
  float* sQ = sV + kBk * DP;
  float* sdO = sQ + kBq * DP;
  float* sP = sdO + kBq * DP;
  float* sdS = sP + kBq * PP;
  float* sL = sdS + kBq * PP;
  float* sD = sL + kBq;

  // kv tile 0 is seen by every causal q-tile: lowest tiles first
  const int bh = blockIdx.x % (p.B * p.Hkv), kt = blockIdx.x / (p.B * p.Hkv);
  const int hk = bh % p.Hkv, b = bh / p.Hkv;
  const int k0 = kt * kBk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<D>(sK, k, b, k0, hk, p.Sk, p.Hkv);
  load_tile<D>(sV, v, b, k0, hk, p.Sk, p.Hkv);

  // rows that can see columns [k0, min(k0 + kBk, Sk)): causal rows
  // >= k0, window rows < last column + window
  const int col_hi = min(k0 + kBk, p.Sk);  // one past the last column
  int row_lo = p.causal ? k0 : 0;
  int row_hi = p.Sq;
  if (p.window > 0) row_hi = min(row_hi, col_hi - 1 + p.window);
  const int qt_lo = row_lo / kBq;
  const int qt_hi = row_hi > row_lo ? (row_hi + kBq - 1) / kBq : qt_lo;

  // thread (ty, tx) owns kv rows ty + 16 a and features tx + 16 c
  float ak[4][NC], av[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) ak[a][c] = av[a][c] = 0.f;

  for (int r = 0; r < p.group; ++r) {
    const int h = hk * p.group + r;
    const long long row_base = static_cast<long long>(b) * p.H + h;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBq;
      __syncthreads();  // the previous q-tile's tiles are read
      load_tile<D>(sQ, q, b, q0, h, p.Sq, p.H);
      load_tile<D>(sdO, dout, b, q0, h, p.Sq, p.H);
      if (threadIdx.x < kBq) {
        const int row = q0 + threadIdx.x;
        sL[threadIdx.x] = row < p.Sq ? lse[row_base * p.Sq + row] : 0.f;
        sD[threadIdx.x] = row < p.Sq ? delta[row_base * p.Sq + row] : 0.f;
      }
      __syncthreads();
      // s[a][c], dp[a][c]: q row ty + 16 a against kv row tx + 16 c
      float s[4][4], dp[4][4];
      two_products<D>(sQ, sK, sdO, sV, ty, tx, s, dp);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c;
          const float pv = visible(p, q0 + i, k0 + j)
                               ? __expf(fmaf(s[a][c], p.scale, -sL[i]))
                               : 0.f;
          sP[i * PP + j] = pv;
          sdS[i * PP + j] = pv * (dp[a][c] - sD[i]);
        }
      }
      __syncthreads();
      // dv[j] += sum_i P[i, j] dO[i],  dk[j] += sum_i dS[i, j] q[i]
#pragma unroll 2
      for (int i = 0; i < kBq; ++i) {
        float pj[4], dsj[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pj[a] = sP[i * PP + ty + 16 * a];
          dsj[a] = sdS[i * PP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = sdO[i * DP + tx + 16 * c];
          const float qv = sQ[i * DP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            av[a][c] = fmaf(pj[a], dov, av[a][c]);
            ak[a][c] = fmaf(dsj[a], qv, ak[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + ty + 16 * a;
    if (row >= p.Sk) continue;
    const long long off =
        ((static_cast<long long>(b) * p.Sk + row) * p.Hkv + hk) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      put(dk + off + tx + 16 * c, ak[a][c] * p.scale);
      put(dv + off + tx + 16 * c, av[a][c]);
    }
  }
}

bool bad_problem(int dtype, const Problem& p) {
  return p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.Hkv <= 0 ||
         p.H % p.Hkv != 0 || (dtype != 0 && dtype != 1);
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, const Problem& p,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kBq - 1) / kBq;
  const long long blocks = static_cast<long long>(n_qt) * p.B * p.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq<D, T><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), p, n_qt);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv,
                        const Problem& p, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_kt = (p.Sk + kBk - 1) / kBk;
  const long long blocks = static_cast<long long>(n_kt) * p.B * p.Hkv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkdv<D, T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), p);
  return cudaGetLastError();
}

#define FLASH_BWD_SWITCH(D, CALL)                                    \
  switch (D) {                                                       \
    case 16: return CALL(16);                                        \
    case 32: return CALL(32);                                        \
    case 64: return CALL(64);                                        \
    case 80: return CALL(80);                                        \
    case 128: return CALL(128);                                      \
    default: return cudaErrorInvalidValue;                           \
  }

cudaError_t dq_by_dim(int dtype, int D, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const float* lse, float* delta, void* dq,
                      const Problem& p, cudaStream_t s) {
#define DQ_CALL(DIM)                                                      \
  (dtype == 0 ? launch_dq<DIM, float>(q, k, v, o, dout, lse, delta, dq, p, \
                                      s)                                   \
              : launch_dq<DIM, __nv_bfloat16>(q, k, v, o, dout, lse,       \
                                              delta, dq, p, s))
  FLASH_BWD_SWITCH(D, DQ_CALL)
#undef DQ_CALL
}

cudaError_t dkdv_by_dim(int dtype, int D, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv,
                        const Problem& p, cudaStream_t s) {
#define DKDV_CALL(DIM)                                                     \
  (dtype == 0 ? launch_dkdv<DIM, float>(q, k, v, dout, lse, delta, dk, dv, \
                                        p, s)                              \
              : launch_dkdv<DIM, __nv_bfloat16>(q, k, v, dout, lse, delta,  \
                                                dk, dv, p, s))
  FLASH_BWD_SWITCH(D, DKDV_CALL)
#undef DKDV_CALL
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Every tensor packed, as the header says.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, int dtype, int B,
                                   int Sq, int Sk, int H, int Hkv, int D,
                                   int causal, int window, float scale,
                                   void* stream) {
  const Problem p{B, Sq, Sk, H, Hkv, Hkv > 0 ? H / Hkv : 0, causal, window,
                  scale};
  if (bad_problem(dtype, p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dq_by_dim(
      dtype, D, q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(delta), dq, p, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int dtype, int B,
                                     int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, int window, float scale,
                                     void* stream) {
  const Problem p{B, Sq, Sk, H, Hkv, Hkv > 0 ? H / Hkv : 0, causal, window,
                  scale};
  if (bad_problem(dtype, p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkdv_by_dim(
      dtype, D, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, p,
      static_cast<cudaStream_t>(stream)));
}
