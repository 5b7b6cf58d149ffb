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
// Two halves after FlashAttention-2's split, a fixed function of the
// dtype at every head dim of the forward (16, 32, 64, 80, 96, 128):
//  - dq: one block per (b, h, 64-row q-tile).  It writes delta for its
//    rows, then walks the kv tiles its rows can see, recomputing S and P
//    from the LSE, and accumulates dq.
//  - dk and dv: one block per (b, kv head, 64-row kv tile[, split]).  It
//    walks query heads of its GQA group and, for each, the q-tiles that
//    can see its kv rows, and accumulates dk and dv: no atomics, so the
//    result does not depend on the order of blocks.  It reads the delta
//    the dq half wrote, so it runs second.
// Both apply the forward's masks: causal (i >= j), window (i - j <
// window), columns >= Sk and rows >= Sq; a row that sees no key (lse =
// +inf from the bf16 forward) has P = 0 in every column, so it adds
// nothing and gets a zero gradient, never NaN.
//
// What bounds it on this card: operations.  At qwen2-1.5b's call (2, 4096,
// 12, 2, 128), causal, the least work is five products over the visible
// pairs (S again, dP, dq, dk, dv): 2.5 x the forward's 103.1 GFLOP =
// 257.7 GFLOP, 0.261 ms at 989 TFLOP/s of bf16 tensor-core work.  The dq
// half does 3 of them (S, dP, dq), the dk/dv half 4 (S, dP, dv, dk).
//
// bfloat16: flash_bwd_dq_wgmma and flash_bwd_dkdv_wgmma, after
// FlashAttention-3's backward less its atomics.  Every product runs on
// the tensor cores with wgmma; the tiles come in by TMA (one 5-D tensor
// map per q, dO, k, v, hopper.cuh) into a ring of mbarrier stages refilled
// by the last warp out, so the next tiles are in flight while one is
// computed.  A block is one warpgroup (128 threads) on 64 rows, which is
// wgmma's M; as many ring stages as let two blocks share an SM (2 at D =
// 128, 3 below), so one block's elementwise work overlaps the other's
// products.
//  - flash_bwd_dq_wgmma holds its Q and dO tiles; for each kv tile,
//    S = Q K^T and dP = dO V^T are wgmma_ss<64> (both operands K-major),
//    dS is rounded to bf16 in registers (the m64nN accumulator layout is
//    the register-A layout) and dQ += dS K is wgmma_rs<D> with K read
//    N-major: the forward's P V form.  dQ of one tile and S, dP of the
//    next are issued together.  delta comes from o and dO at the block's
//    start, four threads a row.  ptxas: 174 registers at D = 128, no
//    spills.
//  - flash_bwd_dkdv_wgmma holds its K and V tiles; for each q-tile of
//    each of its query heads, S^T = K Q^T and dP^T = V dO^T are
//    wgmma_ss<64> (the forward's S = Q K^T with the roles swapped), then
//    P^T = 2^(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//    delta), both rounded to bf16 in registers, and dV += P^T dO and
//    dK += dS^T Q are wgmma_rs<D>.  The q-tile's lse and delta come from
//    global memory (L2), two of each a lane, loaded before the stage's
//    wait and written to the warp's own row of shared memory, which the
//    score loop reads two columns at a time.  Registers at D = 128: dK
//    and dV 64 f32 a thread each, S^T and dP^T 32 each; ptxas: 234, no
//    spills.
//  What still bounds them: each wgmma_ss<64> reads 4 KB of shared memory
//  per 32 tensor-core cycles, the SM's whole 128 B a cycle, and the score
//  loop (one ex2 a score, 16 a cycle per SM) runs between the products
//  of a warpgroup.  At the prefill call the pair reaches about 43 % of
//  its bound (PERF.md).
//  - The GQA split: at a training call (2, 2048, 12, 2, 128) one block
//    per (b, kv head, kv tile) is 128 blocks for 132 SMs, one a SM, with
//    the heaviest causal kv tile doing twice the mean work.  So the block
//    is split over `splits` parts of the group (flash_attention.py::
//    dkdv_splits: the smallest divisor of the group giving two blocks per
//    SM; 3 there, 384 blocks).  With splits > 1 each block writes float32
//    partials (splits, B, Sk, Hkv, D) of dk and dv, and
//    flash_bwd_dkdv_sum adds them in split order into bf16: still no
//    atomics, and two runs are bitwise equal.  On an H100 80GB HBM3
//    (700 W; tools/flash_bwd_variants.py --splits=1,2,3,6) the wrapper,
//    sum included, takes 0.375 / 0.216 / 0.159 / 0.157 ms at the
//    training call and 0.81 / 0.47 / 0.51 / 0.52 ms at (2, 4096) for 1
//    / 2 / 3 / 6 parts: the rule's 3 and 2.
//  Lowest causal kv tiles and heaviest q-tiles go first.  TMA's zero fill
//  stands in for rows >= Sq and >= Sk, which the masks also drop, so a
//  non-causal call takes any Sk (whisper's Sk = 1500): no dk or dv row
//  >= Sk is written.  At D = 96 the tiles are three 32-column blocks
//  with the 64-byte swizzle and dQ, dK, dV are m64n96k16 products.
//
// float32: flash_bwd_dq and flash_bwd_dkdv, scalar float32 FMAs from
// shared memory (a float32 product on the tensor cores would be TF32 and
// miss the float32 tolerance), with a 4 x 4 register tile per thread of
// each 64 x 64 score tile.
//
// Layout: q, o, dO, dq are packed (B, Sq, H, D), k, v, dk, dv packed
// (B, Sk, Hkv, D), lse and delta packed (B, H, Sq) float32.  The Python
// wrapper makes every input contiguous before the launch and allocates
// the split partials.
//
// Plain C interface, loaded with ctypes: each *_launch returns the
// cudaError_t of its launches (0 on success); a shape, type or head size
// it does not take returns cudaErrorInvalidValue before launching.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps
#include <math.h>

namespace {

constexpr int kBq = 64, kBk = 64, kThreads = 256;

struct Problem {
  int B, Sq, Sk, H, Hkv, group, causal, window;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: TMA ring + wgmma, one warpgroup (128 threads) on 64 rows.
// Warp w holds rows 16 w + g and 16 w + g + 8 (g = lane / 4) of a 64-row
// accumulator, columns 8 j + 2 (lane % 4) + {0, 1} of its n8 tile j.
// Shared memory: the block's two fixed tiles (Q and dO, or K and V), then
// STAGES stages of the two tiles it walks over (K and V, or Q and dO),
// then each stage's full barrier and counter and the fixed tiles'
// barrier, the base aligned to 1024 bytes (the 128-byte swizzle's period).
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kSmemSM = 233472;   // shared memory of one SM (228 KB)
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct BwdGeo : Swizzle<D> {
  static constexpr int ROWS = 64;            // rows of every tile
  static constexpr int TILE = ROWS * D * 2;  // bytes of one bf16 tile
  static constexpr int BAR_BYTES = 64;
  // the dkdv kernel's q-tile lse and delta, one copy per warp
  static constexpr int ROW_BYTES = 4 * 2 * ROWS * 4;
  // two blocks per SM, each with 1 KB of the SM reserved and 1 KB of
  // alignment slack: 2 stages at D = 128, at most 3
  static constexpr int STAGES_FIT =
      (kSmemSM / 2 - 2048 - BAR_BYTES - ROW_BYTES - 2 * TILE) / (2 * TILE);
  static constexpr int STAGES = STAGES_FIT < 3 ? STAGES_FIT : 3;
  static constexpr int BAR_OFF = (2 + 2 * STAGES) * TILE;
  static constexpr int ROW_OFF = BAR_OFF + BAR_BYTES;
  static constexpr int SMEM = ROW_OFF + ROW_BYTES + 1024;
  static_assert(STAGES >= 2 && 8 * (2 * STAGES + 1) <= BAR_BYTES,
                "tiles do not fit two blocks per SM");
};

struct BwdArgs {
  Problem p;
  int splits;                       // parts of each GQA group (dk, dv)
  const float* lse;                 // (B, H, Sq)
  float* delta;                     // (B, H, Sq): dq writes, dkdv reads
  const __nv_bfloat16* o;           // dq: o and dO for delta
  const __nv_bfloat16* dout;
  void* out0;                       // dq; or dk, or dk's f32 partials
  void* out1;                       // dv, or dv's f32 partials
};

// Two tiles of one (head, b) from row `row` into stage s of the ring,
// completing on the stage's full barrier.
template <int D>
__device__ __forceinline__ void load_pair(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          uint32_t ring, uint32_t bar,
                                          int head, int row, int b, int s) {
  constexpr int T = BwdGeo<D>::TILE;
  const uint32_t full = bar + 8 * s, dst = ring + 2 * s * T;
  mbar_expect_tx(full, 2 * T);
  tma_tile(dst, ta, head, row, b, full);
  tma_tile(dst + T, tb, head, row, b, full);
}

// Thread 0 sets up the ring's barriers (full: one arrival plus the
// bytes; the counters at 0) and the fixed tiles' barrier.
__device__ __forceinline__ void init_barriers(uint32_t bar, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(bar + 8 * (stages + s))
                   : "memory");
    }
    mbar_init(bar + 16 * stages, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The k16 steps of X Y^T over D for two K-major (64, D) tiles at a and
// b: a k16 step is 32 bytes into a swizzle row, or the next column block.
template <int D>
__device__ __forceinline__ void product_ss(float* d, uint32_t a,
                                           uint32_t b) {
  using G = BwdGeo<D>;
  constexpr int SW = G::SW, KPB = SW / 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / KPB) * G::ROWS * SW + (kk % KPB) * 32;
    wgmma_ss<G::ROWS>(d, make_desc<SW>(a + off, 16, 8 * SW),
                      make_desc<SW>(b + off, 16, 8 * SW), kk > 0);
  }
}

// d (64, D) += A B for A (64, 64) bf16 in registers and B a (64, D) tile
// read N-major (transposed): a k16 step is 16 rows on, the next swizzle
// atom along D the next column block.
template <int D>
__device__ __forceinline__ void product_rs(float* d, const uint32_t (*a)[4],
                                           uint32_t b) {
  using G = BwdGeo<D>;
  constexpr int SW = G::SW;
#pragma unroll
  for (int kk = 0; kk < G::ROWS / 16; ++kk)
    wgmma_rs<D>(d, a[kk],
                make_desc<SW>(b + kk * 16 * SW, G::ROWS * SW, 8 * SW));
}

// An m64n64 f32 accumulator as bf16 in the register-A layout: n8 tiles
// 2 kk and 2 kk + 1 are k16 step kk.
__device__ __forceinline__ void to_reg_a(const float* x, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// sum_d o[row, d] dO[row, d] over the four threads (lane % 4 = tg) of a
// row, each reading every fourth 16-byte chunk; 0 for an invalid row.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* o,
                                         const __nv_bfloat16* dout,
                                         long long off, bool valid, int tg) {
  float acc = 0.f;
  if (valid) {
    for (int c = tg; c < D / 8; c += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + off + 8 * c);
      const uint4 y = *reinterpret_cast<const uint4*>(dout + off + 8 * c);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fx = __bfloat1622float2(xa[e]);
        const float2 fy = __bfloat1622float2(ya[e]);
        acc = fmaf(fx.x, fy.x, acc);
        acc = fmaf(fx.y, fy.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, BwdArgs a,
                       int n_qt) {
  using G = BwdGeo<D>;
  constexpr int R = G::ROWS, ST = G::STAGES, T = G::TILE;
  constexpr int NS = R / 8, NO = D / 8;  // n8 tiles of S and of dq
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + T;
  const uint32_t ring = sQ + 2 * T;  // stage s: K, then V
  const uint32_t bar = sQ + G::BAR_OFF, fbar = bar + 16 * ST;
  const Problem& p = a.p;

  // heaviest causal q-tiles (the longest kv walk) first
  const int bh = blockIdx.x % (p.B * p.H), it = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? n_qt - 1 - it : it;
  const int h = bh % p.H, b = bh / p.H, hk = h / p.group;
  const int q0 = qt * R;
  int kv_lo = 0, kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + R, p.Sq));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  const int t_lo = kv_lo / R;
  const int n_t = kv_hi > kv_lo ? (kv_hi + R - 1) / R - t_lo : 0;

  init_barriers(bar, ST);
  if (threadIdx.x == 0 && n_t > 0) {
    mbar_expect_tx(fbar, 2 * T);
    tma_tile(sQ, &tq, h, q0, b, fbar);
    tma_tile(sdO, &tdo, h, q0, b, fbar);
    for (int i = 0; i < ST && i < n_t; ++i)
      load_pair<D>(&tk, &tv, ring, bar, hk, (t_lo + i) * R, b, i);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wr = q0 + 16 * warp;  // the warp's first row
  const int r0 = wr + g, r1 = r0 + 8;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
  const long long pitch = static_cast<long long>(p.H) * D;  // q, o rows
  const long long head0 = static_cast<long long>(b) * p.Sq * pitch + h * D;
  // delta = rowsum(dO o), written for the dkdv half; the rows' LSE
  const float d0 = row_dot<D>(a.o, a.dout, head0 + r0 * pitch, r0 < p.Sq, tg);
  const float d1 = row_dot<D>(a.o, a.dout, head0 + r1 * pitch, r1 < p.Sq, tg);
  if (tg == 0) {
    if (r0 < p.Sq) a.delta[row_base + r0] = d0;
    if (r1 < p.Sq) a.delta[row_base + r1] = d1;
  }
  const float l0 = r0 < p.Sq ? a.lse[row_base + r0] * kLog2e : 0.f;
  const float l1 = r1 < p.Sq ? a.lse[row_base + r1] * kLog2e : 0.f;
  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x log2 e)

  // Iteration i issues dQ += dS K of kv tile i and S, dP of tile i + 1
  // together, waits for both and leaves tile i's stage; S and dP of tile
  // 0 go first.
  float acc[NO * 4], sc[NS * 4], dp[NS * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  if (n_t > 0) {
    mbar_wait(fbar, 0);
    mbar_wait(bar, 0);
    __syncwarp();  // converged for the .aligned wgmma instructions
    wgmma_fence();
    product_ss<D>(sc, sQ, ring);       // S = Q K^T
    product_ss<D>(dp, sdO, ring + T);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NS * 4>(sc);
    fence_regs<NS * 4>(dp);
  }
  for (int i = 0; i < n_t; ++i) {
    const int s = i % ST, k0 = (t_lo + i) * R;
    const uint32_t sK = ring + 2 * s * T;
    // a tile that every row of the warp sees whole needs no mask
    const bool whole = k0 + R <= p.Sk && wr + 16 <= p.Sq &&
                       (!p.causal || k0 + R - 1 <= wr) &&
                       (p.window <= 0 || wr + 15 - k0 < p.window);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        float pv = ex2(fmaf(sc[x], scale2, -(e < 2 ? l0 : l1)));
        if (!whole && !visible(p, e < 2 ? r0 : r1, k0 + 8 * j + 2 * tg +
                                                       (e & 1)))
          pv = 0.f;
        sc[x] = pv * (dp[x] - (e < 2 ? d0 : d1));  // dS
      }
    }
    uint32_t ds[R / 16][4];
    to_reg_a(sc, ds);
    wgmma_fence();
    product_rs<D>(acc, ds, sK);  // dQ += dS K
    if (i + 1 < n_t) {
      const int s1 = (i + 1) % ST;
      const uint32_t sK1 = ring + 2 * s1 * T;
      mbar_wait(bar + 8 * s1, ((i + 1) / ST) & 1);
      __syncwarp();
      product_ss<D>(sc, sQ, sK1);
      product_ss<D>(dp, sdO, sK1 + T);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NO * 4>(acc);
    fence_regs<NS * 4>(sc);
    fence_regs<NS * 4>(dp);
    fence_regs<R / 4>(&ds[0][0]);
    __syncwarp();
    if (lane == 0 && last_to_leave<4>(bar + 8 * (ST + s)) && i + ST < n_t)
      load_pair<D>(&tk, &tv, ring, bar, hk, (t_lo + i + ST) * R, b, s);
  }

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.out0) + head0;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(dq + r0 * pitch + c) =
          pack_bf16(acc[4 * n] * p.scale, acc[4 * n + 1] * p.scale);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(dq + r1 * pitch + c) =
          pack_bf16(acc[4 * n + 2] * p.scale, acc[4 * n + 3] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 2)
    flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         BwdArgs a) {
  using G = BwdGeo<D>;
  constexpr int R = G::ROWS, ST = G::STAGES, T = G::TILE;
  constexpr int NS = R / 8, NO = D / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sV = sK + T;
  const uint32_t ring = sK + 2 * T;  // stage s: Q, then dO
  const uint32_t bar = sK + G::BAR_OFF, fbar = bar + 16 * ST;
  const Problem& p = a.p;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warp's copy of the q-tile's lse (times log2 e), then its delta
  float* rows = reinterpret_cast<float*>(
                    smem_raw + (sK - smem_u32(smem_raw)) + G::ROW_OFF) +
                2 * R * warp;

  // kv tile 0 is seen by every causal q-tile: lowest tiles first
  const int per = p.B * p.Hkv * a.splits;
  const int kt = blockIdx.x / per, rest = blockIdx.x % per;
  const int sp = rest % a.splits, hk = rest / a.splits % p.Hkv,
            b = rest / a.splits / p.Hkv;
  const int k0 = kt * R;
  const int nh = p.group / a.splits, h0 = hk * p.group + sp * nh;
  // q rows that can see columns [k0, min(k0 + R, Sk)): causal rows >= k0,
  // window rows < last column + window
  const int row_lo = p.causal ? k0 : 0;
  int row_hi = p.Sq;
  if (p.window > 0) row_hi = min(row_hi, min(k0 + R, p.Sk) - 1 + p.window);
  const int qt_lo = row_lo / R;
  const int n_qt = row_hi > row_lo ? (row_hi + R - 1) / R - qt_lo : 0;
  const int n_it = nh * n_qt;  // (query head, q-tile) steps

  init_barriers(bar, ST);
  if (threadIdx.x == 0 && n_it > 0) {
    mbar_expect_tx(fbar, 2 * T);
    tma_tile(sK, &tk, hk, k0, b, fbar);
    tma_tile(sV, &tv, hk, k0, b, fbar);
    for (int i = 0; i < ST && i < n_it; ++i)
      load_pair<D>(&tq, &tdo, ring, bar, h0 + i / n_qt,
                   (qt_lo + i % n_qt) * R, b, i);
  }

  const int g = lane >> 2, tg = lane & 3;
  const int kw = k0 + 16 * warp;  // the warp's first kv row
  const int kr0 = kw + g, kr1 = kr0 + 8;
  const float scale2 = p.scale * kLog2e;

  float dk[NO * 4], dv[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) dk[i] = dv[i] = 0.f;
  if (n_it > 0) mbar_wait(fbar, 0);
  for (int i = 0; i < n_it; ++i) {
    const int h = h0 + i / n_qt, q0 = (qt_lo + i % n_qt) * R;
    const int s = i % ST;
    const uint32_t sQ = ring + 2 * s * T, sdO = sQ + T;
    // the q-tile's lse (times log2 e) and delta, rows q0 + lane and
    // q0 + 32 + lane, read while the stage's tiles land and the products
    // run
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    const int qa = q0 + lane, qb = qa + 32;
    const float la = qa < p.Sq ? a.lse[row_base + qa] * kLog2e : 0.f;
    const float lb = qb < p.Sq ? a.lse[row_base + qb] * kLog2e : 0.f;
    const float da = qa < p.Sq ? a.delta[row_base + qa] : 0.f;
    const float db = qb < p.Sq ? a.delta[row_base + qb] : 0.f;
    mbar_wait(bar + 8 * s, (i / ST) & 1);
    __syncwarp();

    float st[NS * 4], dpt[NS * 4];
    wgmma_fence();
    product_ss<D>(st, sK, sQ);    // S^T = K Q^T
    product_ss<D>(dpt, sV, sdO);  // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NS * 4>(st);
    fence_regs<NS * 4>(dpt);
    rows[lane] = la;
    rows[32 + lane] = lb;
    rows[R + lane] = da;
    rows[R + 32 + lane] = db;
    __syncwarp();

    const bool whole = kw + 16 <= p.Sk && q0 + R <= p.Sq &&
                       (!p.causal || kw + 15 <= q0) &&
                       (p.window <= 0 || q0 + R - 1 - kw < p.window);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j +
                                                           2 * tg);
      const float2 d2 = *reinterpret_cast<const float2*>(rows + R + 8 * j +
                                                           2 * tg);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const int qc = 8 * j + 2 * tg + (e & 1);  // q row in the tile
        const float l = e & 1 ? l2.y : l2.x, dl = e & 1 ? d2.y : d2.x;
        float pv = ex2(fmaf(st[x], scale2, -l));
        if (!whole && !visible(p, q0 + qc, e < 2 ? kr0 : kr1)) pv = 0.f;
        st[x] = pv;                     // P^T
        dpt[x] = pv * (dpt[x] - dl);    // dS^T
      }
    }
    uint32_t pa[R / 16][4], dsa[R / 16][4];
    to_reg_a(st, pa);
    to_reg_a(dpt, dsa);
    wgmma_fence();
    product_rs<D>(dv, pa, sdO);  // dV += P^T dO
    product_rs<D>(dk, dsa, sQ);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NO * 4>(dv);
    fence_regs<NO * 4>(dk);
    fence_regs<R / 4>(&pa[0][0]);
    fence_regs<R / 4>(&dsa[0][0]);
    __syncwarp();
    if (lane == 0 && last_to_leave<4>(bar + 8 * (ST + s)) && i + ST < n_it)
      load_pair<D>(&tq, &tdo, ring, bar, h0 + (i + ST) / n_qt,
                   (qt_lo + (i + ST) % n_qt) * R, b, s);
  }

  // dk and dv rows: bf16 into the outputs, or f32 into split sp's partials
  const long long pitch = static_cast<long long>(p.Hkv) * D;
  const long long base =
      (static_cast<long long>(a.splits > 1 ? sp * p.B + b : b) * p.Sk) *
          pitch + hk * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tg * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? kr1 : kr0;
      if (row >= p.Sk) continue;
      const long long off = base + row * pitch + c;
      const float k0v = dk[4 * n + 2 * half] * p.scale;
      const float k1v = dk[4 * n + 2 * half + 1] * p.scale;
      const float v0v = dv[4 * n + 2 * half], v1v = dv[4 * n + 2 * half + 1];
      if (a.splits > 1) {
        *reinterpret_cast<float2*>(static_cast<float*>(a.out0) + off) =
            make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(static_cast<float*>(a.out1) + off) =
            make_float2(v0v, v1v);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out0) +
                                     off) = pack_bf16(k0v, k1v);
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(a.out1) +
                                     off) = pack_bf16(v0v, v1v);
      }
    }
  }
}

// dk and dv as bf16 from the splits' f32 partials part = (2, splits, n):
// dk's, then dv's; summed in split order, four elements a thread.
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum(const float* __restrict__ part,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, long long n,
                       int splits) {
  const long long n4 = n / 4;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int which = i >= n4;
    const long long j = i - which * n4;
    const float4* src =
        reinterpret_cast<const float4*>(part) + which * splits * n4 + j;
    float4 acc = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = src[s * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    uint2 out;
    out.x = pack_bf16(acc.x, acc.y);
    out.y = pack_bf16(acc.z, acc.w);
    *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * j) = out;
  }
}

bool bad_problem(int dtype, const Problem& p) {
  return p.B <= 0 || p.Sq <= 0 || p.Sk <= 0 || p.Hkv <= 0 ||
         p.H % p.Hkv != 0 || (dtype != 0 && dtype != 1);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, const Problem& p,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<D, float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + kBq - 1) / kBq;
  const long long blocks = static_cast<long long>(n_qt) * p.B * p.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq<D, float><<<static_cast<unsigned>(blocks), kThreads, smem,
                           stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
      p, n_qt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv,
                        const Problem& p, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<D, float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_kt = (p.Sk + kBk - 1) / kBk;
  const long long blocks = static_cast<long long>(n_kt) * p.B * p.Hkv;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dkdv<D, float><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), p);
  return cudaGetLastError();
}

// The four tensor maps of a bf16 call, each read in 64-row boxes: q and
// dO (B, Sq, H, D), k and v (B, Sk, Hkv, D), all packed.
template <int D>
bool encode_maps(CUtensorMap* m, const void* q, const void* dout,
                 const void* k, const void* v, const Problem& p) {
  const int rows = BwdGeo<D>::ROWS;
  const long long qs = static_cast<long long>(p.H) * D;
  const long long ks = static_cast<long long>(p.Hkv) * D;
  return encode_map<D>(m, q, p.H, p.Sq, p.B, D, qs, qs * p.Sq, rows) &&
         encode_map<D>(m + 1, dout, p.H, p.Sq, p.B, D, qs, qs * p.Sq,
                       rows) &&
         encode_map<D>(m + 2, k, p.Hkv, p.Sk, p.B, D, ks, ks * p.Sk, rows) &&
         encode_map<D>(m + 3, v, p.Hkv, p.Sk, p.B, D, ks, ks * p.Sk, rows);
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* delta, void* dq, const Problem& p,
                           cudaStream_t stream) {
  using G = BwdGeo<D>;
  CUtensorMap m[4];
  if (!encode_maps<D>(m, q, dout, k, v, p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + G::ROWS - 1) / G::ROWS;
  const long long blocks = static_cast<long long>(n_qt) * p.B * p.H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const BwdArgs a{p, 1, lse, delta,
                  static_cast<const __nv_bfloat16*>(o),
                  static_cast<const __nv_bfloat16*>(dout), dq, nullptr};
  flash_bwd_dq_wgmma<D><<<static_cast<unsigned>(blocks), kWgThreads,
                          G::SMEM, stream>>>(m[0], m[1], m[2], m[3], a,
                                             n_qt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             const Problem& p, int splits, float* part,
                             cudaStream_t stream) {
  using G = BwdGeo<D>;
  if (splits < 1 || p.group % splits != 0 || (splits > 1 && !part))
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!encode_maps<D>(m, q, dout, k, v, p)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  const int n_kt = (p.Sk + G::ROWS - 1) / G::ROWS;
  const long long blocks =
      static_cast<long long>(n_kt) * p.B * p.Hkv * splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long n = static_cast<long long>(p.B) * p.Sk * p.Hkv * D;
  const BwdArgs a{p, splits, lse, const_cast<float*>(delta), nullptr,
                  nullptr, splits > 1 ? static_cast<void*>(part) : dk,
                  splits > 1 ? static_cast<void*>(part + splits * n) : dv};
  flash_bwd_dkdv_wgmma<D><<<static_cast<unsigned>(blocks), kWgThreads,
                            G::SMEM, stream>>>(m[0], m[1], m[2], m[3], a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  // 2 n elements, four a thread, in a grid-stride loop of at most 16
  // blocks per SM of this card
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long threads = n / 2, most = 16LL * sms;
  const unsigned grid = static_cast<unsigned>(
      threads / 256 + 1 < most ? threads / 256 + 1 : most);
  flash_bwd_dkdv_sum<<<grid, 256, 0, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      n, splits);
  return cudaGetLastError();
}

#define FLASH_BWD_SWITCH(D, CALL)                                    \
  switch (D) {                                                       \
    case 16: return CALL(16);                                        \
    case 32: return CALL(32);                                        \
    case 64: return CALL(64);                                        \
    case 80: return CALL(80);                                        \
    case 96: return CALL(96);                                        \
    case 128: return CALL(128);                                      \
    default: return cudaErrorInvalidValue;                           \
  }

cudaError_t dq_by_dim(int dtype, int D, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const float* lse, float* delta, void* dq,
                      const Problem& p, cudaStream_t s) {
#define DQ_CALL(DIM)                                                    \
  (dtype == 0                                                           \
       ? launch_dq<DIM>(q, k, v, o, dout, lse, delta, dq, p, s)         \
       : launch_dq_bf16<DIM>(q, k, v, o, dout, lse, delta, dq, p, s))
  FLASH_BWD_SWITCH(D, DQ_CALL)
#undef DQ_CALL
}

cudaError_t dkdv_by_dim(int dtype, int D, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv,
                        const Problem& p, int splits, float* part,
                        cudaStream_t s) {
#define DKDV_CALL(DIM)                                                    \
  (dtype == 0 ? launch_dkdv<DIM>(q, k, v, dout, lse, delta, dk, dv, p, s) \
              : launch_dkdv_bf16<DIM>(q, k, v, dout, lse, delta, dk, dv,  \
                                      p, splits, part, s))
  FLASH_BWD_SWITCH(D, DKDV_CALL)
#undef DKDV_CALL
}

// info of kernel `which` (0 dq, 1 dkdv, 2 the split sum) of a (dtype, D)
// call
template <int D>
cudaError_t info_of(int dtype, int which, int* info) {
  if (dtype == 0)
    return static_cast<cudaError_t>(
        which == 0 ? kernel_info(flash_bwd_dq<D, float>, dq_smem_bytes<D>(),
                                 info)
        : which == 1
            ? kernel_info(flash_bwd_dkdv<D, float>, dkdv_smem_bytes<D>(),
                          info)
            : static_cast<int>(cudaErrorInvalidValue));
  return static_cast<cudaError_t>(
      which == 0   ? kernel_info(flash_bwd_dq_wgmma<D>, BwdGeo<D>::SMEM, info)
      : which == 1 ? kernel_info(flash_bwd_dkdv_wgmma<D>, BwdGeo<D>::SMEM,
                                 info)
                   : kernel_info(flash_bwd_dkdv_sum, 0, info));
}

cudaError_t info_by_dim(int dtype, int D, int which, int* info) {
#define INFO_CALL(DIM) info_of<DIM>(dtype, which, info)
  FLASH_BWD_SWITCH(D, INFO_CALL)
#undef INFO_CALL
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

// splits: parts of each GQA group (bf16 only; 1 for float32), part: the
// (2, splits, B, Sk, Hkv, D) float32 scratch when splits > 1, else null.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int dtype, int B,
                                     int Sq, int Sk, int H, int Hkv, int D,
                                     int causal, int window, float scale,
                                     int splits, void* part, void* stream) {
  const Problem p{B, Sq, Sk, H, Hkv, Hkv > 0 ? H / Hkv : 0, causal, window,
                  scale};
  if (bad_problem(dtype, p) || (dtype == 0 && splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dkdv_by_dim(
      dtype, D, q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, p, splits,
      static_cast<float*>(part), static_cast<cudaStream_t>(stream)));
}

// Registers per thread, shared memory per block (static + dynamic) and
// local memory per thread (spills, stack) of kernel `which` (0 dq, 1 dkdv,
// 2 bf16's split sum) of a (dtype, D) call, into info[0..2].  Returns a
// cudaError_t.
extern "C" int flash_bwd_kernel_info(int dtype, int D, int which,
                                     int* info) {
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(info_by_dim(dtype, D, which, info));
}
