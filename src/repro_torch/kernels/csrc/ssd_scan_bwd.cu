// The gradient of the chunked Mamba-2 SSD scan, for Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel (pl.pallas_call
// in ssd_scan, file line 105) has no backward: the reference trains through
// jax.grad of repro/models/ssd.py::ssd_chunked.  These kernels are that
// gradient for the forward of csrc/ssd_scan.cu.  For x (b, s, nh, hd), dt
// (b, s, nh), A (nh,), B and C (b, s, ds) (one group) and dy = dL/dy, they
// return dx, ddt, dA, dB and dC.  Within a chunk of Q steps, with a_k =
// dt_k A, seg(j, i] the sum of a over j+1..i, L_ij = exp(seg(j, i]) for
// j <= i (0 above the diagonal), e_i = exp(seg(-1, i]), u_j =
// exp(seg(j, Q-1]), P the state entering the chunk and dS the gradient of
// the state leaving it, the forward is
//   y_i   = sum_{j<=i} L_ij (C_i . B_j) dt_j x_j + e_i C_i . P
//   S_end = e_{Q-1} P + sum_j u_j dt_j x_j B_j^T
// and the backward runs in four kernels:
//   1. ssd_bwd_chunk_state, one block per (b, chunk, head): the chunk's own
//      share of the state, S_c = (u dt x)^T B, and its dy-side state
//      gradient, G_c = (e dy)^T C, two (hd x Q) . (Q x ds) products, and
//      the chunk's decay e_{Q-1}, to scratch.
//   2. ssd_bwd_state_pass, one thread per state entry of a (b, head): the
//      forward recurrence over chunks, P_c = carry, carry = carry dec_c +
//      S_c, written over S_c in f32 (the bf16 forward keeps P only as bf16
//      hi + lo planes: the backward recomputes it), then the reverse one,
//      dS_c = D, D = G_c + dec_c D, written over G_c.
//   3. ssd_bwd_chunk, one block per (b, chunk, head): with dyx_ij = dy_i .
//      x_j and s_ij = C_i . B_j on 32 x 32 tiles of the chunk,
//        dx_j  = sum_i L_ij s_ij dt_j dy_i + u_j dt_j (dS B_j)
//        ddt_j = sum_i L_ij s_ij dyx_ij + u_j x_j . (dS B_j) + A da_j
//        dC_i  = sum_j L_ij dt_j dyx_ij B_j + e_i P^T dy_i   (this head's)
//        dB_j  = sum_i L_ij dt_j dyx_ij C_i + u_j dt_j dS^T x_j  (this head's)
//      and the exponent gradient da_k, collected over every segment that
//      holds step k: M_ij = L_ij s_ij dt_j dyx_ij over j < k <= i, e_i de_i
//      over i >= k (de_i = C_i . P^T dy_i), e_{Q-1} (dS . P) for every k,
//      and u_j du_j over j < k (du_j = dt_j x_j . dS B_j).  A pass over row
//      tiles gives dC and de; a pass over column tiles gives dx, dB, ddt
//      and da, and the block's share of dA, sum_k dt_k da_k.  dx and ddt
//      are written where they belong; dB, dC and dA go to per-head
//      partials.
//   4. ssd_bwd_sum: dB and dC summed over heads, dA over (b, chunk), each
//      in a fixed order.
// No atomics anywhere: two runs are bitwise equal.
//
// Exponent precision (C3).  As in the forward, every exponent is a sum of
// same-sign terms (dt > 0 > A): below the diagonal tile seg(j, i] = (rest of
// j's tile) + (whole tiles between) + (start of i's tile up to i), and on it
// each segment is summed on its own.  da_k's intra-chunk term is never a
// difference of running sums: each row's M is prefix-summed over j (carried
// from tile to tile), and the prefixes are summed down the column over
// i >= k.  Entries above the diagonal are set to 0 without an exponent, so
// a decay that underflows gives a zero gradient, never a NaN.
//
// What bounds it.  Every product is float32 FMAs on the CUDA cores from
// shared memory (a 16 x 16 thread grid, as the forward's ssd_scan_kernel),
// so it is bound by operations: at mamba2-1.3b's training call (1, 2048,
// 64, 64, 128), chunk 256, it does 32.5 GFLOP, 2.1x the least work of
// 15.3 GFLOP.  dy x^T is formed twice per tile pair and head (once per
// pass), and C B^T and the dB and dC products once per head, where the
// least work forms them once per chunk on the weights summed over heads
// (B and C are shared by every head).  The tensor cores, as the forward's
// bf16 path uses them, and the sum over heads before the dB and dC
// products are later steps.
//
// Plain C interface, loaded with ctypes: the launcher returns the first
// cudaError_t of its four launches (0 if all launched) and each in err[4];
// a size, chunk or type it does not take returns cudaErrorInvalidValue
// before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kT = 32;         // rows of a row or column tile
constexpr int kTP = kT + 1;    // padded row of a T x T tile
constexpr int kRT = kT / 16;   // tile rows (and columns) per thread
constexpr int kMaxChunk = 256;
constexpr int kMaxTiles = kMaxChunk / kT;
constexpr int kPassThreads = 256;
constexpr int kSumThreads = 256;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const void* dy;
  void* dx;     // (b, s, nh, hd) in x's type
  float* ddt;   // (b, s, nh)
  float* dA;    // (nh,)
  void* dB;     // (b, s, ds) in B's type
  void* dC;     // (b, s, ds) in C's type
  float* st;    // (b, nc, nh, hd, ds): S_c, then P_c
  float* gs;    // (b, nc, nh, hd, ds): G_c, then dS_c
  float* dec;   // (b, nc, nh): exp(seg(-1, Q-1])
  float* dbp;   // (nh, b, s, ds): each head's dB
  float* dcp;   // (nh, b, s, ds): each head's dC
  float* dap;   // (b, nc, nh): each block's share of dA
  long long xb, xs, xh;  // element strides of x over (b, s, h); hd is 1
  long long yb, ys, yh;  // of dy
  long long db, ds, dh;  // of dt
  long long bb, bs;      // of B over (b, s); ds is 1
  long long cb, cs;      // of C
  int batch, S, H, chunk, nc;
  int x_bf16, dy_bf16, bc_bf16;
};

__device__ __forceinline__ float load(const void* p, long long i,
                                      int is_bf16) {
  return is_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float v,
                                      int is_bf16) {
  if (is_bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The sum of v over the 16 threads of a row of the thread grid (16
// neighbouring lanes of one warp), in a fixed order.
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The per-step exponents of one chunk from sA (its Q values of dt A), every
// one a sum of same-sign terms: sPre[k] = a over [k's tile start, k], sSuf[k]
// = a over (k, k's tile end), sTot[t] = tile t's sum and sTot[kMaxTiles] the
// chunk's; sIn[k] = exp(seg(-1, k]), sEnd[k] = exp(seg(k, Q-1]).  Ends
// synchronised.
__device__ void chunk_exponents(const float* sA, float* sPre, float* sSuf,
                                float* sTot, float* sIn, float* sEnd, int Q,
                                int T) {
  const int tid = threadIdx.x, nt = Q / T;
  if (tid < Q) {
    const int ts = tid - tid % T;
    float pre = 0.f, suf = 0.f;
    for (int k = ts; k <= tid; ++k) pre += sA[k];
    for (int k = tid + 1; k < ts + T; ++k) suf += sA[k];
    sPre[tid] = pre;
    sSuf[tid] = suf;
    if (tid == ts + T - 1) sTot[tid / T] = pre;
  }
  __syncthreads();
  if (tid < Q) {
    const int t = tid / T;
    float in = sPre[tid], end = sSuf[tid];
    for (int u = 0; u < t; ++u) in += sTot[u];
    for (int u = t + 1; u < nt; ++u) end += sTot[u];
    sIn[tid] = expf(in);
    sEnd[tid] = expf(end);
  }
  __syncthreads();
  if (tid == 0) {
    float all = 0.f;
    for (int u = 0; u < nt; ++u) all += sTot[u];
    sTot[kMaxTiles] = all;
  }
  __syncthreads();
}

// dt and dt A of one chunk of one (b, head) into shared memory.
__device__ void load_dt(const Args& a, int b, int c, int h, float* sDt,
                        float* sA) {
  const int tid = threadIdx.x, Q = a.chunk;
  if (tid < Q) {
    const float v =
        a.dt[b * a.db + ((long long)c * Q + tid) * a.ds + h * a.dh];
    sDt[tid] = v;
    sA[tid] = v * a.A[h];
  }
  __syncthreads();
}

__device__ __forceinline__ long long state_base(const Args& a, int b, int c,
                                                int h, int hdds) {
  return (((long long)b * a.nc + c) * a.H + h) * hdds;
}

// ---------------------------------------------------------------------------
// 1. The chunk's own state share S_c and its dy-side state gradient G_c
// ---------------------------------------------------------------------------

template <int HD, int DS>
constexpr size_t state_smem_bytes() {
  return sizeof(float) * (2 * kT * HD + 2 * kT * DS);
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_chunk_state(Args a) {
  constexpr int RY = HD / 16, RS = DS / 16;
  extern __shared__ float smem[];
  float* sX = smem;            // [kT][HD] u_j dt_j x_j
  float* sY = sX + kT * HD;    // [kT][HD] e_i dy_i
  float* sB = sY + kT * HD;    // [kT][DS]
  float* sC = sB + kT * DS;    // [kT][DS]
  __shared__ float sA[kMaxChunk], sDt[kMaxChunk], sPre[kMaxChunk],
      sSuf[kMaxChunk], sIn[kMaxChunk], sEnd[kMaxChunk];
  __shared__ float sTot[kMaxTiles + 1];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Q = a.chunk, T = min(Q, kT);
  const long long t0 = (long long)c * Q;
  load_dt(a, b, c, h, sDt, sA);
  chunk_exponents(sA, sPre, sSuf, sTot, sIn, sEnd, Q, T);

  float accS[RY][RS], accG[RY][RS];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int q = 0; q < RS; ++q) accS[r][q] = accG[r][q] = 0.f;

  for (int r0 = 0; r0 < Q; r0 += T) {
    __syncthreads();  // the last tile is no longer read
    for (int idx = tid; idx < T * HD; idx += kThreads) {
      const int r = idx / HD, p = idx % HD;
      const long long t = t0 + r0 + r;
      sX[r * HD + p] = sEnd[r0 + r] * sDt[r0 + r] *
                       load(a.x, b * a.xb + t * a.xs + h * a.xh + p, a.x_bf16);
      sY[r * HD + p] =
          sIn[r0 + r] *
          load(a.dy, b * a.yb + t * a.ys + h * a.yh + p, a.dy_bf16);
    }
    for (int idx = tid; idx < T * DS; idx += kThreads) {
      const int r = idx / DS, n = idx % DS;
      const long long t = t0 + r0 + r;
      sB[r * DS + n] = load(a.B, b * a.bb + t * a.bs + n, a.bc_bf16);
      sC[r * DS + n] = load(a.C, b * a.cb + t * a.cs + n, a.bc_bf16);
    }
    __syncthreads();
    for (int j = 0; j < T; ++j) {
      float xv[RY], yv[RY], bv[RS], cv[RS];
#pragma unroll
      for (int r = 0; r < RY; ++r) {
        xv[r] = sX[j * HD + ty + 16 * r];
        yv[r] = sY[j * HD + ty + 16 * r];
      }
#pragma unroll
      for (int q = 0; q < RS; ++q) {
        bv[q] = sB[j * DS + tx + 16 * q];
        cv[q] = sC[j * DS + tx + 16 * q];
      }
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int q = 0; q < RS; ++q) {
          accS[r][q] = fmaf(xv[r], bv[q], accS[r][q]);
          accG[r][q] = fmaf(yv[r], cv[q], accG[r][q]);
        }
    }
  }
  const long long base = state_base(a, b, c, h, HD * DS);
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      const long long o = base + (ty + 16 * r) * DS + tx + 16 * q;
      a.st[o] = accS[r][q];
      a.gs[o] = accG[r][q];
    }
  if (tid == 0) a.dec[((long long)b * a.nc + c) * a.H + h] =
      expf(sTot[kMaxTiles]);
}

// ---------------------------------------------------------------------------
// 2. The forward and the reverse pass over chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_state_pass(Args a, int hdds) {
  const long long e = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= (long long)a.batch * a.H * hdds) return;
  const int q = static_cast<int>(e % hdds);
  const long long bh = e / hdds;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  float carry = 0.f;
  for (int c = 0; c < a.nc; ++c) {
    const long long o = state_base(a, b, c, h, hdds) + q;
    const float s = a.st[o];
    a.st[o] = carry;  // P_c, the state entering chunk c
    carry = fmaf(carry, a.dec[((long long)b * a.nc + c) * a.H + h], s);
  }
  float d = 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const long long o = state_base(a, b, c, h, hdds) + q;
    const float g = a.gs[o];
    a.gs[o] = d;  // dS_c, the gradient of the state leaving chunk c
    d = fmaf(a.dec[((long long)b * a.nc + c) * a.H + h], d, g);
  }
}

// ---------------------------------------------------------------------------
// 3. dx, ddt, da and the per-head dB, dC of one chunk of one head
// ---------------------------------------------------------------------------

template <int HD, int DS>
constexpr size_t chunk_smem_bytes() {
  return sizeof(float) * (HD * (DS + 1) + 2 * kT * (HD + 1) +
                          2 * kT * (DS + 1) + 5 * kT * kTP);
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, DS < 128 ? 2 : 1)
    ssd_bwd_chunk(Args a) {
  constexpr int RY = HD / 16, RS = DS / 16;
  constexpr int XP = HD + 1;  // padded rows of sX, sY
  constexpr int CP = DS + 1;  // padded rows of sB, sC, sM
  extern __shared__ float smem[];
  float* sM = smem;              // [HD][CP]  P (row pass), dS (column pass)
  float* sX = sM + HD * CP;      // [kT][XP]  x of a column tile
  float* sB = sX + kT * XP;      // [kT][CP]  B of a column tile
  float* sY = sB + kT * CP;      // [kT][XP]  dy of a row tile
  float* sC = sY + kT * XP;      // [kT][CP]  C of a row tile
  float* sW = sC + kT * CP;      // [kT][kTP] L s dt_j
  float* sG = sW + kT * kTP;     // [kT][kTP] L dt_j dyx
  float* sN = sG + kT * kTP;     // [kT][kTP] L s dyx
  float* sMp = sN + kT * kTP;    // [kT][kTP] M, then its row prefixes
  float* sSeg = sMp + kT * kTP;  // [kT][kTP] the diagonal tile's seg(j, i]
  __shared__ float sA[kMaxChunk], sDt[kMaxChunk], sPre[kMaxChunk],
      sSuf[kMaxChunk], sIn[kMaxChunk], sEnd[kMaxChunk];
  __shared__ float sDe[kMaxChunk];   // e_i de_i, then its suffix sums
  __shared__ float sRow[kMaxChunk];  // sum of M_ij over the j done so far
  __shared__ float sDu[kMaxChunk];   // u_j du_j
  __shared__ float sTot[kMaxTiles + 1];
  __shared__ float sNc[kT], sDaT[kT], sXB[kT];
  __shared__ float sRed[kThreads / 32];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Q = a.chunk, T = min(Q, kT), nt = Q / T;
  const long long t0 = (long long)c * Q;
  const float Ah = a.A[h];
  const long long sbase = state_base(a, b, c, h, HD * DS);
  load_dt(a, b, c, h, sDt, sA);
  chunk_exponents(sA, sPre, sSuf, sTot, sIn, sEnd, Q, T);

  // the diagonal tile's segment sums, seg(j, i] over j+1..i, each summed on
  // its own (one thread per row); the caller synchronises
  auto diag_segments = [&](int i0) {
    if (tid < T) {
      float seg = 0.f;
      sSeg[tid * kTP + tid] = 0.f;
      for (int j = tid - 1; j >= 0; --j) {
        seg += sA[i0 + j + 1];
        sSeg[tid * kTP + j] = seg;
      }
    }
  };
  // the decay L_ij of entry (i, j) of row tile it and column tile jt, 0
  // above the diagonal and outside the tile (no exponent taken there)
  auto decay = [&](int it, int jt, int i, int j, float mid) -> float {
    if (i >= T || j >= T) return 0.f;
    if (jt < it) return expf(sPre[it * T + i] + sSuf[jt * T + j] + mid);
    return j <= i ? expf(sSeg[i * kTP + j]) : 0.f;
  };
  auto mid_sum = [&](int jt, int it) {
    float mid = 0.f;
    for (int u = jt + 1; u < it; ++u) mid += sTot[u];
    return mid;
  };
  auto load_rows = [&](float* sx, const void* p, long long pb, long long ps,
                       long long ph, int bf, int r0, float* sm,
                       const void* q, long long qb, long long qs) {
    for (int idx = tid; idx < T * HD; idx += kThreads) {
      const int r = idx / HD, k = idx % HD;
      sx[r * XP + k] =
          load(p, b * pb + (t0 + r0 + r) * ps + h * ph + k, bf);
    }
    for (int idx = tid; idx < T * DS; idx += kThreads) {
      const int r = idx / DS, n = idx % DS;
      sm[r * CP + n] = load(q, b * qb + (t0 + r0 + r) * qs + n, a.bc_bf16);
    }
  };
  // the scores s_ij = C_i . B_j and dyx_ij = dy_i . x_j of the thread's
  // entries (i = ty + 16 r, j = tx + 16 q) of the loaded tiles
  auto scores_cb = [&](float (&s)[kRT][kRT]) {
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int q = 0; q < kRT; ++q) s[r][q] = 0.f;
    for (int n = 0; n < DS; ++n) {
      float cv[kRT], bv[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) cv[r] = sC[(ty + 16 * r) * CP + n];
#pragma unroll
      for (int q = 0; q < kRT; ++q) bv[q] = sB[(tx + 16 * q) * CP + n];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < kRT; ++q) s[r][q] = fmaf(cv[r], bv[q], s[r][q]);
    }
  };
  auto scores_yx = [&](float (&yx)[kRT][kRT]) {
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int q = 0; q < kRT; ++q) yx[r][q] = 0.f;
    for (int p = 0; p < HD; ++p) {
      float yv[kRT], xv[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) yv[r] = sY[(ty + 16 * r) * XP + p];
#pragma unroll
      for (int q = 0; q < kRT; ++q) xv[q] = sX[(tx + 16 * q) * XP + p];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < kRT; ++q) yx[r][q] = fmaf(yv[r], xv[q], yx[r][q]);
    }
  };

  // ---- row pass: this head's dC and de_i, with P in sM ----
  for (int idx = tid; idx < HD * DS; idx += kThreads)
    sM[(idx / DS) * CP + idx % DS] = a.st[sbase + idx];
  for (int it = 0; it < nt; ++it) {
    const int i0 = it * T;
    __syncthreads();  // sY, sC, sG, sB of the last row tile are read
    load_rows(sY, a.dy, a.yb, a.ys, a.yh, a.dy_bf16, i0, sC, a.C, a.cb, a.cs);
    diag_segments(i0);
    __syncthreads();
    // off-diagonal read: dC_i = e_i P^T dy_i, de_i = C_i . P^T dy_i
    float accC[kRT][RS];
#pragma unroll
    for (int r = 0; r < kRT; ++r)
#pragma unroll
      for (int q = 0; q < RS; ++q) accC[r][q] = 0.f;
    for (int p = 0; p < HD; ++p) {
      float yv[kRT], mv[RS];
#pragma unroll
      for (int r = 0; r < kRT; ++r) yv[r] = sY[(ty + 16 * r) * XP + p];
#pragma unroll
      for (int q = 0; q < RS; ++q) mv[q] = sM[p * CP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < RS; ++q) accC[r][q] = fmaf(yv[r], mv[q], accC[r][q]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int i = ty + 16 * r;
      float de = 0.f;
#pragma unroll
      for (int q = 0; q < RS; ++q)
        de = fmaf(accC[r][q], sC[i * CP + tx + 16 * q], de);
      de = row_sum16(de);
      const float e = i < T ? sIn[i0 + i] : 0.f;
      if (tx == 0 && i < T) sDe[i0 + i] = e * de;
#pragma unroll
      for (int q = 0; q < RS; ++q) accC[r][q] *= e;
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * T;
      const float mid = mid_sum(jt, it);
      __syncthreads();  // sX, sB, sG of the last column tile are read
      load_rows(sX, a.x, a.xb, a.xs, a.xh, a.x_bf16, j0, sB, a.B, a.bb, a.bs);
      __syncthreads();
      float yx[kRT][kRT];
      scores_yx(yx);
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < kRT; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          const float l = decay(it, jt, i, j, mid);
          if (i < kT && j < kT)
            sG[i * kTP + j] = l == 0.f ? 0.f : l * yx[r][q] * sDt[j0 + j];
        }
      __syncthreads();
      // dC_i += sum_j L_ij dt_j dyx_ij B_j
      for (int j = 0; j < T; ++j) {
        float gv[kRT], bv[RS];
#pragma unroll
        for (int r = 0; r < kRT; ++r) gv[r] = sG[(ty + 16 * r) * kTP + j];
#pragma unroll
        for (int q = 0; q < RS; ++q) bv[q] = sB[j * CP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kRT; ++r)
#pragma unroll
          for (int q = 0; q < RS; ++q) accC[r][q] = fmaf(gv[r], bv[q], accC[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int i = ty + 16 * r;
      if (i >= T) continue;
      const long long row =
          ((long long)h * a.batch + b) * a.S + t0 + i0 + i;
#pragma unroll
      for (int q = 0; q < RS; ++q) a.dcp[row * DS + tx + 16 * q] = accC[r][q];
    }
  }
  __syncthreads();  // sDe is complete; sM (P) is read for the last time
  // e-side exponent term: sum_{i>=k} e_i de_i, and dE = dS . P with dS
  // loaded into sM
  float es = 0.f;
  if (tid < Q)
    for (int i = Q - 1; i >= tid; --i) es += sDe[i];
  float part = 0.f;
  for (int idx = tid; idx < HD * DS; idx += kThreads) {
    const float dsv = a.gs[sbase + idx];
    part = fmaf(dsv, a.st[sbase + idx], part);
    sM[(idx / DS) * CP + idx % DS] = dsv;
  }
  __syncthreads();
  if (tid < Q) sDe[tid] = es;
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) sRed[tid >> 5] = part;
  if (tid < Q) sRow[tid] = 0.f;
  __syncthreads();
  float dE = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) dE += sRed[w];
  const float dEdec = dE * expf(sTot[kMaxTiles]);

  // ---- column pass: dx, dB, ddt, da with dS in sM ----
  float da_blk = 0.f;  // this thread's share of sum_k dt_k da_k
  for (int jt = 0; jt < nt; ++jt) {
    const int j0 = jt * T;
    __syncthreads();  // the last column tile's vectors and tiles are read
    load_rows(sX, a.x, a.xb, a.xs, a.xh, a.x_bf16, j0, sB, a.B, a.bb, a.bs);
    if (tid < kT) sNc[tid] = sDaT[tid] = 0.f;
    __syncthreads();
    // the end state's share: dS B_j and dS^T x_j
    float accX[kRT][RY], accB[kRT][RS];
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
#pragma unroll
      for (int q = 0; q < RY; ++q) accX[r][q] = 0.f;
#pragma unroll
      for (int q = 0; q < RS; ++q) accB[r][q] = 0.f;
    }
    for (int n = 0; n < DS; ++n) {
      float bv[kRT], mv[RY];
#pragma unroll
      for (int r = 0; r < kRT; ++r) bv[r] = sB[(ty + 16 * r) * CP + n];
#pragma unroll
      for (int q = 0; q < RY; ++q) mv[q] = sM[(tx + 16 * q) * CP + n];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < RY; ++q) accX[r][q] = fmaf(bv[r], mv[q], accX[r][q]);
    }
    for (int p = 0; p < HD; ++p) {
      float xv[kRT], mv[RS];
#pragma unroll
      for (int r = 0; r < kRT; ++r) xv[r] = sX[(ty + 16 * r) * XP + p];
#pragma unroll
      for (int q = 0; q < RS; ++q) mv[q] = sM[p * CP + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < RS; ++q) accB[r][q] = fmaf(xv[r], mv[q], accB[r][q]);
    }
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int j = ty + 16 * r;
      float xb = 0.f;
#pragma unroll
      for (int q = 0; q < RY; ++q)
        xb = fmaf(sX[j * XP + tx + 16 * q], accX[r][q], xb);
      xb = row_sum16(xb);
      const float w = j < T ? sEnd[j0 + j] * sDt[j0 + j] : 0.f;
      if (tx == 0 && j < T) sXB[j] = xb;
#pragma unroll
      for (int q = 0; q < RY; ++q) accX[r][q] *= w;
#pragma unroll
      for (int q = 0; q < RS; ++q) accB[r][q] *= w;
    }
    for (int it = jt; it < nt; ++it) {
      const int i0 = it * T;
      const float mid = mid_sum(jt, it);
      __syncthreads();  // sY, sC, sW, sG, sN, sMp of the last row tile
      load_rows(sY, a.dy, a.yb, a.ys, a.yh, a.dy_bf16, i0, sC, a.C, a.cb,
                a.cs);
      if (it == jt) diag_segments(i0);
      __syncthreads();
      float s[kRT][kRT], yx[kRT][kRT];
      scores_cb(s);
      scores_yx(yx);
#pragma unroll
      for (int r = 0; r < kRT; ++r)
#pragma unroll
        for (int q = 0; q < kRT; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          const float l = decay(it, jt, i, j, mid);
          const float dtj = j < T ? sDt[j0 + j] : 0.f;
          float w = 0.f, g = 0.f, nv = 0.f;
          if (l != 0.f) {
            w = l * s[r][q] * dtj;
            g = l * yx[r][q] * dtj;
            nv = l * s[r][q] * yx[r][q];
          }
          if (i < kT && j < kT) {
            sW[i * kTP + j] = w;
            sG[i * kTP + j] = g;
            sN[i * kTP + j] = nv;
            sMp[i * kTP + j] = nv * dtj;
          }
        }
      __syncthreads();
      // dx_j += sum_i W_ij dy_i, dB_j += sum_i G_ij C_i
      for (int i = 0; i < T; ++i) {
        float wv[kRT], gv[kRT], yv[RY], cv[RS];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
          wv[r] = sW[i * kTP + ty + 16 * r];
          gv[r] = sG[i * kTP + ty + 16 * r];
        }
#pragma unroll
        for (int q = 0; q < RY; ++q) yv[q] = sY[i * XP + tx + 16 * q];
#pragma unroll
        for (int q = 0; q < RS; ++q) cv[q] = sC[i * CP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < kRT; ++r) {
#pragma unroll
          for (int q = 0; q < RY; ++q) accX[r][q] = fmaf(wv[r], yv[q], accX[r][q]);
#pragma unroll
          for (int q = 0; q < RS; ++q) accB[r][q] = fmaf(gv[r], cv[q], accB[r][q]);
        }
      }
      // each row's M prefix-summed over j, carried in from earlier tiles
      if (tid < T) {
        float run = sRow[i0 + tid];
        for (int j = 0; j < T; ++j) {
          const float m = sMp[tid * kTP + j];
          sMp[tid * kTP + j] = run;  // sum over j' < j of this row
          run += m;
        }
        sRow[i0 + tid] = run;
      }
      __syncthreads();
      // column k: sum_i N_ik, and the exponent term sum_{i>=k} sum_{j<k} M_ij
      if (tid < T) {
        float ncol = 0.f, dcol = 0.f;
        for (int i = 0; i < T; ++i) {
          ncol += sN[i * kTP + tid];
          if (it > jt || i >= tid) dcol += sMp[i * kTP + tid];
        }
        sNc[tid] += ncol;
        sDaT[tid] += dcol;
      }
    }
    // the column tile's outputs
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      const int j = ty + 16 * r;
      if (j >= T) continue;
      const long long t = t0 + j0 + j;
      const long long row = ((long long)b * a.S + t) * a.H + h;
#pragma unroll
      for (int q = 0; q < RY; ++q)
        store(a.dx, row * HD + tx + 16 * q, accX[r][q], a.x_bf16);
      const long long prow = ((long long)h * a.batch + b) * a.S + t;
#pragma unroll
      for (int q = 0; q < RS; ++q) a.dbp[prow * DS + tx + 16 * q] = accB[r][q];
    }
    __syncthreads();  // sXB, sNc, sDaT complete
    if (tid < T)
      sDu[j0 + tid] = sDt[j0 + tid] * sXB[tid] * sEnd[j0 + tid];
    __syncthreads();
    if (tid < T) {
      const int k = j0 + tid;
      float du = 0.f;  // sum_{j<k} u_j du_j
      for (int j = 0; j < k; ++j) du += sDu[j];
      const float da = sDaT[tid] + sDe[k] + dEdec + du;
      const float ddt = sNc[tid] + sEnd[k] * sXB[tid] + Ah * da;
      a.ddt[b * (long long)a.S * a.H + (t0 + k) * a.H + h] = ddt;
      da_blk = fmaf(sDt[k], da, da_blk);
    }
  }
  // the block's share of dA, summed in a fixed order
  for (int off = 16; off > 0; off >>= 1)
    da_blk += __shfl_xor_sync(0xffffffffu, da_blk, off);
  __syncthreads();
  if ((tid & 31) == 0) sRed[tid >> 5] = da_blk;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += sRed[w];
    a.dap[((long long)b * a.nc + c) * a.H + h] = sum;
  }
}

// ---------------------------------------------------------------------------
// 4. The sums over heads (dB, dC) and over (b, chunk) (dA)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSumThreads)
    ssd_bwd_sum(Args a, int DS) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  const long long n_bsd = (long long)a.batch * a.S * DS;
  if (e < n_bsd) {
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < a.H; ++h) {
      sb += a.dbp[h * n_bsd + e];
      sc += a.dcp[h * n_bsd + e];
    }
    store(a.dB, e, sb, a.bc_bf16);
    store(a.dC, e, sc, a.bc_bf16);
  } else if (e < n_bsd + a.H) {
    const int h = static_cast<int>(e - n_bsd);
    float s = 0.f;
    for (long long bc = 0; bc < (long long)a.batch * a.nc; ++bc)
      s += a.dap[bc * a.H + h];
    a.dA[h] = s;
  }
}

template <int HD, int DS>
bool launch_chunks(const Args& a, cudaStream_t stream, int* err) {
  constexpr size_t smem_a = state_smem_bytes<HD, DS>();
  constexpr size_t smem_c = chunk_smem_bytes<HD, DS>();
  const dim3 grid(a.H, a.nc, a.batch);
  err[0] = cudaFuncSetAttribute(ssd_bwd_chunk_state<HD, DS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_a));
  if (!err[0]) {
    ssd_bwd_chunk_state<HD, DS><<<grid, kThreads, smem_a, stream>>>(a);
    err[0] = cudaGetLastError();
  }
  if (err[0]) return true;
  const int hdds = HD * DS;
  const long long n_pass = (long long)a.batch * a.H * hdds;
  ssd_bwd_state_pass<<<static_cast<unsigned>((n_pass + kPassThreads - 1) /
                                             kPassThreads),
                       kPassThreads, 0, stream>>>(a, hdds);
  err[1] = cudaGetLastError();
  if (err[1]) return true;
  err[2] = cudaFuncSetAttribute(ssd_bwd_chunk<HD, DS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem_c));
  if (!err[2]) {
    ssd_bwd_chunk<HD, DS><<<grid, kThreads, smem_c, stream>>>(a);
    err[2] = cudaGetLastError();
  }
  if (err[2]) return true;
  const long long n_sum = (long long)a.batch * a.S * DS + a.H;
  ssd_bwd_sum<<<static_cast<unsigned>((n_sum + kSumThreads - 1) /
                                      kSumThreads),
                kSumThreads, 0, stream>>>(a, DS);
  err[3] = cudaGetLastError();
  return true;
}

template <int HD>
bool launch_ds(int DS, const Args& a, cudaStream_t s, int* err) {
  switch (DS) {
    case 16: return launch_chunks<HD, 16>(a, s, err);
    case 32: return launch_chunks<HD, 32>(a, s, err);
    case 64: return launch_chunks<HD, 64>(a, s, err);
    case 128: return launch_chunks<HD, 128>(a, s, err);
    default: return false;
  }
}

}  // namespace

// x and dy float32 or bfloat16 (x_dtype, dy_dtype: 0 or 1), B and C one
// of them (bc_dtype), dt and A float32; the last dim of x, dy, B and C
// contiguous, the rest read through the strides.  dx (b, s, nh, HD) in x's
// type, ddt (b, s, nh) f32, dA (nh,) f32, dB and dC (b, s, DS) in B's type,
// all contiguous.  st and gs (b, nc, nh, HD, DS) f32, dec and dap (b, nc,
// nh) f32, dbp and dcp (nh, b, s, DS) f32 are the caller's scratch.
// err[4] receives the cudaError_t of each launch; returns the first that is
// not 0 (0 if all four launched).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* st, void* gs, void* dec, void* dbp, void* dcp, void* dap,
    int x_dtype, int dy_dtype, int bc_dtype, int batch, int S, int H, int HD,
    int DS, int chunk, long long xb, long long xs, long long xh, long long yb,
    long long ys, long long yh, long long db, long long ds, long long dh,
    long long bb, long long bs, long long cb, long long cs, void* stream,
    int* err) {
  err[0] = err[1] = err[2] = err[3] = 0;
  const bool chunk_ok = chunk >= 8 && chunk <= kMaxChunk &&
                        (chunk & (chunk - 1)) == 0;
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || !chunk_ok ||
      S % chunk != 0 || S / chunk > 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (dy_dtype != 0 && dy_dtype != 1) || (bc_dtype != 0 && bc_dtype != 1)) {
    err[0] = static_cast<int>(cudaErrorInvalidValue);
    return err[0];
  }
  const Args a{x,  static_cast<const float*>(dt), static_cast<const float*>(A),
               B,  C,  dy, dx, static_cast<float*>(ddt),
               static_cast<float*>(dA), dB, dC, static_cast<float*>(st),
               static_cast<float*>(gs), static_cast<float*>(dec),
               static_cast<float*>(dbp), static_cast<float*>(dcp),
               static_cast<float*>(dap), xb, xs, xh, yb, ys, yh, db, ds, dh,
               bb, bs, cb, cs, batch, S, H, chunk, S / chunk, x_dtype,
               dy_dtype, bc_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  switch (HD) {
    case 16: ok = launch_ds<16>(DS, a, s, err); break;
    case 32: ok = launch_ds<32>(DS, a, s, err); break;
    case 64: ok = launch_ds<64>(DS, a, s, err); break;
    default: break;
  }
  if (!ok) err[0] = static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 4; ++k)
    if (err[k]) return err[k];
  return 0;
}
