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
// and, with s_ij = C_i . B_j, dyx_ij = dy_i . x_j and W_ij = sum over heads
// of L_ij dt_j dyx_ij (B and C are shared by every head),
//   dx_j  = sum_i L_ij s_ij dt_j dy_i + u_j dt_j (dS B_j)
//   ddt_j = sum_i L_ij s_ij dyx_ij + u_j x_j . (dS B_j) + A da_j
//   dC_i  = sum_j W_ij B_j + sum_h e_i P^T dy_i
//   dB_j  = sum_i W_ij C_i + sum_h u_j dt_j dS^T x_j
// and the exponent gradient da_k, collected over every segment that holds
// step k: M_ij = L_ij s_ij dt_j dyx_ij over j < k <= i, e_i de_i over i >= k
// (de_i = C_i . P^T dy_i), e_{Q-1} (dS . P) for every k, and u_j du_j over
// j < k (du_j = dt_j x_j . dS B_j); dA = sum of dt_k da_k.
//
// Exponent precision (C3), both paths.  Every exponent is a sum of
// same-sign terms (dt > 0 > A): off the diagonal tile L_ij is a product of
// factors exp(pre_i) exp(mid) exp(suf_j), each the exponential of a
// same-sign sum and at most 1 (64-row tiles; on the diagonal tile 16-row
// blocks, and within one 16-row block a table of segments each summed on
// its own).  da_k's intra-chunk term is never a difference of running sums:
// M is prefix-summed down each column over the rows j < k and the prefixes
// summed along row k over i >= k, and the other pieces of the (j < k <= i)
// region are plain sums of row and column sums.  Entries above the diagonal
// are 0 with no exponent taken, so a decay that underflows gives a zero
// gradient, never a NaN.  No atomics anywhere: two runs are bitwise equal.
// The chunk states are recomputed in f32 (the bf16 forward keeps the state
// entering a chunk only as bf16 hi + lo planes).
//
// Two paths, by the inputs' types, as the forward's.  Any of x, B and C
// f32 keeps the four f32-FMA kernels of the first port (ssd_bwd_chunk_state,
// ssd_bwd_state_pass, ssd_bwd_chunk, ssd_bwd_sum: a 16 x 16 thread grid on
// 32 x 32 tiles, per-head dB and dC partials summed by the last kernel),
// which read x, B, C and dy as f32 or bf16 through any strides.  x, B and C
// all bf16 (the training calls) take the tensor-core path, five kernels:
//   1. ssd_bwd_tc_states, one block per (b, chunk, head, product): S_c =
//      (u dt x)^T B or G_c = (e dy)^T C, an (hd x Q) . (Q x ds) product, to
//      scratch in f32, and the decays (e_i, u_j dt_j, the chunk's e_{Q-1});
//      plus one block per (b, chunk, 64-row tile pair) for s_ij, once for
//      all heads.  An f32 dy is split here into bf16 hi and lo planes.
//   2. ssd_bwd_tc_pass, four state entries of one (b, head) a thread: P_c
//      by the forward recurrence and dS_c by the reverse one, both to bf16
//      hi + lo planes (they are only ever mma operands), and dE_c = dS_c .
//      P_c in per-block partials.
//   3. ssd_bwd_tc_chunk, one block per (b, chunk, head group, 64-row column
//      tile t), the tiles with the most pairs first.  Warp w owns the rows j
//      = 16 w.. of tile t.  Per head of the group, in order: de_i of the
//      tile's rows (C_t P^T, a row dot with dy), dS B_j (dx's end-state
//      share and x_j . dS B_j), then for each row tile it >= t the pair's
//      dyx [j][i] (one product), s from scratch, the decayed weights as the
//      A operand of dx += (L s dt)^T dy (FlashAttention-2 register reuse,
//      split hi + lo), the row sums into ddt, M's row and column sums (and
//      the diagonal pair's M to shared memory) for da, and the head's
//      L dt dyx added to the group's W partial in device memory, in head
//      order (the group's first head stores).  dx and ddt's partial are
//      written where they belong, the exponent pieces to a per-(b, chunk,
//      head) record.
//   4. ssd_bwd_tc_bc: per (b, chunk, 64-row tile, dB or dC, head split) a
//      long-K product: the diagonal part from W summed over the groups in
//      order (its K-tiles dealt over the splits), then the split's heads,
//      e_i dy_i against P's planes (dC) or u_j dt_j x_j against dS's (dB),
//      the row-scaled A split hi + lo (three products: hi hi, lo hi, hi lo);
//      an f32 partial per split.  Its other blocks, one per (b, chunk, head),
//      sum da_k's pieces (prefix and suffix sums, no differences) into ddt
//      and each (b, chunk, head)'s share of dA.
//   5. ssd_bwd_tc_sum: dB and dC over the splits, dA over (b, chunk), each
//      in a fixed order.
// Every product of the path is bf16 mma.sync.m16n8k16 with f32 accumulation
// from ldmatrix'd shared memory (16-byte cp.async tiles, rows padded by 16
// bytes; the PTX, tile and decay helpers are the forward's, in
// csrc/ssd_tc.cuh).  x, B, C and a bf16 dy are exact in bf16; every f32
// operand (the decayed weights, W, the states' planes, the row-scaled u dt
// x and e dy, an f32 dy) is split as bf16 hi + lo, since one bf16 rounding
// costs ~0.4 % per term.  C B^T and the diagonal parts of dB and dC are formed once per
// chunk; dy x^T once per (chunk, head, tile pair).
//
// Grid, head sums and budget.  ssd_scan.py::bwd_plan picks the head group
// G (the largest power of two up to 8 keeping three chunk blocks an SM)
// and the splits KS (the least power of two giving two dB/dC blocks an
// SM).  At mamba2-1.3b's training call (1, 2048, 64, 64, 128), chunk 256,
// on 132 SMs: G 4 (16 groups), KS 8; 1,104 state blocks, 512 chunk blocks,
// 512 dB/dC and 512 exponent blocks.  The f32 partials: W's group partials
// 21.0 MB written and 41.9 MB read, dB and dC's split partials 16.8 MB
// written and read: 37.7 MB written and 58.7 MB read, against the f32
// path's 134 MB of per-head dB and dC partials written and 134 MB read.
// Per block at hd 64, ds 128, 128 threads: the chunk kernel 106 KB of
// shared memory (B and C of the tile, x, two dy stages, P's or dS's planes
// which then hold the M tile, the decay tables and the column sums) and the
// dB/dC kernel 89 KB (two head stages), each two blocks an SM with no
// spill; the state kernel 60 KB, three.
//
// What bounds it on this card.  At mamba2's training call the path does
// ~38.5 GFLOP on the tensor cores (2.5x the least 15.25: the hi + lo
// products), 0.039 ms at 989 TFLOP/s, and moves ~0.33 GB through device
// memory (x, dy and the scratch: the f32 states, their planes, W's and dB,
// dC's partials), ~0.10 ms at 3.35 TB/s: bytes before operations, as at
// zamba2-2.7b's call (1, 2048, 80, 64, 64) and mamba2's prefill call (2,
// 4096, ...).  As measured (PERF.md) the path runs at several times either:
// the chunk kernel takes half the time, held by each head's serial phases
// (the plane loads, the decays, the W partial's read-modify-write, the
// barriers) with eight warps an SM to hide them; its time grows with the
// heads, not with ds.
//
// Plain C interface, loaded with ctypes: each launcher returns the first
// cudaError_t of its launches (0 if all launched) and each in err[]; a
// size, chunk, type or layout it does not take returns
// cudaErrorInvalidValue before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ssd_tc.cuh"  // the tensor-core path's PTX, tile and decay helpers

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


// ===========================================================================
// The tensor-core path (x, B and C bf16): five kernels
// ===========================================================================

namespace tc {

// the tensor-core helpers (csrc/ssd_tc.cuh): 128 threads a block, 64-row
// tiles, shared rows padded by 8 bf16
using ssd_tc::bf16;
using ssd_tc::cp_async16;
using ssd_tc::cp_async_commit;
using ssd_tc::cp_async_wait;
using ssd_tc::chunk_decays;
using ssd_tc::Decay;
using ssd_tc::decay_at;
using ssd_tc::kDecayFloats;
using ssd_tc::kPad;
using ssd_tc::kThreads;
using ssd_tc::kTile;
using ssd_tc::ldsm_x2_t;
using ssd_tc::ldsm_x4;
using ssd_tc::ldsm_x4_t;
using ssd_tc::mma;
using ssd_tc::pack2;
using ssd_tc::smem_u32;
using ssd_tc::split2;
using ssd_tc::tile_to_smem;

constexpr int kPassThreads = 64;  // state pass: 256 state entries a block
constexpr int kSumThreads = 256;
constexpr int kML = 72;         // row stride (floats) of the M tile
constexpr int kDL = 24;         // row stride (floats) of a 16 x 16 table
// rows of each (b, chunk, head)'s vector record: the within-tile exponent
// term, e_i de_i, u_j du_j, then one column-sum vector per column tile
enum Vec { kDaT, kEde, kUdu, kR0 };

struct Args {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  const void* dy;   // as given, f32 or bf16 (read by the state kernel)
  const bf16* dyh;  // dy as bf16 (dy itself, or its hi plane)
  const bf16* dyl;  // the lo plane of an f32 dy, else null
  bf16* dx;
  float* ddt;
  float* dA;
  bf16* dB;
  bf16* dC;
  float* st;   // (b, nc, nh, hd, ds) S_c, then P_c
  float* gs;   // (b, nc, nh, hd, ds) G_c
  bf16* pl;    // (4, b, nc, nh, hd, ds) P hi, P lo, dS hi, dS lo
  bf16* dyp;   // (2, b, s, nh, hd) an f32 dy's hi and lo planes
  float* dec;  // (b, nc, nh) exp(seg(-1, Q-1])
  float* fac;  // (b, nc, nh, 2, Q) e_i, then u_j dt_j
  float* sc;   // (b, nc, Q, Q) s_ij = C_i . B_j at [j][i]
  float* wp;   // (ngroups, b, nc, Q, Q) the group's W_ij at [j][i]
  float* vec;  // (b, nc, nh, kR0 + nt, Q) see Vec
  float* dep;  // (b, nc, nh, hd ds / 256) partials of dE = dS . P
  float* dap;  // (b, nc, nh) each (b, chunk, head)'s share of dA
  float* bcp;  // (KS, 2, b, s, ds) dC (0) and dB (1) partials of each split
  long long xb, xs, xh, yb, ys, yh, db, ds, dh, bb, bs, cb, cs;
  long long hb, hs, hh;  // strides of dyh and dyl over (b, s, h)
  int batch, S, H, chunk, nc, nt, T, G, ngroups, KS, nblk, dy_bf16;
};

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ float2 ld2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum over the four lanes of a quad (one row of an accumulator tile)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragments from shared memory by ldmatrix.  A (16 x 16) of rows m0.. and
// columns k0.. from a row-major [m][k] tile, or from a [k][m] tile (_t);
// B of two n8 tiles (n0.., n0 + 8..) and k16 step k0 from an [n][k] tile,
// or from a [k][n] tile (_t).  b[0], b[1] serve tile n0; b[2], b[3] n0 + 8.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, t + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
}

__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* t,
                                         int ld, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, t + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                   ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_b(uint32_t (&b)[4], const bf16* t,
                                       int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                 ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void frag_b_t(uint32_t (&b)[4], const bf16* t,
                                         int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, t + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                   (lane >> 4) * 8);
}

__device__ __forceinline__ long long bch_of(const Args& a, int b, int c,
                                            int h) {
  return ((long long)b * a.nc + c) * a.H + h;
}

// ---------------------------------------------------------------------------
// 1. ssd_bwd_tc_states: per (b, chunk, head) and product the chunk's state
// share S_c = (u dt x)^T B or its dy-side gradient G_c = (e dy)^T C, and
// the decays; per (b, chunk, tile pair) the scores C_i . B_j, once for all
// heads.
// ---------------------------------------------------------------------------

// two stages of the A source (x or dy) and of the B or C tile, the
// decays and the row scales, then two stages of an f32 dy's lo plane
template <int HD, int DS>
constexpr size_t states_smem_bytes(bool dylo) {
  const size_t a = sizeof(bf16) * 2 * ((dylo ? 2 : 1) * kTile * (HD + kPad) +
                                       kTile * (DS + kPad)) +
                   sizeof(float) * (kDecayFloats + kMaxChunk);
  const size_t s = sizeof(bf16) * 2 * kTile * (DS + kPad);
  return a > s ? a : s;
}

template <int DS>
__device__ void scores_block(const Args& a, unsigned char* smem, int b,
                             int idx) {
  constexpr int BW = DS + kPad;
  const int Q = a.chunk, T = a.T, TM = max(T, 16), nt = a.nt;
  const int npairs = nt * (nt + 1) / 2;
  const int c = idx / npairs;
  int jt = idx % npairs, it = 0;
  while (jt > it) jt -= ++it;  // pairs (it, jt <= it) in row order
  bf16* sBt = reinterpret_cast<bf16*>(smem);  // [kTile][BW] B, column tile
  bf16* sCt = sBt + kTile * BW;               // [kTile][BW] C, row tile
  const long long t0 = (long long)c * Q;
  tile_to_smem<DS>(sBt, BW, a.B + b * a.bb + (t0 + jt * T) * a.bs, a.bs, T,
                   TM);
  tile_to_smem<DS>(sCt, BW, a.C + b * a.cb + (t0 + it * T) * a.cs, a.cs, T,
                   TM);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  if (warp * 16 >= TM) return;
  float s[kTile / 8][4];
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DS / 16; ++ks) {
    uint32_t af[4];
    frag_a(af, sBt, BW, warp * 16, ks * 16);
#pragma unroll
    for (int np = 0; np < kTile / 8; np += 2) {
      if (np * 8 >= TM) break;
      uint32_t bfr[4];
      frag_b(bfr, sCt, BW, np * 8, ks * 16);
      mma(s[np], af, bfr[0], bfr[1]);
      mma(s[np + 1], af, bfr[2], bfr[3]);
    }
  }
  float* out = a.sc + ((long long)b * a.nc + c) * Q * Q;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kTile / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    if (n * 8 >= T) break;
    if (r0 < T)
      *reinterpret_cast<float2*>(out + (jt * T + r0) * Q + it * T + col) =
          make_float2(s[n][0], s[n][1]);
    if (r1 < T)
      *reinterpret_cast<float2*>(out + (jt * T + r1) * Q + it * T + col) =
          make_float2(s[n][2], s[n][3]);
  }
}

// One product a block, as the forward's ssd_scan_chunk_state: the raw A
// rows (x_j, or dy_i) [j][p] and the B (or C) tile [j][n] in two cp.async
// stages over 64-row k-tiles; the A fragments read transposed, scaled by
// their row's u_j dt_j (or e_i) in registers and split as bf16 hi + lo.  An
// f32 dy is loaded and split into two bf16 planes (hi, lo), which also go
// to device memory for the later kernels.  Warps split hd into 16-row
// m-tiles and ds into groups of n8 tiles.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads) ssd_bwd_tc_states(Args a) {
  constexpr int AW = HD + kPad, BW = DS + kPad;
  constexpr int MT = HD / 16, NTN = DS / 8;
  constexpr int NG = (4 / MT) < NTN ? (4 / MT) : NTN;  // warps along ds
  constexpr int NPW = NTN / NG;                        // n8 tiles a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int b = blockIdx.y;
  if ((int)blockIdx.x >= 2 * a.nc * a.H) {
    scores_block<DS>(a, smem_raw, b, blockIdx.x - 2 * a.nc * a.H);
    return;
  }
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // [2][kTile][AW] A rows
  bf16* sBt = sA + 2 * kTile * AW;                // [2][kTile][BW] B or C
  float* fv = reinterpret_cast<float*>(sBt + 2 * kTile * BW);
  const Decay d = decay_at(fv);
  float* scale = fv + kDecayFloats;  // [kMaxChunk] u_j dt_j or e_i
  bf16* sAl = reinterpret_cast<bf16*>(scale + kMaxChunk);  // f32 dy's lo

  const int which = blockIdx.x & 1;  // 0: S_c, 1: G_c
  const int c = (blockIdx.x >> 1) / a.H, h = (blockIdx.x >> 1) % a.H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Q = a.chunk, T = a.T, TM = max(T, 16), nt = a.nt;
  const long long t0 = (long long)c * Q;
  const long long bch = bch_of(a, b, c, h);
  const bool split = which && !a.dy_bf16;  // an f32 dy
  const bf16* bsrc = which ? a.C + b * a.cb + t0 * a.cs
                           : a.B + b * a.bb + t0 * a.bs;
  const long long bstride = which ? a.cs : a.bs;
  const long long plane = (long long)a.batch * a.S * a.H * HD;
  auto load = [&](int kt, int buf) {
    bf16* dA = sA + buf * kTile * AW;
    if (which == 0) {
      tile_to_smem<HD>(dA, AW, a.x + b * a.xb + (t0 + kt * T) * a.xs +
                                   h * a.xh, a.xs, T, TM);
    } else if (!split) {
      tile_to_smem<HD>(dA, AW, static_cast<const bf16*>(a.dy) + b * a.yb +
                                   (t0 + kt * T) * a.ys + h * a.yh, a.ys, T,
                       TM);
    } else {
      bf16* dL = sAl + buf * kTile * AW;
      for (int idx = tid; idx < TM * (HD / 2); idx += kThreads) {
        const int r = idx / (HD / 2), p = 2 * (idx % (HD / 2));
        uint32_t hi = 0u, lo = 0u;
        if (r < T) {
          const long long t = t0 + kt * T + r;
          const float2 v = *reinterpret_cast<const float2*>(
              static_cast<const float*>(a.dy) + b * a.yb + t * a.ys +
              h * a.yh + p);
          split2(v.x, v.y, hi, lo);
          const long long o = ((b * (long long)a.S + t) * a.H + h) * HD + p;
          *reinterpret_cast<uint32_t*>(a.dyp + o) = hi;
          *reinterpret_cast<uint32_t*>(a.dyp + plane + o) = lo;
        }
        *reinterpret_cast<uint32_t*>(dA + r * AW + p) = hi;
        *reinterpret_cast<uint32_t*>(dL + r * AW + p) = lo;
      }
    }
    tile_to_smem<DS>(sBt + buf * kTile * BW, BW, bsrc + kt * T * bstride,
                     bstride, T, TM);
    cp_async_commit();
  };
  load(0, 0);
  chunk_decays(d, a.dt + b * a.db + t0 * a.ds + h * a.dh, a.ds, a.A[h], Q);
  float* rec = a.fac + bch * 2 * Q;
  for (int i = tid; i < nt * TM; i += kThreads) {
    float v = 0.f;  // rows past a chunk of 8 (the k16 pad) scale by 0
    if (i < Q) {
      const int tl = i >> 6;
      float before = d.pre64[i], after = d.suf64[i];
      for (int u = 0; u < tl; ++u) before += d.tot64[u];
      for (int u = tl + 1; u < nt; ++u) after += d.tot64[u];
      const float e = expf(before), udt = d.dt[i] * expf(after);
      v = which ? e : udt;
      if (which == 0) {
        rec[i] = e;
        rec[Q + i] = udt;
      }
    }
    scale[i] = v;
  }
  if (tid == 0 && which == 0) {
    float all = 0.f;
    for (int u = 0; u < nt; ++u) all += d.tot64[u];
    a.dec[bch] = expf(all);
  }

  const bool active = warp < MT * NG;
  const int m0 = (warp % MT) * 16, nw = (warp / MT) * NPW;
  const int g = lane >> 2, tq = lane & 3;
  float acc[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tA = sA + (kt & 1) * kTile * AW;
    const bf16* tL = sAl + (kt & 1) * kTile * AW;
    const bf16* tB = sBt + (kt & 1) * kTile * BW;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        if (ks * 16 >= TM) break;
        // the A rows in f32 from the raw fragment, scaled by row and split
        // as bf16 hi + lo; a fragment holds rows k0 + 2t + {0, 1, 8, 9}
        uint32_t raw[4], af[4], al[4];
        frag_a_t(raw, tA, AW, m0, ks * 16);
        float2 v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) v[r] = unpack2(raw[r]);
        if (split) {
          frag_a_t(raw, tL, AW, m0, ks * 16);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 w = unpack2(raw[r]);
            v[r].x += w.x;
            v[r].y += w.y;
          }
        }
        const float* sc = scale + kt * TM + ks * 16 + 2 * tq;
        const float2 s01 = *reinterpret_cast<const float2*>(sc);
        const float2 s89 = *reinterpret_cast<const float2*>(sc + 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 sv = r < 2 ? s01 : s89;
          split2(v[r].x * sv.x, v[r].y * sv.y, af[r], al[r]);
        }
        const bf16* pb = tB + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  BW + (lane >> 4) * 8;
#pragma unroll
        for (int np = 0; np < NPW; np += 2) {
          const int n0 = (nw + np) * 8;
          if (np + 1 < NPW) {
            uint32_t bfr[4];
            ldsm_x4_t(bfr, pb + n0);
            mma(acc[np], af, bfr[0], bfr[1]);
            mma(acc[np + 1], af, bfr[2], bfr[3]);
            mma(acc[np], al, bfr[0], bfr[1]);
            mma(acc[np + 1], al, bfr[2], bfr[3]);
          } else {
            uint32_t bfr[2];
            ldsm_x2_t(bfr, pb + n0);
            mma(acc[np], af, bfr[0], bfr[1]);
            mma(acc[np], al, bfr[0], bfr[1]);
          }
        }
      }
    }
    __syncthreads();  // this stage is read before the next load refills it
  }
  if (active) {
    float* out = (which ? a.gs : a.st) + bch * HD * DS;
#pragma unroll
    for (int np = 0; np < NPW; ++np) {
      const int n = (nw + np) * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out + (m0 + g) * DS + n) =
          make_float2(acc[np][0], acc[np][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * DS + n) =
          make_float2(acc[np][2], acc[np][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. ssd_bwd_tc_pass: the forward recurrence over chunks (P_c over S_c in
// f32, and as hi + lo planes), then the reverse one (dS_c as hi + lo planes)
// with dE_c = dS_c . P_c; four state entries of one (b, head) a thread.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
    ssd_bwd_tc_pass(Args a, int hdds) {
  __shared__ float sRed[kPassThreads / 32];
  const int nblk = hdds / (4 * kPassThreads);  // blocks a (b, head)
  const int bh = blockIdx.x / nblk, blk = blockIdx.x % nblk;
  const int h = bh % a.H, b = bh / a.H;
  const long long q4 = hdds / 4;  // float4s of one state
  const int e = blk * kPassThreads + threadIdx.x;
  const long long plane = (long long)a.batch * a.nc * a.H * q4;  // uint2s
  float4* st = reinterpret_cast<float4*>(a.st);
  const float4* gs = reinterpret_cast<const float4*>(a.gs);
  uint2* pl = reinterpret_cast<uint2*>(a.pl);
  const long long step = (long long)a.H * q4;  // from chunk to chunk
  const long long o0 = bch_of(a, b, 0, h) * q4 + e;
  const float* dec = a.dec + bch_of(a, b, 0, h);
  // each chunk's loads are issued one chunk ahead
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = st[o0];
  float dc = dec[0];
  for (int c = 0; c < a.nc; ++c) {
    const long long o = o0 + c * step;
    float4 s_next = s;
    float dc_next = dc;
    if (c + 1 < a.nc) {
      s_next = st[o + step];
      dc_next = dec[(c + 1) * a.H];
    }
    st[o] = carry;  // P_c, the state entering chunk c
    uint2 hi, lo;
    split2(carry.x, carry.y, hi.x, lo.x);
    split2(carry.z, carry.w, hi.y, lo.y);
    pl[o] = hi;
    pl[o + plane] = lo;
    carry.x = fmaf(carry.x, dc, s.x);
    carry.y = fmaf(carry.y, dc, s.y);
    carry.z = fmaf(carry.z, dc, s.z);
    carry.w = fmaf(carry.w, dc, s.w);
    s = s_next;
    dc = dc_next;
  }
  float4 dd = make_float4(0.f, 0.f, 0.f, 0.f);
  const int last = a.nc - 1;
  float4 gv = gs[o0 + last * step], p = st[o0 + last * step];
  dc = dec[last * a.H];
  for (int c = last; c >= 0; --c) {
    const long long o = o0 + c * step;
    float4 gv_next = gv, p_next = p;
    float dc_next = dc;
    if (c > 0) {
      gv_next = gs[o - step];
      p_next = st[o - step];
      dc_next = dec[(c - 1) * a.H];
    }
    uint2 hi, lo;  // dS_c, the gradient of the state leaving chunk c
    split2(dd.x, dd.y, hi.x, lo.x);
    split2(dd.z, dd.w, hi.y, lo.y);
    pl[o + 2 * plane] = hi;
    pl[o + 3 * plane] = lo;
    float part = dd.x * p.x + dd.y * p.y + dd.z * p.z + dd.w * p.w;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((threadIdx.x & 31) == 0) sRed[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) sum += sRed[w];
      a.dep[bch_of(a, b, c, h) * nblk + blk] = sum;
    }
    __syncthreads();
    dd.x = fmaf(dc, dd.x, gv.x);
    dd.y = fmaf(dc, dd.y, gv.y);
    dd.z = fmaf(dc, dd.z, gv.z);
    dd.w = fmaf(dc, dd.w, gv.w);
    gv = gv_next;
    p = p_next;
    dc = dc_next;
  }
}

// ---------------------------------------------------------------------------
// 3. ssd_bwd_tc_chunk: one column tile t of one chunk for a group of heads.
// ---------------------------------------------------------------------------

// floats before the bf16 tiles: the decays, exp(pre64) of every row, six
// vectors of the tile's rows, the 4 x 4 table, the pair factors
constexpr int kChunkFloats = kDecayFloats + kMaxChunk + 6 * kTile + 16 + 4;

// the planes buffer: P's or dS's hi and lo planes, or (after them) the M
// tile, the 16 x 16 decay tables and the column-sum rows
template <int HD, int DS>
constexpr size_t plane_bytes() {
  constexpr size_t p = sizeof(bf16) * 2 * HD * (DS + kPad);
  constexpr size_t m = sizeof(float) * (kTile * kML + 4 * 16 * kDL + 4 * kTile);
  return p > m ? p : m;
}

template <int HD, int DS>
constexpr size_t chunk_smem_bytes(bool dylo) {
  return sizeof(float) * ((kChunkFloats + 3) / 4 * 4) +
         sizeof(bf16) * (2 * kTile * (DS + kPad) +
                         (dylo ? 5 : 3) * kTile * (HD + kPad)) +
         plane_bytes<HD, DS>();
}

// Rows j of column tile t (warp w owns j = 16 w + {g, g + 8}); for each row
// tile it >= t the scores and dy x^T of the pair are an accumulator tile
// [j][i].  Per head of the group: de_i of the tile's rows (C_i . P^T dy_i),
// dS B_j (dx's end-state share, x_j . dS B_j), then per pair the decayed
// weights into dx (A operand from registers, split hi + lo), the rows' sums
// into ddt, the exponent terms, and W_ij = L_ij dt_j dyx_ij added to the
// group's partial in device memory in head order.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_tc_chunk(Args a) {
  constexpr int XW = HD + kPad, BW = DS + kPad;
  constexpr int KH = HD / 16, NH = HD / 8, KD = DS / 16;
  constexpr int NS = kTile / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* fv = reinterpret_cast<float*>(smem_raw);
  const Decay d = decay_at(fv);
  float* fP64 = fv + kDecayFloats;  // [kMaxChunk] exp(pre64_i)
  float* fS64 = fP64 + kMaxChunk;   // [kTile] exp(suf64_j) of the tile's rows
  float* fE = fS64 + kTile;         // [kTile] e_i
  float* fU = fE + kTile;           // [kTile] u_j
  float* fP16 = fU + kTile;         // [kTile] exp(pre16_i)
  float* fS16 = fP16 + kTile;       // [kTile] exp(suf16_j)
  float* sCs = fS16 + kTile;        // [kTile] row sums of M past the tile
  float* fM16 = sCs + kTile;        // [4][4] whole 16-row blocks between
  float* fMid = fM16 + 16;          // [4] whole tiles between t and it
  bf16* sB = reinterpret_cast<bf16*>(fv + (kChunkFloats + 3) / 4 * 4);
  bf16* sC = sB + kTile * BW;       // [kTile][BW] C of tile t
  bf16* sX = sC + kTile * BW;       // [kTile][XW] x of tile t, then dx
  bf16* sY = sX + kTile * XW;       // [2][kTile][XW] dy of a row tile
  bf16* sYl = sY + 2 * kTile * XW;  // [2][kTile][XW] its lo plane (f32 dy)
  bf16* sP = sYl + (a.dyl ? 2 * kTile * XW : 0);  // [2][HD][BW] planes
  float* sM = reinterpret_cast<float*>(sP);        // [kTile][kML]
  float* fD = sM + kTile * kML;                    // [4][16][kDL]
  float* sRed = fD + 4 * 16 * kDL;                 // [4][kTile]

  const int per_t = a.nc * a.ngroups;
  const int t = blockIdx.x / per_t;  // the heaviest tiles (t = 0) first
  const int c = (blockIdx.x % per_t) / a.ngroups;
  const int grp = blockIdx.x % a.ngroups, b = blockIdx.y;
  const int Q = a.chunk, T = a.T, TM = max(T, 16), nt = a.nt;
  const int j0 = t * T;
  const long long t0 = (long long)c * Q;
  const int h0 = grp * a.G, h1 = min(h0 + a.G, a.H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool active = warp * 16 < TM;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  const bool dylo = a.dyl != nullptr;
  const long long pstride = (long long)a.batch * a.nc * a.H * HD * DS;
  float* Wg = a.wp + (((long long)grp * a.batch + b) * a.nc + c) * Q * Q;
  const float* Sg = a.sc + ((long long)b * a.nc + c) * Q * Q;

  tile_to_smem<DS>(sB, BW, a.B + b * a.bb + (t0 + j0) * a.bs, a.bs, T, TM);
  tile_to_smem<DS>(sC, BW, a.C + b * a.cb + (t0 + j0) * a.cs, a.cs, T, TM);
  auto load_dy = [&](int buf, int it, int h) {
    const long long o = b * a.hb + (t0 + it * T) * a.hs + h * a.hh;
    tile_to_smem<HD>(sY + buf * kTile * XW, XW, a.dyh + o, a.hs, T, TM);
    if (dylo)
      tile_to_smem<HD>(sYl + buf * kTile * XW, XW, a.dyl + o, a.hs, T, TM);
  };

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // the last head's tiles, planes and vectors are read
    const long long bch = bch_of(a, b, c, h);
    float* V = a.vec + bch * (kR0 + nt) * Q;
    const bf16* Pg = a.pl + bch * HD * DS;
    tile_to_smem<DS>(sP, BW, Pg, DS, HD, HD);
    tile_to_smem<DS>(sP + HD * BW, BW, Pg + pstride, DS, HD, HD);
    tile_to_smem<HD>(sX, XW, a.x + b * a.xb + (t0 + j0) * a.xs + h * a.xh,
                     a.xs, T, TM);
    load_dy(0, t, h);
    cp_async_commit();
    chunk_decays(d, a.dt + b * a.db + t0 * a.ds + h * a.dh, a.ds, a.A[h], Q);
    for (int i = tid; i < Q; i += kThreads) fP64[i] = expf(d.pre64[i]);
    if (tid < TM) {
      const int jl = tid, j = j0 + jl;
      float e = 0.f, u = 0.f, s64 = 0.f, p16 = 0.f, s16 = 0.f;
      if (jl < T) {
        float before = d.pre64[j], after = d.suf64[j];
        for (int w = 0; w < t; ++w) before += d.tot64[w];
        for (int w = t + 1; w < nt; ++w) after += d.tot64[w];
        e = expf(before);
        u = expf(after);
        s64 = expf(d.suf64[j]);
        p16 = expf(d.pre16[j]);
        s16 = expf(d.suf16[j]);
      }
      fE[jl] = e;
      fU[jl] = u;
      fS64[jl] = s64;
      fP16[jl] = p16;
      fS16[jl] = s16;
    }
    if (tid >= kThreads - 16) {  // whole 16-row blocks between bj and bi
      const int k = tid - (kThreads - 16), bi = k >> 2, bj = k & 3;
      float m = 0.f;
      for (int w = bj + 1; w < bi; ++w) m += d.tot16[(j0 >> 4) + w];
      fM16[k] = bi > bj && bi * 16 < TM ? expf(m) : 0.f;
    }
    if (tid >= 96 && tid < 96 + nt) {  // whole tiles between t and it
      const int it = tid - 96;
      float m = 0.f;
      for (int w = t + 1; w < it; ++w) m += d.tot64[w];
      fMid[it] = it > t ? expf(m) : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    // de_i = dy_i . (P C_i): C of the tile times P^T (B operand from P's
    // [p][n] planes), then a row dot with dy
    if (active) {
      float acc[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t ca[4];
        frag_a(ca, sC, BW, warp * 16, ks * 16);
#pragma unroll
        for (int pln = 0; pln < 2; ++pln)
#pragma unroll
          for (int np = 0; np < NH; np += 2) {
            uint32_t bfr[4];
            frag_b(bfr, sP + pln * HD * BW, BW, np * 8, ks * 16);
            mma(acc[np], ca, bfr[0], bfr[1]);
            mma(acc[np + 1], ca, bfr[2], bfr[3]);
          }
      }
      float de0 = 0.f, de1 = 0.f;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int p = n * 8 + 2 * tq;
        float2 v0 = ld2(sY + r0 * XW + p), v1 = ld2(sY + r1 * XW + p);
        if (dylo) {
          const float2 w0 = ld2(sYl + r0 * XW + p), w1 = ld2(sYl + r1 * XW + p);
          v0.x += w0.x; v0.y += w0.y; v1.x += w1.x; v1.y += w1.y;
        }
        de0 += v0.x * acc[n][0] + v0.y * acc[n][1];
        de1 += v1.x * acc[n][2] + v1.y * acc[n][3];
      }
      de0 = quad_sum(de0);
      de1 = quad_sum(de1);
      if (tq == 0) {
        if (r0 < T) V[kEde * Q + j0 + r0] = fE[r0] * de0;
        if (r1 < T) V[kEde * Q + j0 + r1] = fE[r1] * de1;
      }
    }
    __syncthreads();  // P's planes are read
    tile_to_smem<DS>(sP, BW, Pg + 2 * pstride, DS, HD, HD);
    tile_to_smem<DS>(sP + HD * BW, BW, Pg + 3 * pstride, DS, HD, HD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the end state's share: dx_j = u_j dt_j (dS B_j), x_j . dS B_j
    float dxa[NH][4];
    float dt0 = 0.f, dt1 = 0.f, ux0 = 0.f, ux1 = 0.f;
    if (active) {
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks) {
        uint32_t ba[4];
        frag_a(ba, sB, BW, warp * 16, ks * 16);
#pragma unroll
        for (int pln = 0; pln < 2; ++pln)
#pragma unroll
          for (int np = 0; np < NH; np += 2) {
            uint32_t bfr[4];
            frag_b(bfr, sP + pln * HD * BW, BW, np * 8, ks * 16);
            mma(dxa[np], ba, bfr[0], bfr[1]);
            mma(dxa[np + 1], ba, bfr[2], bfr[3]);
          }
      }
      float xb0 = 0.f, xb1 = 0.f;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int p = n * 8 + 2 * tq;
        const float2 v0 = ld2(sX + r0 * XW + p), v1 = ld2(sX + r1 * XW + p);
        xb0 += v0.x * dxa[n][0] + v0.y * dxa[n][1];
        xb1 += v1.x * dxa[n][2] + v1.y * dxa[n][3];
      }
      xb0 = quad_sum(xb0);
      xb1 = quad_sum(xb1);
      dt0 = r0 < T ? d.dt[j0 + r0] : 0.f;
      dt1 = r1 < T ? d.dt[j0 + r1] : 0.f;
      const float w0 = fU[r0] * dt0, w1 = fU[r1] * dt1;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        dxa[n][0] *= w0;
        dxa[n][1] *= w0;
        dxa[n][2] *= w1;
        dxa[n][3] *= w1;
      }
      ux0 = fU[r0] * xb0;
      ux1 = fU[r1] * xb1;
      if (tq == 0) {
        if (r0 < T) V[kUdu * Q + j0 + r0] = dt0 * ux0;
        if (r1 < T) V[kUdu * Q + j0 + r1] = dt1 * ux1;
      }
    }
    __syncthreads();  // dS's planes are read: the buffer takes the tables
    if (tid < TM) {   // exp(seg(j, i]) within each 16-row block: [j][i]
      const int blk = tid >> 4, jl = tid & 15, jg = tid;
      float* row = fD + tid * kDL;
      float seg = 0.f;
      for (int il = 0; il < 16; ++il) {
        const int ig = blk * 16 + il;
        float v = 0.f;
        if (il >= jl && ig < T && jg < T) {
          if (il > jl) seg += d.dA[j0 + ig];
          v = expf(seg);
        }
        row[il] = v;
      }
    }
    uint32_t xa[KH][4];
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KH; ++ks) frag_a(xa[ks], sX, XW, warp * 16, ks * 16);
    }
    float nc0 = 0.f, nc1 = 0.f, cs0 = 0.f, cs1 = 0.f;
    const bool first = h == h0;

    for (int it = t; it < nt; ++it) {
      const int buf = (it - t) & 1;
      if (it + 1 < nt) {
        load_dy(buf ^ 1, it + 1, h);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* tY = sY + buf * kTile * XW;
      const bf16* tYl = sYl + buf * kTile * XW;
      const bool diag = it == t;
      const int i0 = it * T;
      if (active) {
        // the scores of the pair, s_ij at [j][i], from device memory
        float S[NS][4], D[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) S[n][e] = D[n][e] = 0.f;
          if (n * 8 >= TM) continue;
          if (diag && (n >> 1) < warp) continue;  // above the diagonal
          const int il = n * 8 + 2 * tq;
          if (il < T) {
            if (r0 < T) {
              const float2 v = *reinterpret_cast<const float2*>(
                  Sg + (j0 + r0) * Q + i0 + il);
              S[n][0] = v.x;
              S[n][1] = v.y;
            }
            if (r1 < T) {
              const float2 v = *reinterpret_cast<const float2*>(
                  Sg + (j0 + r1) * Q + i0 + il);
              S[n][2] = v.x;
              S[n][3] = v.y;
            }
          }
        }
        // dyx_ij = x_j . dy_i
#pragma unroll
        for (int np = 0; np < NS; np += 2) {
          if (np * 8 >= TM) break;
          if (diag && (np >> 1) < warp) continue;
#pragma unroll
          for (int ks = 0; ks < KH; ++ks) {
            uint32_t bfr[4];
            frag_b(bfr, tY, XW, np * 8, ks * 16);
            mma(D[np], xa[ks], bfr[0], bfr[1]);
            mma(D[np + 1], xa[ks], bfr[2], bfr[3]);
            if (dylo) {
              frag_b(bfr, tYl, XW, np * 8, ks * 16);
              mma(D[np], xa[ks], bfr[0], bfr[1]);
              mma(D[np + 1], xa[ks], bfr[2], bfr[3]);
            }
          }
        }
        // the decay L_ij as a product of factors, each at most 1; 0 above
        // the diagonal and on the pad rows and columns
        const float mid = diag ? 0.f : fMid[it];
        const float rs0 = fS64[r0] * mid, rs1 = fS64[r1] * mid;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (n * 8 >= TM) break;
          const int il = n * 8 + 2 * tq;
          float l[4];
          if (!diag) {
            const float2 p = *reinterpret_cast<const float2*>(fP64 + i0 + il);
            l[0] = rs0 * p.x;
            l[1] = rs0 * p.y;
            l[2] = rs1 * p.x;
            l[3] = rs1 * p.y;
          } else if ((n >> 1) < warp) {
            l[0] = l[1] = l[2] = l[3] = 0.f;
          } else if ((n >> 1) > warp) {
            const float2 p = *reinterpret_cast<const float2*>(fP16 + il);
            const float m = fM16[(n >> 1) * 4 + warp];
            const float f0 = fS16[r0] * m, f1 = fS16[r1] * m;
            l[0] = f0 * p.x;
            l[1] = f0 * p.y;
            l[2] = f1 * p.x;
            l[3] = f1 * p.y;
          } else {
            const float* tb = fD + warp * 16 * kDL + (il & 15);
            const float2 q0 = *reinterpret_cast<const float2*>(tb + g * kDL);
            const float2 q1 =
                *reinterpret_cast<const float2*>(tb + (g + 8) * kDL);
            l[0] = q0.x;
            l[1] = q0.y;
            l[2] = q1.x;
            l[3] = q1.y;
          }
          float mrow[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dtj = e < 2 ? dt0 : dt1;
            const float ls = l[e] * S[n][e], dyx = D[n][e];
            const float nv = ls * dyx;
            mrow[e] = nv * dtj;        // M_ij, the exponent weight
            if (e < 2) nc0 += nv; else nc1 += nv;
            D[n][e] = l[e] * dtj * dyx;  // W_ij of this head
            S[n][e] = ls * dtj;          // the weight of dy_i in dx_j
          }
          if (diag) {
            if (il < T) {
              *reinterpret_cast<float2*>(sM + r0 * kML + il) =
                  make_float2(mrow[0], mrow[1]);
              *reinterpret_cast<float2*>(sM + r1 * kML + il) =
                  make_float2(mrow[2], mrow[3]);
            }
          } else {
            cs0 += mrow[0] + mrow[1];
            cs1 += mrow[2] + mrow[3];
            float c0 = mrow[0] + mrow[2], c1 = mrow[1] + mrow[3];
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              c0 += __shfl_xor_sync(0xffffffffu, c0, off);
              c1 += __shfl_xor_sync(0xffffffffu, c1, off);
            }
            if (g == 0)
              *reinterpret_cast<float2*>(sRed + warp * kTile + il) =
                  make_float2(c0, c1);
          }
        }
        // dx_j += sum_i (L s dt)_ji dy_i: the weights, split as hi + lo,
        // are the A fragments
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
          if (kk * 16 >= TM) break;
          if (diag && kk < warp) continue;
          uint32_t ph[4], plo[4];
          split2(S[2 * kk][0], S[2 * kk][1], ph[0], plo[0]);
          split2(S[2 * kk][2], S[2 * kk][3], ph[1], plo[1]);
          split2(S[2 * kk + 1][0], S[2 * kk + 1][1], ph[2], plo[2]);
          split2(S[2 * kk + 1][2], S[2 * kk + 1][3], ph[3], plo[3]);
#pragma unroll
          for (int np = 0; np < NH; np += 2) {
            uint32_t bfr[4];
            frag_b_t(bfr, tY, XW, np * 8, kk * 16);
            mma(dxa[np], ph, bfr[0], bfr[1]);
            mma(dxa[np + 1], ph, bfr[2], bfr[3]);
            mma(dxa[np], plo, bfr[0], bfr[1]);
            mma(dxa[np + 1], plo, bfr[2], bfr[3]);
            if (dylo) {
              frag_b_t(bfr, tYl, XW, np * 8, kk * 16);
              mma(dxa[np], ph, bfr[0], bfr[1]);
              mma(dxa[np + 1], ph, bfr[2], bfr[3]);
            }
          }
        }
        // the group's W, added in head order (the first head stores): the
        // old values are loaded together, one round trip a pair; above the
        // diagonal only the first head writes (its zeros)
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (n * 8 >= TM) break;
          const int il = n * 8 + 2 * tq;
          if (first || il >= T || (diag && (n >> 1) < warp)) continue;
          if (r0 < T) {
            const float2 o = *reinterpret_cast<const float2*>(
                Wg + (j0 + r0) * Q + i0 + il);
            S[n][0] = o.x;
            S[n][1] = o.y;
          }
          if (r1 < T) {
            const float2 o = *reinterpret_cast<const float2*>(
                Wg + (j0 + r1) * Q + i0 + il);
            S[n][2] = o.x;
            S[n][3] = o.y;
          }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (n * 8 >= TM) break;
          const int il = n * 8 + 2 * tq;
          if (il >= T || (!first && diag && (n >> 1) < warp)) continue;
          if (!first) {
#pragma unroll
            for (int e = 0; e < 4; ++e) D[n][e] += S[n][e];
          }
          if (r0 < T)
            *reinterpret_cast<float2*>(Wg + (j0 + r0) * Q + i0 + il) =
                make_float2(D[n][0], D[n][1]);
          if (r1 < T)
            *reinterpret_cast<float2*>(Wg + (j0 + r1) * Q + i0 + il) =
                make_float2(D[n][2], D[n][3]);
        }
      }
      __syncthreads();  // sRed complete; this stage is read
      if (!diag && tid < T) {  // R_i: M summed over the tile's rows j
        float sum = 0.f;
        for (int w = 0; w * 16 < TM; ++w) sum += sRed[w * kTile + tid];
        V[(kR0 + t) * Q + i0 + tid] = sum;
      }
    }

    // dx through sX (each warp its own rows), ddt's partial, the row sums
    if (active) {
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int p = n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(sX + r0 * XW + p) =
            pack2(dxa[n][0], dxa[n][1]);
        *reinterpret_cast<uint32_t*>(sX + r1 * XW + p) =
            pack2(dxa[n][2], dxa[n][3]);
      }
      nc0 = quad_sum(nc0);
      nc1 = quad_sum(nc1);
      cs0 = quad_sum(cs0);
      cs1 = quad_sum(cs1);
      if (tq == 0) {
        const long long row = (b * (long long)a.S + t0 + j0) * a.H + h;
        if (r0 < T) {
          a.ddt[row + (long long)r0 * a.H] = nc0 + ux0;
          sCs[r0] = cs0;
        }
        if (r1 < T) {
          a.ddt[row + (long long)r1 * a.H] = nc1 + ux1;
          sCs[r1] = cs1;
        }
      }
    }
    // the diagonal pair's exponent term: M prefix-summed down each column
    // i over rows j < k, then row k summed over i >= k
    if (tid < T) {
      float run = 0.f;
      for (int jl = 0; jl < T; ++jl) {
        const float m = sM[jl * kML + tid];
        sM[jl * kML + tid] = run;
        run += m;
      }
    }
    __syncthreads();
    bf16* dxg = a.dx + ((b * (long long)a.S + t0 + j0) * a.H + h) * HD;
    for (int k = tid; k < T * (HD / 8); k += kThreads) {
      const int r = k / (HD / 8), q = k % (HD / 8);
      *reinterpret_cast<uint4*>(dxg + (long long)r * a.H * HD + q * 8) =
          *reinterpret_cast<const uint4*>(sX + r * XW + q * 8);
    }
    if (tid < T) {
      float s = 0.f, cp = 0.f;
      for (int il = tid; il < T; ++il) s += sM[tid * kML + il];
      for (int jl = 0; jl < tid; ++jl) cp += sCs[jl];
      V[kDaT * Q + j0 + tid] = s + cp;
    }
  }
}

// ---------------------------------------------------------------------------
// 4. ssd_bwd_tc_bc: dB and dC, and the exponent gradient.
// ---------------------------------------------------------------------------

// one stage of the head loop: the A tile (dy or x, and dy's lo plane), the
// two planes (P or dS) and the row scales
template <int HD, int DS>
__host__ __device__ constexpr size_t bc_stage_bytes(bool dylo) {
  return sizeof(bf16) * ((dylo ? 2 : 1) * kTile * (HD + kPad) +
                         2 * HD * (DS + kPad)) +
         sizeof(float) * kTile;
}

// the W part: the pair tile in f32 and the B or C tile
template <int DS>
constexpr size_t bc_w_bytes() {
  return sizeof(float) * kTile * kML + sizeof(bf16) * kTile * (DS + kPad);
}

template <int HD, int DS>
constexpr size_t bc_smem_bytes(bool dylo) {
  const size_t s = bc_stage_bytes<HD, DS>(dylo);
  const size_t w = bc_w_bytes<DS>();
  return s + (s > w ? s : w);
}

// The exponent gradient of one (b, chunk, head), every term a plain sum:
// da_k = (the tile's own rectangle and rows, kDaT) + sum over column tiles
// t' before k's of sum_{i >= k} R^t'_i + sum_{i >= k} e_i de_i + e_{Q-1} dE
// + sum_{j < k} u_j du_j; then ddt_k += A da_k and the share of dA.
__device__ void combine_block(const Args& a, float* sV, int b, int idx) {
  const int c = idx / a.H, h = idx % a.H;
  const int Q = a.chunk, T = a.T, nt = a.nt, tid = threadIdx.x;
  const long long bch = bch_of(a, b, c, h);
  const float* V = a.vec + bch * (kR0 + nt) * Q;
  for (int k = tid; k < (kR0 + nt) * Q; k += kThreads) {
    const int f = k / Q, i = k % Q;
    // R^t' holds only the rows past tile t'
    sV[k] = f < kR0 || i >= (f - kR0 + 1) * T ? V[k] : 0.f;
  }
  __syncthreads();
  if (tid == 0) {  // suffix sums of e_i de_i
    float run = 0.f;
    for (int i = Q - 1; i >= 0; --i) sV[kEde * Q + i] = run += sV[kEde * Q + i];
  } else if (tid == 1) {  // sums of u_j du_j over j < k
    float run = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float m = sV[kUdu * Q + j];
      sV[kUdu * Q + j] = run;
      run += m;
    }
  } else if (tid >= 2 && tid < 2 + nt - 1) {  // suffix sums of R^t'
    const int tp = tid - 2;
    float* r = sV + (kR0 + tp) * Q;
    float run = 0.f;
    for (int i = Q - 1; i >= (tp + 1) * T; --i) r[i] = run += r[i];
  }
  __syncthreads();
  const int nb = a.nblk;
  float dE = 0.f;
  for (int k = 0; k < nb; ++k) dE += a.dep[bch * nb + k];
  const float Ah = a.A[h], dEdec = dE * a.dec[bch];
  const long long t0 = (long long)c * Q;
  float part = 0.f;
  for (int k = tid; k < Q; k += kThreads) {
    float da = sV[kDaT * Q + k] + sV[kEde * Q + k] + dEdec + sV[kUdu * Q + k];
    for (int tp = 0; tp < k / T; ++tp) da += sV[(kR0 + tp) * Q + k];
    const long long o = (b * (long long)a.S + t0 + k) * a.H + h;
    a.ddt[o] += Ah * da;
    part = fmaf(a.dt[b * a.db + (t0 + k) * a.ds + h * a.dh], da, part);
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  float* sRed = sV + (kR0 + nt) * Q;
  if ((tid & 31) == 0) sRed[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += sRed[w];
    a.dap[bch] = sum;
  }
}

// One (b, chunk, tile t, side, split): side 0 the rows i of tile t of dC,
// side 1 the rows j of tile t of dB, 16 rows and all ds columns a warp.
// The splits first add the diagonal part, its 64-row K-tiles dealt among
// them, from W summed over the groups in order (dC_i = sum_j W_ij B_j, dB_j
// = sum_i W_ij C_i, W split as hi + lo); then each split runs its heads: e_i dy_i P (dC) or u_j dt_j x_j dS (dB), the
// row-scaled A split as hi + lo against the state's two planes (three
// products: hi hi, lo hi, hi lo), the next head's tiles loading meanwhile.
template <int HD, int DS>
__device__ void bc_block(const Args& a, unsigned char* smem, int b, int idx) {
  constexpr int XW = HD + kPad, BW = DS + kPad;
  constexpr int KH = HD / 16, NB = DS / 8;
  const bool dylo = a.dyl != nullptr;
  const int ks = idx % a.KS, side = (idx / a.KS) % 2;
  const int t = (idx / (2 * a.KS)) % a.nt, c = idx / (2 * a.KS * a.nt);
  const int Q = a.chunk, T = a.T, TM = max(T, 16), nt = a.nt;
  const long long t0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool active = warp * 16 < TM;
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const size_t stage = bc_stage_bytes<HD, DS>(dylo);
  const long long pstride = (long long)a.batch * a.nc * a.H * HD * DS;
  auto tiles = [&](int s, bf16*& sA, bf16*& sAl, bf16*& sPp, float*& sSc) {
    sA = reinterpret_cast<bf16*>(smem + s * stage);
    sAl = sA + kTile * XW;
    sPp = sAl + (dylo ? kTile * XW : 0);
    sSc = reinterpret_cast<float*>(sPp + 2 * HD * BW);
  };
  auto load_head = [&](int s, int h) {
    bf16 *sA, *sAl, *sPp;
    float* sSc;
    tiles(s, sA, sAl, sPp, sSc);
    const long long bch = bch_of(a, b, c, h);
    const long long row0 = t0 + t * T;
    if (side == 0) {
      const long long o = b * a.hb + row0 * a.hs + h * a.hh;
      tile_to_smem<HD>(sA, XW, a.dyh + o, a.hs, T, TM);
      if (dylo) tile_to_smem<HD>(sAl, XW, a.dyl + o, a.hs, T, TM);
    } else {
      tile_to_smem<HD>(sA, XW, a.x + b * a.xb + row0 * a.xs + h * a.xh, a.xs,
                       T, TM);
    }
    const bf16* Pg = a.pl + bch * HD * DS + (side ? 2 : 0) * pstride;
    tile_to_smem<DS>(sPp, BW, Pg, DS, HD, HD);
    tile_to_smem<DS>(sPp + HD * BW, BW, Pg + pstride, DS, HD, HD);
    const float* src = a.fac + bch * 2 * Q + side * Q + t * T;
    for (int k = tid; k < TM / 4; k += kThreads) {
      if (4 * k < T)
        cp_async16(sSc + 4 * k, src + 4 * k);
      else
        *reinterpret_cast<float4*>(sSc + 4 * k) = make_float4(0, 0, 0, 0);
    }
  };

  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int hs0 = ks * a.H / a.KS, hs1 = (ks + 1) * a.H / a.KS;
  load_head(0, hs0);
  cp_async_commit();

  {  // the diagonal part, its K-tiles dealt over the splits, in stage 1's room
    float* sW = reinterpret_cast<float*>(smem + stage);  // [kTile][ldw]
    bf16* sT = reinterpret_cast<bf16*>(sW + kTile * kML);  // [kTile][BW]
    // dB reads its A rows along sW's rows (float2), dC down its columns
    const int ldw = side ? kML : kML - 4;
    const int ka = side ? t : 0, kb = side ? nt - 1 : t;
    for (int kt = ka + ks; kt <= kb; kt += a.KS) {
      __syncthreads();  // the last pair's tiles are read
      if (side == 0)
        tile_to_smem<DS>(sT, BW, a.B + b * a.bb + (t0 + kt * T) * a.bs, a.bs,
                         T, TM);
      else
        tile_to_smem<DS>(sT, BW, a.C + b * a.cb + (t0 + kt * T) * a.cs, a.cs,
                         T, TM);
      cp_async_commit();
      // the pair tile [j][i], summed over the groups in order: dC's pair is
      // (i in t, j in kt), dB's (i in kt, j in t)
      const int jr = side ? t : kt, ic = side ? kt : t;
      constexpr int kPer = kTile * (kTile / 4) / kThreads;  // float4s a thread
      float4 v[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m) v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* w0 = a.wp + ((long long)b * a.nc + c) * Q * Q +
                        (long long)(jr * T) * Q + ic * T;
      const long long gstride = (long long)a.batch * a.nc * Q * Q;
      for (int grp = 0; grp < a.ngroups; ++grp) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int k = tid + m * kThreads;
          const int r = k / (kTile / 4), q = (k % (kTile / 4)) * 4;
          if (r < T && q < T) {
            const float4 w = *reinterpret_cast<const float4*>(
                w0 + grp * gstride + (long long)r * Q + q);
            v[m].x += w.x;
            v[m].y += w.y;
            v[m].z += w.z;
            v[m].w += w.w;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int k = tid + m * kThreads;
        const int r = k / (kTile / 4), q = (k % (kTile / 4)) * 4;
        if (r < TM) *reinterpret_cast<float4*>(sW + r * ldw + q) = v[m];
      }
      cp_async_wait<0>();
      __syncthreads();
      if (!active) continue;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        if (kk * 16 >= TM) break;
        const int k = kk * 16 + 2 * tq;
        float2 v[4];
        if (side) {  // A[j][i] = sW[j][i]
          v[0] = *reinterpret_cast<const float2*>(sW + r0 * ldw + k);
          v[1] = *reinterpret_cast<const float2*>(sW + r1 * ldw + k);
          v[2] = *reinterpret_cast<const float2*>(sW + r0 * ldw + k + 8);
          v[3] = *reinterpret_cast<const float2*>(sW + r1 * ldw + k + 8);
        } else {  // A[i][j] = sW[j][i]
          v[0] = make_float2(sW[k * ldw + r0], sW[(k + 1) * ldw + r0]);
          v[1] = make_float2(sW[k * ldw + r1], sW[(k + 1) * ldw + r1]);
          v[2] = make_float2(sW[(k + 8) * ldw + r0], sW[(k + 9) * ldw + r0]);
          v[3] = make_float2(sW[(k + 8) * ldw + r1], sW[(k + 9) * ldw + r1]);
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split2(v[r].x, v[r].y, ah[r], al[r]);
#pragma unroll
        for (int np = 0; np < NB; np += 2) {
          uint32_t bfr[4];
          frag_b_t(bfr, sT, BW, np * 8, kk * 16);
          mma(acc[np], ah, bfr[0], bfr[1]);
          mma(acc[np + 1], ah, bfr[2], bfr[3]);
          mma(acc[np], al, bfr[0], bfr[1]);
          mma(acc[np + 1], al, bfr[2], bfr[3]);
        }
      }
    }
  }

  int s = 0;
  for (int h = hs0; h < hs1; ++h) {
    __syncthreads();  // the other stage (and the diagonal part's room) is read
    if (h + 1 < hs1) {
      load_head(s ^ 1, h + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      bf16 *sA, *sAl, *sPp;
      float* sSc;
      tiles(s, sA, sAl, sPp, sSc);
      const float sc0 = sSc[r0], sc1 = sSc[r1];
#pragma unroll
      for (int kk = 0; kk < KH; ++kk) {
        uint32_t raw[4], ah[4], al[4];
        frag_a(raw, sA, XW, warp * 16, kk * 16);
        float2 f[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) f[r] = unpack2(raw[r]);
        if (side == 0 && dylo) {
          frag_a(raw, sAl, XW, warp * 16, kk * 16);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float2 w = unpack2(raw[r]);
            f[r].x += w.x;
            f[r].y += w.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float sc = (r & 1) ? sc1 : sc0;
          split2(f[r].x * sc, f[r].y * sc, ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < NB; np += 2) {
          uint32_t bh[4], bl[4];
          frag_b_t(bh, sPp, BW, np * 8, kk * 16);
          frag_b_t(bl, sPp + HD * BW, BW, np * 8, kk * 16);
          mma(acc[np], ah, bh[0], bh[1]);
          mma(acc[np + 1], ah, bh[2], bh[3]);
          mma(acc[np], al, bh[0], bh[1]);
          mma(acc[np + 1], al, bh[2], bh[3]);
          mma(acc[np], ah, bl[0], bl[1]);
          mma(acc[np + 1], ah, bl[2], bl[3]);
        }
      }
    }
    s ^= 1;
  }
  if (active) {
    float* out = a.bcp + ((long long)(ks * 2 + side) * a.batch + b) * a.S * DS +
                 (t0 + t * T) * DS;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = n * 8 + 2 * tq;
      if (r0 < T)
        *reinterpret_cast<float2*>(out + r0 * DS + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (r1 < T)
        *reinterpret_cast<float2*>(out + r1 * DS + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_tc_bc(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nbc = a.nc * a.nt * 2 * a.KS;
  if ((int)blockIdx.x < nbc)
    bc_block<HD, DS>(a, smem_raw, blockIdx.y, blockIdx.x);
  else
    combine_block(a, reinterpret_cast<float*>(smem_raw), blockIdx.y,
                  blockIdx.x - nbc);
}

// ---------------------------------------------------------------------------
// 5. ssd_bwd_tc_sum: dB and dC over the splits, dA over (b, chunk), each in
// a fixed order.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSumThreads)
    ssd_bwd_tc_sum(Args a, int DS) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  const long long n = (long long)a.batch * a.S * DS;
  if (e < n) {
    float sc = 0.f, sb = 0.f;
    for (int k = 0; k < a.KS; ++k) {
      sc += a.bcp[2LL * k * n + e];
      sb += a.bcp[(2LL * k + 1) * n + e];
    }
    a.dC[e] = __float2bfloat16(sc);
    a.dB[e] = __float2bfloat16(sb);
  } else if (e < n + a.H) {
    const int h = static_cast<int>(e - n);
    float s = 0.f;
    for (long long bc = 0; bc < (long long)a.batch * a.nc; ++bc)
      s += a.dap[bc * a.H + h];
    a.dA[h] = s;
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// err[k] is the cudaError_t of launch k; a failed launch stops the rest.
template <int HD, int DS>
void launch(const Args& a, cudaStream_t s, int* err) {
  const bool dylo = a.dyl != nullptr;
  const size_t sm1 = states_smem_bytes<HD, DS>(dylo);
  const size_t sm3 = chunk_smem_bytes<HD, DS>(dylo);
  const size_t sm4 = bc_smem_bytes<HD, DS>(dylo);
  const int npairs = a.nt * (a.nt + 1) / 2;
  err[0] = allow_smem(ssd_bwd_tc_states<HD, DS>, sm1);
  if (!err[0]) {
    ssd_bwd_tc_states<HD, DS>
        <<<dim3(a.nc * (2 * a.H + npairs), a.batch), kThreads, sm1, s>>>(a);
    err[0] = cudaGetLastError();
  }
  if (err[0]) return;
  ssd_bwd_tc_pass<<<a.batch * a.H * a.nblk, kPassThreads, 0, s>>>(a,
                                                                  HD * DS);
  err[1] = cudaGetLastError();
  if (err[1]) return;
  err[2] = allow_smem(ssd_bwd_tc_chunk<HD, DS>, sm3);
  if (!err[2]) {
    ssd_bwd_tc_chunk<HD, DS>
        <<<dim3(a.nt * a.nc * a.ngroups, a.batch), kThreads, sm3, s>>>(a);
    err[2] = cudaGetLastError();
  }
  if (err[2]) return;
  err[3] = allow_smem(ssd_bwd_tc_bc<HD, DS>, sm4);
  if (!err[3]) {
    ssd_bwd_tc_bc<HD, DS><<<dim3(a.nc * (a.nt * 2 * a.KS + a.H), a.batch),
                            kThreads, sm4, s>>>(a);
    err[3] = cudaGetLastError();
  }
  if (err[3]) return;
  const long long n = (long long)a.batch * a.S * DS + a.H;
  ssd_bwd_tc_sum<<<static_cast<unsigned>((n + kSumThreads - 1) /
                                         kSumThreads),
                   kSumThreads, 0, s>>>(a, DS);
  err[4] = cudaGetLastError();
}

// registers, shared memory (static + dynamic, with bf16 dy), local memory
// and resident blocks an SM (at that dynamic shared memory) of kernel
// `which` (launch order) at (HD, DS)
template <typename F>
int info_of(F* kernel, int threads, size_t dyn, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = dyn ? allow_smem(kernel, dyn) : cudaSuccess;
  if (!e) e = cudaFuncGetAttributes(&attr, kernel);
  if (!e)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel,
                                                      threads, dyn);
  if (e) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes + dyn);
  out[2] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

template <int HD, int DS>
int info(int which, int* out) {
  switch (which) {
    case 0:
      return info_of(ssd_bwd_tc_states<HD, DS>, kThreads,
                     states_smem_bytes<HD, DS>(false), out);
    case 1: return info_of(ssd_bwd_tc_pass, kPassThreads, 0, out);
    case 2:
      return info_of(ssd_bwd_tc_chunk<HD, DS>, kThreads,
                     chunk_smem_bytes<HD, DS>(false), out);
    case 3:
      return info_of(ssd_bwd_tc_bc<HD, DS>, kThreads,
                     bc_smem_bytes<HD, DS>(false), out);
    case 4: return info_of(ssd_bwd_tc_sum, kSumThreads, 0, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD, typename F>
bool by_ds(int DS, F&& f) {
  switch (DS) {
    case 16: f(std::integral_constant<int, HD>(), std::integral_constant<int, 16>()); return true;
    case 32: f(std::integral_constant<int, HD>(), std::integral_constant<int, 32>()); return true;
    case 64: f(std::integral_constant<int, HD>(), std::integral_constant<int, 64>()); return true;
    case 128: f(std::integral_constant<int, HD>(), std::integral_constant<int, 128>()); return true;
    default: return false;
  }
}

// calls f(integral_constant HD, integral_constant DS); false if not taken
template <typename F>
bool by_dims(int HD, int DS, F&& f) {
  switch (HD) {
    case 16: return by_ds<16>(DS, f);
    case 32: return by_ds<32>(DS, f);
    case 64: return by_ds<64>(DS, f);
    default: return false;
  }
}

// The scratch, carved from one f32 and one bf16 buffer, each piece on 32
// bytes: offsets into each and the sizes (ssd_bwd_scratch reports them).
struct Scratch {
  long long st, gs, dec, fac, sc, wp, vec, dep, dap, bcp, f32_floats;
  long long pl, dyp, bf16_elems;
};

Scratch scratch_of(int batch, int S, int H, int HD, int DS, int chunk, int G,
                   int KS, bool dy_bf16) {
  long long nf = 0, nb = 0;
  const auto take = [](long long& n, long long k) {
    const long long o = n;
    n += (k + 7) / 8 * 8;
    return o;
  };
  const int nc = S / chunk, T = chunk < kTile ? chunk : kTile;
  const int nt = chunk / T, ngroups = (H + G - 1) / G;
  const long long bnh = (long long)batch * nc * H, state = bnh * HD * DS;
  const long long qq = (long long)batch * nc * chunk * chunk;
  Scratch c;
  c.st = take(nf, state);
  c.gs = take(nf, state);
  c.dec = take(nf, bnh);
  c.fac = take(nf, bnh * 2 * chunk);
  c.sc = take(nf, qq);
  c.wp = take(nf, ngroups * qq);
  c.vec = take(nf, bnh * (kR0 + nt) * chunk);
  c.dep = take(nf, bnh * (HD * DS / 256));
  c.dap = take(nf, bnh);
  c.bcp = take(nf, (long long)KS * 2 * batch * S * DS);
  c.f32_floats = nf;
  c.pl = take(nb, 4 * state);
  c.dyp = take(nb, dy_bf16 ? 0 : 2LL * batch * S * H * HD);
  c.bf16_elems = nb;
  return c;
}

// the sizes, chunk, dy type, head group and splits the path takes
bool takes(int batch, int S, int H, int HD, int DS, int chunk, int G, int KS,
           int dy_dtype) {
  const bool chunk_ok = chunk >= 8 && chunk <= kMaxChunk &&
                        (chunk & (chunk - 1)) == 0;
  return batch > 0 && batch <= 65535 && S > 0 && H > 0 && chunk_ok &&
         S % chunk == 0 && (dy_dtype == 0 || dy_dtype == 1) && G >= 1 &&
         KS >= 1 && KS <= H && (HD * DS) % 256 == 0 &&
         by_dims(HD, DS, [](auto, auto) {});
}

}  // namespace tc

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

// The tensor-core path: x, B and C bfloat16, dy float32 or bfloat16
// (dy_dtype 0 or 1), dt and A float32.  x, B, C and dy start on 16 bytes,
// their last dim contiguous and their strides over (b, s[, h]) multiples of
// 8 elements.  dx (b, s, nh, HD) and dB, dC (b, s, DS) bfloat16, ddt (b, s,
// nh) and dA (nh,) float32, all contiguous.  G heads a group of the chunk
// kernel, KS splits of the heads for dB and dC.  f32s and bf16s are the
// caller's scratch of f32_floats and bf16_elems elements (ssd_bwd_scratch
// gives the sizes; fewer is refused).  err[5] receives the
// cudaError_t of each launch; returns the first that is not 0.
extern "C" int ssd_scan_bwd_bf16_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* dy, void* dx, void* ddt, void* dA, void* dB,
    void* dC, void* f32s, void* bf16s, long long f32_floats,
    long long bf16_elems, int dy_dtype, int batch, int S, int H, int HD,
    int DS, int chunk, int G, int KS, long long xb, long long xs,
    long long xh, long long yb, long long ys, long long yh, long long db,
    long long ds, long long dh, long long bb, long long bs, long long cb,
    long long cs, void* stream, int* err) {
  for (int k = 0; k < 5; ++k) err[k] = 0;
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(B) |
      reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(dy);
  const long long strides = xb | xs | xh | yb | ys | yh | bb | bs | cb | cs;
  if (!tc::takes(batch, S, H, HD, DS, chunk, G, KS, dy_dtype) ||
      (addr & 15) || (strides & 7)) {
    err[0] = static_cast<int>(cudaErrorInvalidValue);
    return err[0];
  }
  using tc::bf16;
  const int nc = S / chunk, T = chunk < tc::kTile ? chunk : tc::kTile;
  const int nt = chunk / T, ngroups = (H + G - 1) / G;
  const tc::Scratch o =
      tc::scratch_of(batch, S, H, HD, DS, chunk, G, KS, dy_dtype);
  if (o.f32_floats > f32_floats || o.bf16_elems > bf16_elems) {
    err[0] = static_cast<int>(cudaErrorInvalidValue);
    return err[0];
  }
  float* fs = static_cast<float*>(f32s);
  bf16* hs = static_cast<bf16*>(bf16s);
  tc::Args a{};
  a.x = static_cast<const bf16*>(x);
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = static_cast<const bf16*>(B);
  a.C = static_cast<const bf16*>(C);
  a.dy = dy;
  a.dx = static_cast<bf16*>(dx);
  a.ddt = static_cast<float*>(ddt);
  a.dA = static_cast<float*>(dA);
  a.dB = static_cast<bf16*>(dB);
  a.dC = static_cast<bf16*>(dC);
  a.st = fs + o.st;
  a.gs = fs + o.gs;
  a.dec = fs + o.dec;
  a.fac = fs + o.fac;
  a.sc = fs + o.sc;
  a.wp = fs + o.wp;
  a.vec = fs + o.vec;
  a.dep = fs + o.dep;
  a.dap = fs + o.dap;
  a.bcp = fs + o.bcp;
  a.pl = hs + o.pl;
  a.dyp = hs + o.dyp;
  if (dy_dtype) {
    a.dyh = static_cast<const bf16*>(dy);
    a.dyl = nullptr;
    a.hb = yb;
    a.hs = ys;
    a.hh = yh;
  } else {
    a.dyh = a.dyp;
    a.dyl = a.dyp + (long long)batch * S * H * HD;
    a.hb = (long long)S * H * HD;
    a.hs = (long long)H * HD;
    a.hh = HD;
  }
  a.xb = xb; a.xs = xs; a.xh = xh;
  a.yb = yb; a.ys = ys; a.yh = yh;
  a.db = db; a.ds = ds; a.dh = dh;
  a.bb = bb; a.bs = bs; a.cb = cb; a.cs = cs;
  a.batch = batch; a.S = S; a.H = H; a.chunk = chunk; a.nc = nc; a.nt = nt;
  a.T = T; a.G = G; a.ngroups = ngroups; a.KS = KS;
  a.nblk = HD * DS / 256; a.dy_bf16 = dy_dtype;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = tc::by_dims(HD, DS, [&](auto hd, auto dsz) {
    tc::launch<decltype(hd)::value, decltype(dsz)::value>(a, s, err);
  });
  if (!ok) err[0] = static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 5; ++k)
    if (err[k]) return err[k];
  return 0;
}

// sizes[2] = the f32 floats and the bf16 elements of the tensor-core
// path's scratch at these arguments of ssd_scan_bwd_bf16_launch; returns
// cudaErrorInvalidValue for arguments the launcher does not take.
extern "C" int ssd_bwd_scratch(int batch, int S, int H, int HD, int DS,
                               int chunk, int G, int KS, int dy_dtype,
                               long long* sizes) {
  if (!tc::takes(batch, S, H, HD, DS, chunk, G, KS, dy_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const tc::Scratch o =
      tc::scratch_of(batch, S, H, HD, DS, chunk, G, KS, dy_dtype);
  sizes[0] = o.f32_floats;
  sizes[1] = o.bf16_elems;
  return 0;
}

// info[4] = registers, shared memory bytes, local (spill and stack) bytes
// and resident blocks an SM of the tensor-core path's kernel `which` (0
// states, 1 pass, 2 chunk, 3 bc, 4 sum) at (HD, DS), as the CUDA runtime
// reports them.
extern "C" int ssd_bwd_kernel_info(int HD, int DS, int which, int* info) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  tc::by_dims(HD, DS, [&](auto hd, auto dsz) {
    rc = tc::info<decltype(hd)::value, decltype(dsz)::value>(which, info);
  });
  return rc;
}
