// Chunked Mamba-2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel
// (pl.pallas_call in ssd_scan, file line 105; its _segsum_tril at line 30).
// For x (b, s, nh, hd), dt (b, s, nh), A (nh,), B and C (b, s, ds) (one
// group: B and C are shared by every head), the recurrence
//   h_t = h_{t-1} exp(dt_t A) + dt_t B_t x_t^T,   y_t = C_t . h_t
// is computed chunk by chunk in its dual form.  With seg(j, i] the sum of
// dt A over the steps j+1..i of a chunk of Q steps:
//   y_i   = sum_{j<=i} exp(seg(j, i]) (C_i . B_j) dt_j x_j         (diagonal)
//         + exp(seg(-1, i]) C_i . state                          (off-diag.)
//   state <- exp(seg(-1, Q-1]) state
//            + sum_j exp(seg(j, Q-1]) dt_j x_j B_j^T
// The TPU kernel carries the state in VMEM along a sequential grid axis.
// Two paths, by the inputs' types: x, B and C all bf16 (the model's
// prefill) take the tensor-core path below; any f32 among them takes
// ssd_scan_kernel, which reads each as f32 or bf16.
//
// Exponent precision (C3), both paths.  The TPU kernel takes seg(j, i] as
// cs_i - cs_j, the difference of two running sums; over a chunk of 256
// those reach several hundred, and the difference keeps only about 1e-4
// of a short segment's exponent.  Here every exponent is a sum of
// same-sign terms (dt > 0 > A), so nothing cancels: below a 64-row
// diagonal tile seg(j, i] = (rest of j's tile) + (whole tiles between) +
// (start of i's tile up to i), and within it each segment is summed on
// its own.  The plain version sums each segment on its own too.
//
// ssd_scan_kernel (design (a) of the two the port allows): one block per
// (b, head) walks the chunks in order with the state (hd x ds f32: 32 KB
// at mamba2-1.3b's 64 x 128, 16 KB at zamba2-2.7b's 64 x 64) in shared
// memory, so one launch does the whole scan and the state never touches
// device memory.  Hopper's blocks run in no order, so the loop over chunks
// lives inside the block.  Only b x nh blocks exist (128 for mamba2 and
// 160 for zamba2 at (2, 4096)), and all arithmetic is float32 scalar FMAs
// on the CUDA cores (a 16 x 16 thread grid; tiles loaded synchronously
// with scalar loads), so it is bound by operations: about 49 GFLOP at
// mamba2's call, 1.9x the least work since each head recomputes C B^T.
// Shared memory, f32, at chunk 256, hd 64, ds 128: C's and B's 64-row
// tiles, the state, dt x of the column tile (rows padded by one float
// where a warp reads down a column), the decayed score tile and the
// diagonal tile's segment sums, six per-row vectors: 154,880 B, one block
// per SM (105,728 B and two at ds 64).  The old state serves every row of
// a chunk before the chunk's share is added; masked entries are set to 0
// without computing the exponent.
//
// The tensor-core path: three kernels, chunk-parallel.
//   1. ssd_scan_chunk_state, one block per (b, chunk, head): the chunk's
//      own share of the state, S_c = (exp(seg(j, Q-1]) dt_j x_j)^T B, an
//      (hd x Q) . (Q x ds) product, and its total decay exp(seg(-1, Q-1]),
//      both to scratch in device memory.
//   2. ssd_scan_state_pass, one thread per four state entries of a
//      (b, head): the recurrence over chunks, prev_c = carry, carry =
//      carry dec_c + S_c, with prev_c written as two bf16 planes, hi and
//      lo = prev_c - hi (it is only ever an mma operand).
//   3. ssd_scan_chunk_out, one block per (b, chunk, head, 64-row tile of
//      the chunk), the heaviest row tiles first: y_off = exp(seg(-1, i])
//      C_i . (hi + lo)^T, then for each column tile up to the diagonal the
//      scores C_i B_j^T, decayed and masked in registers, times x_j.
// Every product is bf16 on the tensor cores (mma.sync.m16n8k16, f32
// accumulation), its tiles brought to shared memory with 16-byte cp.async
// and read with ldmatrix; rows are padded by 16 bytes, so the eight rows
// an ldmatrix reads fall on 32 distinct banks.  The score accumulators
// become the A operand of the next product in registers (the
// FlashAttention-2 layout reuse), split as hi + lo bf16 like prev: a
// single bf16 rounding of the weights or of prev costs up to 0.4 % of the
// terms a row sums, which at the prefill calls' 33M outputs breaks the
// 0.15 / 0.1 gate against the recurrence where |y| is small.  The decay
// of an entry is a product of factors, each the exponential of a
// same-sign sum (at most 1, so none overflows): exp(pre_i) exp(mid)
// exp(suf_j) over 64-row tiles below the diagonal tile, the same over
// 16-row blocks on it, and within one 16-row block a table of running
// sums.  The wrapper allocates the scratch (S_c in f32, the decays, prev);
// the kernels allocate nothing.
//
// What bounds the tensor-core path on this card.  At mamba2's call (2,
// 4096, 64, 64, 128), chunk 256, its device-memory traffic is about 0.5
// GB (x and y 67 MB each, S_c 67 MB of f32 written and read, prev's two
// planes 67 MB written and read): 0.15 ms at 3.35 TB/s; its tensor-core
// work about 71 GFLOP (scores per head, 1.9x the least work; the hi + lo
// splits double the other products): 0.07 ms at the dense bf16 rate.  As
// measured, chunk_out takes most of the time, held by what its 8,192
// blocks move into the SMs (C, B and x tiles read again by each row tile,
// prev by all four: about 0.9 GB) and by how many an SM holds at once:
// prev's planes borrow B's second stage and both of x's, so three blocks
// fit at ds 128 and four at ds 64.
//
// Plain C interface, loaded with ctypes: each launcher returns a
// cudaError_t (0 on success); a size, chunk, type or alignment it does
// not take returns cudaErrorInvalidValue before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tc.cuh"  // the bf16 path's PTX, tile and decay helpers

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kTile = 64;      // rows of a chunk's row and column tiles
constexpr int kMaxChunk = 256;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  long long xb, xs, xh;  // element strides of x over (b, s, h); hd is 1
  long long db, ds, dh;  // of dt over (b, s, h)
  long long bb, bs;      // of B over (b, s); ds is 1
  long long cb, cs;      // of C over (b, s)
  int S, chunk, x_bf16, bc_bf16;
};

__device__ __forceinline__ float load(const void* p, long long i,
                                      int is_bf16) {
  return is_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
             : static_cast<const float*>(p)[i];
}

template <int HD, int DS>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kTile * (DS + 1) + HD * (DS + 1) +
                          kTile * HD + 2 * kTile * (kTile + 1) +
                          6 * kMaxChunk);
}

// Two blocks fit on an SM below ds 128 (shared memory above), so those
// instantiations are held to 128 registers; ds 128 runs one block per SM
// and may use more rather than spill.
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, DS < 128 ? 2 : 1)
    ssd_scan_kernel(Args a) {
  constexpr int CP = DS + 1;     // padded rows of sC, sB, sS
  constexpr int WP = kTile + 1;  // padded rows of sW
  constexpr int RT = kTile / 16; // tile rows (and score columns) per thread
  constexpr int RY = HD / 16;    // y columns (and state rows) per thread
  constexpr int RS = DS / 16;    // state columns per thread
  extern __shared__ float smem[];
  float* sC = smem;              // [kTile][CP]  C, row tile
  float* sB = sC + kTile * CP;   // [kTile][CP]  B, column tile
  float* sS = sB + kTile * CP;   // [HD][CP]     state (p, n)
  float* sX = sS + HD * CP;      // [kTile][HD]  dt_j x_j, column tile
  float* sW = sX + kTile * HD;   // [kTile][WP]  decayed masked scores
  float* sSeg = sW + kTile * WP; // [kTile][WP]  diagonal tile's segment sums
  float* sDA = sSeg + kTile * WP;  // [kMaxChunk] dt A
  float* sDt = sDA + kMaxChunk;    // [kMaxChunk] dt
  float* sPre = sDt + kMaxChunk;   // [kMaxChunk] sum of dA, tile start..i
  float* sSuf = sPre + kMaxChunk;  // [kMaxChunk] sum of dA, j+1..tile end
  float* sIn = sSuf + kMaxChunk;   // [kMaxChunk] exp(sum of dA, 0..i)
  float* sEnd = sIn + kMaxChunk;   // [kMaxChunk] exp(sum of dA, j+1..Q-1)
  __shared__ float sTot[kMaxChunk / kTile + 1];  // tile sums, then chunk's

  const int h = blockIdx.x, b = blockIdx.y, nh = gridDim.x;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Q = a.chunk, T = min(Q, kTile), nt = Q / T;
  const float Ah = a.A[h];

  for (int i = tid; i < HD * CP; i += kThreads) sS[i] = 0.f;

  for (int t0 = 0; t0 < a.S; t0 += Q) {
    __syncthreads();  // the last chunk's state and tiles are settled
    if (tid < Q) {
      const float dtv = a.dt[b * a.db + (t0 + tid) * a.ds + h * a.dh];
      sDt[tid] = dtv;
      sDA[tid] = dtv * Ah;
    }
    __syncthreads();
    // decay exponents as sums of same-sign terms (head note: precision)
    if (tid < Q) {
      const int ts = tid - tid % T;
      float pre = 0.f, suf = 0.f;
      for (int k = ts; k <= tid; ++k) pre += sDA[k];
      for (int k = tid + 1; k < ts + T; ++k) suf += sDA[k];
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
    if (tid == 0) {
      float all = 0.f;
      for (int u = 0; u < nt; ++u) all += sTot[u];
      sTot[kMaxChunk / kTile] = all;
    }

    float st[RY][RS];  // this chunk's share of the new state, (p, n)
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int c = 0; c < RS; ++c) st[r][c] = 0.f;

    for (int it = 0; it < nt; ++it) {
      const int i0 = it * T;
      __syncthreads();  // sC, sSeg of the last row tile are no longer read
      if (tid < T) {  // the diagonal tile's sums of dA over (j, i], i = tid
        float seg = 0.f;
        sSeg[tid * WP + tid] = 0.f;
        for (int j = tid - 1; j >= 0; --j) {
          seg += sDA[i0 + j + 1];
          sSeg[tid * WP + j] = seg;
        }
      }
      for (int idx = tid; idx < T * DS; idx += kThreads) {
        const int r = idx / DS, n = idx % DS;
        sC[r * CP + n] =
            load(a.C, b * a.cb + (long long)(t0 + i0 + r) * a.cs + n,
                 a.bc_bf16);
      }
      __syncthreads();

      // off-diagonal part: exp(seg(-1, i]) C_i . state (the state entering)
      float acc[RT][RY];
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < RY; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < DS; ++n) {
        float cv[RT], sv[RY];
#pragma unroll
        for (int r = 0; r < RT; ++r) cv[r] = sC[(ty + 16 * r) * CP + n];
#pragma unroll
        for (int c = 0; c < RY; ++c) sv[c] = sS[(tx + 16 * c) * CP + n];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RY; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        const float d = i < T ? sIn[i0 + i] : 0.f;
#pragma unroll
        for (int c = 0; c < RY; ++c) acc[r][c] *= d;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * T;
        // below the diagonal tile: (j, i] = (j, tile end] + whole tiles
        // + [tile start, i]
        float mid = 0.f;
        for (int u = jt + 1; u < it; ++u) mid += sTot[u];
        __syncthreads();  // sB, sX, sW of the last column tile are read
        for (int idx = tid; idx < T * DS; idx += kThreads) {
          const int r = idx / DS, n = idx % DS;
          sB[r * CP + n] =
              load(a.B, b * a.bb + (long long)(t0 + j0 + r) * a.bs + n,
                   a.bc_bf16);
        }
        for (int idx = tid; idx < T * HD; idx += kThreads) {
          const int r = idx / HD, p = idx % HD;
          sX[r * HD + p] =
              sDt[j0 + r] *
              load(a.x, b * a.xb + (long long)(t0 + j0 + r) * a.xs +
                            h * a.xh + p,
                   a.x_bf16);
        }
        __syncthreads();

        // scores C_i . B_j of the tile, masked, then decayed
        float s[RT][RT];
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int c = 0; c < RT; ++c) s[r][c] = 0.f;
        for (int n = 0; n < DS; ++n) {
          float cv[RT], bv[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) cv[r] = sC[(ty + 16 * r) * CP + n];
#pragma unroll
          for (int c = 0; c < RT; ++c) bv[c] = sB[(tx + 16 * c) * CP + n];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < RT; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int i = ty + 16 * r;
#pragma unroll
          for (int c = 0; c < RT; ++c) {
            const int j = tx + 16 * c;
            float w = 0.f;  // mask first: no exponent above the diagonal
            if (i < T && j < T) {
              if (jt < it)
                w = s[r][c] * expf(sPre[i0 + i] + sSuf[j0 + j] + mid);
              else if (j <= i)
                w = s[r][c] * expf(sSeg[i * WP + j]);
            }
            sW[i * WP + j] = w;
          }
        }

        if (jt == it) {  // each column tile's one turn: its state share
          for (int j = 0; j < T; ++j) {
            const float e = sEnd[j0 + j];
            float xv[RY], bv[RS];
#pragma unroll
            for (int r = 0; r < RY; ++r) xv[r] = sX[j * HD + ty + 16 * r] * e;
#pragma unroll
            for (int c = 0; c < RS; ++c) bv[c] = sB[j * CP + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < RY; ++r)
#pragma unroll
              for (int c = 0; c < RS; ++c)
                st[r][c] = fmaf(xv[r], bv[c], st[r][c]);
          }
        }
        __syncthreads();

        // diagonal part: the weights times dt x
        for (int j = 0; j < T; ++j) {
          float wv[RT], xv[RY];
#pragma unroll
          for (int r = 0; r < RT; ++r) wv[r] = sW[(ty + 16 * r) * WP + j];
#pragma unroll
          for (int c = 0; c < RY; ++c) xv[c] = sX[j * HD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int c = 0; c < RY; ++c)
              acc[r][c] = fmaf(wv[r], xv[c], acc[r][c]);
        }
      }

#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = ty + 16 * r;
        if (i >= T) continue;
        const long long row =
            ((long long)b * a.S + t0 + i0 + i) * nh + h;
#pragma unroll
        for (int c = 0; c < RY; ++c) {
          const long long o = row * HD + tx + 16 * c;
          if (a.x_bf16)
            static_cast<__nv_bfloat16*>(a.y)[o] = __float2bfloat16(acc[r][c]);
          else
            static_cast<float*>(a.y)[o] = acc[r][c];
        }
      }
    }

    __syncthreads();  // every row of the chunk has read the old state
    const float dec = expf(sTot[kMaxChunk / kTile]);
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int c = 0; c < RS; ++c) {
        float* p = sS + (ty + 16 * r) * CP + tx + 16 * c;
        *p = fmaf(*p, dec, st[r][c]);
      }
  }
}

template <int HD, int DS>
cudaError_t launch(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, DS>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<HD, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<HD, DS><<<dim3(H, B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_ds(int DS, const Args& a, int B, int H, cudaStream_t s) {
  switch (DS) {
    case 16: return launch<HD, 16>(a, B, H, s);
    case 32: return launch<HD, 32>(a, B, H, s);
    case 64: return launch<HD, 64>(a, B, H, s);
    case 128: return launch<HD, 128>(a, B, H, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core path (x, B and C bf16): three kernels, chunk-parallel
// ---------------------------------------------------------------------------

using ssd_tc::bf16;
using ssd_tc::kPad;  // bf16 elements after each shared row

constexpr int kBfThreads = ssd_tc::kThreads;  // four warps, 16 rows each
constexpr int kPassThreads = 256;

struct BfArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* B;
  const bf16* C;
  bf16* y;
  float* st;    // (b, nc, nh, hd, ds) each chunk's own share of the state
  float* dec;   // (b, nc, nh) exp(sum of the chunk's dt A)
  bf16* prev;   // (2, b, nc, nh, hd, ds) the state entering each chunk:
                // hi, then lo = state - hi
  float* fac;   // (b, nc, nh, kFields, chunk) decay factors (Field)
  long long xb, xs, xh, db, ds, dh, bb, bs, cb, cs;
  int batch, S, H, chunk, nc;
};

// the tensor-core helpers (csrc/ssd_tc.cuh)
using ssd_tc::cp_async16;
using ssd_tc::cp_async_commit;
using ssd_tc::cp_async_wait;
using ssd_tc::chunk_decays;
using ssd_tc::Decay;
using ssd_tc::decay_at;
using ssd_tc::kDecayFloats;
using ssd_tc::ldsm_x2_t;
using ssd_tc::ldsm_x4;
using ssd_tc::ldsm_x4_t;
using ssd_tc::mma;
using ssd_tc::pack2;
using ssd_tc::smem_u32;
using ssd_tc::split2;
using ssd_tc::tile_to_smem;

// The factor record chunk_state leaves for chunk_out, per (b, chunk, head):
// kFields rows of Q floats.  Row kTot holds the 16-row block totals, then
// the 64-row tile totals (at most Q / 16 + Q / 64 <= Q floats).
enum Field {
  kIn,     // exp(seg(-1, i])                    (y_off)
  kPre,    // exp(sum of dA over i's tile start..i)
  kPre16,  // exp(sum of dA over i's 16-row block start..i)
  kSuf16,  // exp(sum of dA over i+1..block end) dt_i
  kSuf,    // exp(sum of dA over i+1..tile end) dt_i
  kDA,     // dt_i A
  kDt,     // dt_i
  kTot,
  kFields
};


template <int HD, int DS>
constexpr size_t state_smem_bytes() {
  return 2 * sizeof(bf16) * kTile * ((HD + kPad) + (DS + kPad)) +
         sizeof(float) * kDecayFloats;
}

// chunk_out's decay factors: four fields of the tile's rows, kSuf of the
// rows before it (at most the chunk's first three tiles), the totals, the
// 4 x 4 table of whole 16-row blocks between two blocks, and per 16-row
// block of the tile a 16 x 16 table.
constexpr int kFactorFloats =
    4 * kTile + kMaxChunk - kTile + 32 + 16 + 4 * 256;

// C's tile, two stages of B's and x's; prev's two planes borrow B's second
// stage and both of x's (hd (ds + 8) <= 2 x 64 (hd + 8) for hd <= 128).
// At hd 64, ds 128 that is 76,736 B: three blocks on an SM.
template <int HD, int DS>
constexpr size_t out_smem_bytes() {
  return sizeof(bf16) * (3 * kTile * (DS + kPad) + 2 * kTile * (HD + kPad)) +
         sizeof(float) * kFactorFloats;
}

// n floats (a multiple of 4) by 16-byte cp.async
__device__ __forceinline__ void floats_to_smem(float* dst, const float* src,
                                               int n) {
  for (int k = threadIdx.x; k < n / 4; k += kBfThreads)
    cp_async16(dst + 4 * k, src + 4 * k);
}

// 1. The chunk's share of the state, S_c[p][n] = sum_j x_j[p] dt_j
// exp(seg(j, Q-1]) B_j[n]: A = the scaled x tile read transposed
// (ldmatrix.trans from [j][p]), B = the B tile [j][n] read transposed, over
// 64-row k-tiles in two cp.async stages.  Warps split hd into 16-row
// m-tiles and ds into groups of n8 tiles.
template <int HD, int DS>
__global__ void __launch_bounds__(kBfThreads)
    ssd_scan_chunk_state(BfArgs a) {
  constexpr int XW = HD + kPad, BW = DS + kPad;
  constexpr int MT = HD / 16, NTN = DS / 8;
  constexpr int NG = (4 / MT) < NTN ? (4 / MT) : NTN;  // warps along ds
  constexpr int NPW = NTN / NG;                        // n8 tiles a warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [2][kTile][XW]
  bf16* sB = sX + 2 * kTile * XW;                 // [2][kTile][BW]
  const Decay d = decay_at(reinterpret_cast<float*>(sB + 2 * kTile * BW));
  float* scale = d.pre16;  // dt_j exp(seg(j, Q-1]), once pre16 is read

  const int c = blockIdx.x / a.H, h = blockIdx.x % a.H, b = blockIdx.y;
  const int Q = a.chunk, KT = min(Q, kTile), KR = max(KT, 16);
  const int nk = Q / KT;
  const long long t0 = (long long)c * Q;
  const bf16* xg = a.x + b * a.xb + t0 * a.xs + h * a.xh;
  const bf16* bg = a.B + b * a.bb + t0 * a.bs;
  auto load = [&](int kt, int buf) {
    tile_to_smem<HD>(sX + buf * kTile * XW, XW, xg + kt * KT * a.xs, a.xs,
                     KT, KR);
    tile_to_smem<DS>(sB + buf * kTile * BW, BW, bg + kt * KT * a.bs, a.bs,
                     KT, KR);
    cp_async_commit();
  };
  load(0, 0);
  chunk_decays(d, a.dt + b * a.db + t0 * a.ds + h * a.dh, a.ds, a.A[h], Q);
  // tiles hold 64 rows when there are several, so nk counts d.tot64
  const long long bch = ((long long)b * a.nc + c) * a.H + h;
  float* rec = a.fac + bch * kFields * Q;
  for (int i = threadIdx.x; i < KR * nk; i += kBfThreads) {
    float sc = 0.f;  // rows past a chunk of 8 (the k16 pad) scale by 0
    if (i < Q) {
      const int t = i >> 6;
      float before = d.pre64[i], after = d.suf64[i];
      for (int u = 0; u < t; ++u) before += d.tot64[u];
      for (int u = t + 1; u < nk; ++u) after += d.tot64[u];
      const float dti = d.dt[i];
      rec[kIn * Q + i] = expf(before);
      rec[kPre * Q + i] = expf(d.pre64[i]);
      rec[kPre16 * Q + i] = expf(d.pre16[i]);
      rec[kSuf16 * Q + i] = expf(d.suf16[i]) * dti;
      rec[kSuf * Q + i] = expf(d.suf64[i]) * dti;
      rec[kDA * Q + i] = d.dA[i];
      rec[kDt * Q + i] = dti;
      sc = dti * expf(after);
    }
    scale[i] = sc;  // pre16's slot, read above by this thread only
  }
  const int nb = (Q + 15) >> 4;
  for (int i = threadIdx.x; i < nb + nk; i += kBfThreads)
    rec[kTot * Q + i] = i < nb ? d.tot16[i] : d.tot64[i - nb];
  if (threadIdx.x == 0) {
    float all = 0.f;
    for (int u = 0; u < nk; ++u) all += d.tot64[u];
    a.dec[bch] = expf(all);
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = warp < MT * NG;
  const int m0 = (warp % MT) * 16, nw = (warp / MT) * NPW;
  float acc[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tX = sX + (kt & 1) * kTile * XW;
    const bf16* tB = sB + (kt & 1) * kTile * BW;
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        if (ks * 16 >= KR) break;
        // x_j dt_j exp(seg(j, Q-1]) in f32 from the raw fragment, split as
        // bf16 hi + lo; a fragment holds rows j = k0 + 2t + {0, 1, 8, 9}
        uint32_t raw[4], af[4], al[4];
        ldsm_x4_t(raw, tX + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * XW +
                           m0 + ((lane >> 3) & 1) * 8);
        const float* sc = scale + kt * KR + ks * 16 + 2 * (lane & 3);
        const float2 s01 = *reinterpret_cast<const float2*>(sc);
        const float2 s89 = *reinterpret_cast<const float2*>(sc + 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 sv = r < 2 ? s01 : s89;
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw[r]));
          split2(v.x * sv.x, v.y * sv.y, af[r], al[r]);
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
    float* out = a.st + bch * HD * DS;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int np = 0; np < NPW; ++np) {
      const int n = (nw + np) * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + (m0 + g) * DS + n) =
          make_float2(acc[np][0], acc[np][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * DS + n) =
          make_float2(acc[np][2], acc[np][3]);
    }
  }
}

// 2. The state entering each chunk: carry over the chunks in order, four
// entries of one (b, head) per thread; prev_c is stored as bf16 hi and lo
// planes.
__global__ void __launch_bounds__(kPassThreads)
    ssd_scan_state_pass(BfArgs a, int hd_ds) {
  const int per = hd_ds / 4;
  const long long idx = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (idx >= (long long)a.batch * a.H * per) return;
  const int e = static_cast<int>(idx % per);
  const long long bh = idx / per;
  const int h = static_cast<int>(bh % a.H), b = static_cast<int>(bh / a.H);
  const long long plane = (long long)a.batch * a.nc * a.H * per;  // uint2s
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < a.nc; ++c) {
    const long long bch = ((long long)b * a.nc + c) * a.H + h;
    const long long o = bch * per + e;
    const float4 s = reinterpret_cast<const float4*>(a.st)[o];
    const float dc = a.dec[bch];
    uint2 hi, lo;
    split2(carry.x, carry.y, hi.x, lo.x);
    split2(carry.z, carry.w, hi.y, lo.y);
    reinterpret_cast<uint2*>(a.prev)[o] = hi;
    reinterpret_cast<uint2*>(a.prev)[o + plane] = lo;
    carry.x = fmaf(carry.x, dc, s.x);
    carry.y = fmaf(carry.y, dc, s.y);
    carry.z = fmaf(carry.z, dc, s.z);
    carry.w = fmaf(carry.w, dc, s.w);
  }
}

// Column of a 16 x 16 diagonal-block table: 8-column halves swap on row
// pairs 2-3 mod 4, so a warp's float2 reads of 4 rows hit 32 banks.
__device__ __forceinline__ int din_at(int r, int c) {
  return r * 16 + (c ^ (((r >> 1) & 1) << 3));
}

// 3. One row tile of one chunk and head: y = exp(seg(-1, i]) C_i prev^T +
// sum over column tiles jt <= it of W_ij x_j, W = (C_i B_j^T) masked and
// decayed, times dt_j.  Each warp owns 16 rows; C's fragments stay in
// registers for the whole block, B_j and x_j come in two cp.async stages.
// Decay factors: exp(seg(j, i]) = exp(pre_i) exp(mid) exp(suf_j) over
// 64-row tiles below the diagonal tile, the same over 16-row blocks on
// it, and a table of exp(sum of dA over (j, i]) within a 16-row block;
// each factor is the exponential of a same-sign sum and at most 1.
template <int HD, int DS>
__global__ void __launch_bounds__(kBfThreads)
    ssd_scan_chunk_out(BfArgs a) {
  constexpr int XW = HD + kPad, BW = DS + kPad;
  constexpr int KD = DS / 16;     // k16 steps over ds
  constexpr int NY = HD / 8;      // n8 tiles of y
  constexpr int NS = kTile / 8;   // n8 tiles of a score row
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [kTile][BW]
  bf16* sB = sC + kTile * BW;                     // [2][kTile][BW]
  bf16* sX = sB + 2 * kTile * BW;                 // [2][kTile][XW]
  bf16* sPh = sB + kTile * BW;  // [HD][BW] prev's hi plane, until y_off
  bf16* sPl = sX;               // [HD][BW] prev's lo plane, until y_off
  // the record's fields kIn..kSuf16 for the tile's rows (kTile each),
  // kSuf of the rows before it, the totals
  float* fRow = reinterpret_cast<float*>(sX + 2 * kTile * XW);
  float* fC = fRow + 4 * kTile;           // [kMaxChunk - kTile] kSuf
  float* fTot = fC + kMaxChunk - kTile;   // [32] kTot
  float* fM16 = fTot + 32;        // [4][4] exp(blocks strictly between)
  float* fD = fM16 + 16;          // [4][256] within-block tables (din_at)
  const float* fY = fRow;                 // kIn
  const float* fR = fRow + kTile;         // kPre
  const float* fR16 = fRow + 2 * kTile;   // kPre16
  const float* fC16 = fRow + 3 * kTile;   // kSuf16

  const int c = blockIdx.x / a.H, h = blockIdx.x % a.H, b = blockIdx.y;
  const int Q = a.chunk, T = min(Q, kTile), TM = max(T, 16);
  const int it = Q / T - 1 - static_cast<int>(blockIdx.z);  // heaviest first
  const long long t0 = (long long)c * Q, i0 = t0 + it * T;
  const long long bch = ((long long)b * a.nc + c) * a.H + h;
  const bf16* xg = a.x + b * a.xb + t0 * a.xs + h * a.xh;
  const bf16* bg = a.B + b * a.bb + t0 * a.bs;
  auto load_b = [&](int jt, int buf) {
    tile_to_smem<DS>(sB + buf * kTile * BW, BW, bg + jt * T * a.bs, a.bs, T,
                     TM);
  };
  auto load_x = [&](int jt, int buf) {
    tile_to_smem<HD>(sX + buf * kTile * XW, XW, xg + jt * T * a.xs, a.xs, T,
                     TM);
  };
  // C, B's first column tile and prev's planes first; x's first column
  // tile once y_off has read prev's lo plane from x's stages
  tile_to_smem<DS>(sC, BW, a.C + b * a.cb + i0 * a.cs, a.cs, T, TM);
  load_b(0, 0);
  if (c > 0) {
    const bf16* pg = a.prev + bch * HD * DS;
    const long long plane = (long long)a.batch * a.nc * a.H * HD * DS;
    tile_to_smem<DS>(sPh, BW, pg, (long long)DS, HD, HD);
    tile_to_smem<DS>(sPl, BW, pg + plane, (long long)DS, HD, HD);
  }
  const int ib = it * T;  // the tile's first row in the chunk
  {
    const float* rec = a.fac + bch * kFields * Q;
#pragma unroll
    for (int f = kIn; f <= kSuf16; ++f) {
      floats_to_smem(fRow + f * kTile, rec + f * Q + ib, T);
      for (int r = T + threadIdx.x; r < TM; r += kBfThreads)
        fRow[f * kTile + r] = 0.f;  // a chunk of 8's pad rows weigh 0
    }
    floats_to_smem(fC, rec + kSuf * Q, ib);
    floats_to_smem(fTot, rec + kTot * Q, min(Q, 32));
    cp_async_commit();
  }
  const int nb = (Q + 15) >> 4;  // fTot: nb block totals, then the tiles'
  const float* tot64 = fTot + nb;
  {  // the tables, from the record in device memory while the tiles load
    const float* rec = a.fac + bch * kFields * Q;
    if (threadIdx.x < 16) {
      const int bi = threadIdx.x >> 2, bj = threadIdx.x & 3;
      float m = 0.f;
      for (int u = bj + 1; u < bi; ++u) m += rec[kTot * Q + (ib >> 4) + u];
      fM16[threadIdx.x] = bi > bj ? expf(m) : 0.f;
    }
    if (threadIdx.x < TM) {  // column jl of its block's table: a running sum
      const int jl = threadIdx.x, blk = jl >> 4;
      const float* dA = rec + kDA * Q + ib + blk * 16;
      const float dtj = jl < T ? rec[kDt * Q + ib + jl] : 0.f;
      float seg = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int il = blk * 16 + r;
        float v = 0.f;
        if (jl < T && il < T && il >= jl) {
          if (il > jl) seg += dA[r];
          v = expf(seg) * dtj;
        }
        fD[blk * 256 + din_at(r, jl & 15)] = v;
      }
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const bool active = warp * 16 < TM;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's rows
  float acc[NY][4];
#pragma unroll
  for (int n = 0; n < NY; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t cf[KD][4];

  cp_async_wait<0>();
  __syncthreads();
  if (active) {
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      ldsm_x4(cf[ks], sC + (warp * 16 + (lane & 15)) * BW + ks * 16 +
                          (lane >> 4) * 8);
    if (c > 0) {  // y_off = exp(seg(-1, i]) C_i . (hi + lo)
#pragma unroll
      for (int plane = 0; plane < 2; ++plane) {
        const bf16* tp = plane ? sPl : sPh;
#pragma unroll
        for (int ks = 0; ks < KD; ++ks)
#pragma unroll
          for (int np = 0; np < NY; np += 2) {
            uint32_t bfr[4];
            ldsm_x4(bfr, tp + (np * 8 + (lane & 7) + (lane >> 4) * 8) * BW +
                             ks * 16 + ((lane >> 3) & 1) * 8);
            mma(acc[np], cf[ks], bfr[0], bfr[1]);
            mma(acc[np + 1], cf[ks], bfr[2], bfr[3]);
          }
      }
      const float e0 = fY[r0], e1 = fY[r1];
#pragma unroll
      for (int n = 0; n < NY; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
  }
  __syncthreads();  // prev's planes are read: their stages are free
  load_x(0, 0);
  cp_async_commit();

  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      load_b(jt + 1, (jt + 1) & 1);
      load_x(jt + 1, (jt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      // scores C_i B_j^T; on the diagonal tile only the columns up to
      // this warp's last row
      const bool diag = jt == it;
      const int ncols = diag ? min(warp * 16 + 16, TM) : TM;
      const bf16* tB = sB + (jt & 1) * kTile * BW;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
#pragma unroll
        for (int np = 0; np < NS; np += 2) {
          if (np * 8 >= ncols) break;
          uint32_t bfr[4];
          ldsm_x4(bfr, tB + (np * 8 + (lane & 7) + (lane >> 4) * 8) * BW +
                           ks * 16 + ((lane >> 3) & 1) * 8);
          mma(s[np], cf[ks], bfr[0], bfr[1]);
          mma(s[np + 1], cf[ks], bfr[2], bfr[3]);
        }

      // decay and dt_j as factors; entries above the diagonal (and the
      // pad rows and columns of a chunk of 8) get a factor of 0
      if (!diag) {
        float m = 0.f;
        for (int u = jt + 1; u < it; ++u) m += tot64[u];
        m = expf(m);
        const float a0 = fR[r0] * m, a1 = fR[r1] * m;
        const float* fc = fC + jt * T + 2 * tq;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float2 f = *reinterpret_cast<const float2*>(fc + n * 8);
          s[n][0] *= a0 * f.x;
          s[n][1] *= a0 * f.y;
          s[n][2] *= a1 * f.x;
          s[n][3] *= a1 * f.y;
        }
      } else {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          if (n * 8 >= ncols) break;
          float2 f0, f1;
          if ((n >> 1) < warp) {  // a 16-row block left of the warp's own
            const float m = fM16[warp * 4 + (n >> 1)];
            const float2 f = *reinterpret_cast<const float2*>(
                fC16 + n * 8 + 2 * tq);
            const float a0 = fR16[r0] * m, a1 = fR16[r1] * m;
            f0 = make_float2(a0 * f.x, a0 * f.y);
            f1 = make_float2(a1 * f.x, a1 * f.y);
          } else {  // the warp's own 16-row block
            const float* t = fD + warp * 256;
            const int cl = (n & 1) * 8 + 2 * tq;
            f0 = *reinterpret_cast<const float2*>(t + din_at(g, cl));
            f1 = *reinterpret_cast<const float2*>(t + din_at(g + 8, cl));
          }
          s[n][0] *= f0.x;
          s[n][1] *= f0.y;
          s[n][2] *= f1.x;
          s[n][3] *= f1.y;
        }
      }

      // y += W x_j: the score accumulators, split as hi + lo, are the
      // A fragments
      const bf16* tX = sX + (jt & 1) * kTile * XW;
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        if (kk * 16 >= ncols) break;
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int np = 0; np < NY; np += 2) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, tX + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  XW + np * 8 + (lane >> 4) * 8);
          mma(acc[np], ph, bfr[0], bfr[1]);
          mma(acc[np + 1], ph, bfr[2], bfr[3]);
          mma(acc[np], pl, bfr[0], bfr[1]);
          mma(acc[np + 1], pl, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // this stage is read before the next load refills it
  }

  // y through shared memory (sX's first stage, rows hd + 8 wide, each warp
  // its own 16), out in 16-byte pieces
  if (active) {
#pragma unroll
    for (int n = 0; n < NY; ++n) {
      const int p = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(sX + r0 * XW + p) =
          pack2(acc[n][0], acc[n][1]);
      *reinterpret_cast<uint32_t*>(sX + r1 * XW + p) =
          pack2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  bf16* yg = a.y + ((b * (long long)a.S + i0) * a.H + h) * HD;
  for (int k = threadIdx.x; k < T * (HD / 8); k += kBfThreads) {
    const int r = k / (HD / 8), q = k % (HD / 8);
    *reinterpret_cast<uint4*>(yg + (long long)r * a.H * HD + q * 8) =
        *reinterpret_cast<const uint4*>(sX + r * XW + q * 8);
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// err[k] is the cudaError_t of launch k (chunk_state, state_pass,
// chunk_out); a failed launch stops the rest.
template <int HD, int DS>
void launch_bf16(const BfArgs& a, cudaStream_t s, int* err) {
  constexpr size_t sm1 = state_smem_bytes<HD, DS>();
  constexpr size_t sm3 = out_smem_bytes<HD, DS>();
  const dim3 grid(a.nc * a.H, a.batch);
  err[0] = allow_smem(ssd_scan_chunk_state<HD, DS>, sm1);
  if (err[0] == cudaSuccess) {
    ssd_scan_chunk_state<HD, DS><<<grid, kBfThreads, sm1, s>>>(a);
    err[0] = cudaGetLastError();
  }
  if (err[0] != cudaSuccess) return;
  const long long threads = (long long)a.batch * a.H * (HD * DS / 4);
  ssd_scan_state_pass<<<static_cast<unsigned>(
                            (threads + kPassThreads - 1) / kPassThreads),
                        kPassThreads, 0, s>>>(a, HD * DS);
  err[1] = cudaGetLastError();
  if (err[1] != cudaSuccess) return;
  err[2] = allow_smem(ssd_scan_chunk_out<HD, DS>, sm3);
  if (err[2] == cudaSuccess) {
    const int nt = a.chunk >= kTile ? a.chunk / kTile : 1;
    ssd_scan_chunk_out<HD, DS>
        <<<dim3(a.nc * a.H, a.batch, nt), kBfThreads, sm3, s>>>(a);
    err[2] = cudaGetLastError();
  }
}

template <int HD>
bool launch_bf16_ds(int DS, const BfArgs& a, cudaStream_t s, int* err) {
  switch (DS) {
    case 16: launch_bf16<HD, 16>(a, s, err); return true;
    case 32: launch_bf16<HD, 32>(a, s, err); return true;
    case 64: launch_bf16<HD, 64>(a, s, err); return true;
    case 128: launch_bf16<HD, 128>(a, s, err); return true;
    default: return false;
  }
}

bool launch_bf16_hd(int HD, int DS, const BfArgs& a, cudaStream_t s,
                    int* err) {
  switch (HD) {
    case 16: return launch_bf16_ds<16>(DS, a, s, err);
    case 32: return launch_bf16_ds<32>(DS, a, s, err);
    case 64: return launch_bf16_ds<64>(DS, a, s, err);
    default: return false;
  }
}

bool chunk_ok(int chunk) {
  return chunk >= 8 && chunk <= kMaxChunk && (chunk & (chunk - 1)) == 0;
}

}  // namespace

// x_dtype, bc_dtype: 0 float32, 1 bfloat16 (y has x's).  Strides are in
// elements; the last dim of x, B and C is contiguous; y is contiguous
// (b, s, nh, hd).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* B, const void* C, void* y,
                               int x_dtype, int bc_dtype, int batch, int S,
                               int H, int HD, int DS, int chunk,
                               long long xb, long long xs, long long xh,
                               long long db, long long ds, long long dh,
                               long long bb, long long bs, long long cb,
                               long long cs, void* stream) {
  const bool chunk_ok = chunk >= 8 && chunk <= kMaxChunk &&
                        (chunk & (chunk - 1)) == 0;
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || !chunk_ok ||
      S % chunk != 0 || (x_dtype != 0 && x_dtype != 1) ||
      (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,  static_cast<const float*>(dt), static_cast<const float*>(A),
               B,  C,  y,  xb, xs, xh, db, ds, dh, bb, bs, cb, cs,
               S,  chunk, x_dtype, bc_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 16: return static_cast<int>(launch_ds<16>(DS, a, batch, H, s));
    case 32: return static_cast<int>(launch_ds<32>(DS, a, batch, H, s));
    case 64: return static_cast<int>(launch_ds<64>(DS, a, batch, H, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, B, C and y bfloat16, dt and A float32.  x, B and C start on 16 bytes
// and their strides over (b, s, h) are multiples of 8 elements.  st (b,
// nc, nh, HD, DS) f32, dec (b, nc, nh) f32, prev (2, b, nc, nh, HD, DS)
// bf16 and fac (b, nc, nh, 8, chunk) f32 are the caller's scratch.  err[3]
// receives the cudaError_t of each launch; returns the first that is not
// 0 (0 if all three launched).
extern "C" int ssd_scan_bf16_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* st, void* dec, void* prev, void* fac,
    int batch,
    int S, int H, int HD, int DS, int chunk, long long xb, long long xs,
    long long xh, long long db, long long ds, long long dh, long long bb,
    long long bs, long long cb, long long cs, void* stream, int* err) {
  err[0] = err[1] = err[2] = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(B) |
                         reinterpret_cast<uintptr_t>(C);
  const long long strides = xb | xs | xh | bb | bs | cb | cs;
  if (batch <= 0 || batch > 65535 || S <= 0 || H <= 0 || !chunk_ok(chunk) ||
      S % chunk != 0 || (addr & 15) || (strides & 7) ||
      (long long)(S / chunk) * H > 0x7fffffffLL) {
    err[0] = static_cast<int>(cudaErrorInvalidValue);
    return err[0];
  }
  const BfArgs a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(A), static_cast<const bf16*>(B),
                 static_cast<const bf16*>(C), static_cast<bf16*>(y),
                 static_cast<float*>(st), static_cast<float*>(dec),
                 static_cast<bf16*>(prev), static_cast<float*>(fac), xb, xs,
                 xh, db, ds, dh, bb, bs,
                 cb, cs, batch, S, H, chunk, S / chunk};
  if (!launch_bf16_hd(HD, DS, a, static_cast<cudaStream_t>(stream), err))
    err[0] = static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 3; ++k)
    if (err[k]) return err[k];
  return 0;
}
