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
// All arithmetic is float32 on the CUDA cores, as the TPU kernel computes
// in f32; x and B/C are read as float32 or bf16, y is written in x's type.
//
// Design (a) of the two the port allows: one block per (b, head) walks the
// chunks in order with the state (hd x ds f32: 32 KB at mamba2-1.3b's
// 64 x 128, 16 KB at zamba2-2.7b's 64 x 64) in shared memory, so one
// launch does the whole scan and the state never touches device memory.
// The TPU kernel carries that state in VMEM along a sequential grid axis;
// Hopper's blocks run in no order, so the loop over chunks lives inside
// the block instead.  The cost: at the prefill shape (2, 4096) only
// b x nh blocks exist -- 128 for mamba2 (one per SM, 4 of 132 SMs idle)
// and 160 for zamba2 (two fit on an SM there, so all are resident at
// once, but 28 SMs carry two).  The chunk-parallel split (chunk states in
// parallel, a short state-passing pass, then the outputs) would fill the
// card better at the price of three launches and the chunk states'
// round trip through device memory; it is a later PR's step.
//
// What bounds it on this card: operations.  At mamba2's prefill call
// (2, 4096, 64, 64, 128) with chunk 256 the least work is about 26 GFLOP
// (C B^T once per (b, chunk), causal halves) against about 140 MB of
// traffic: 0.39 ms at the 67 TFLOP/s of f32 on the CUDA cores, 42 us at
// 3.35 TB/s.  This kernel does more than the least work: each block owns
// one head and so recomputes the scores C B^T for its head (all heads of a
// (b, chunk) share them), and it computes whole 64 x 64 tiles on the
// diagonal -- about 49 GFLOP at that shape, 1.9x the least.  It pays that
// to keep one block per head with nothing shared between blocks.
//
// Exponent precision.  The TPU kernel takes seg(j, i] as cs_i - cs_j, the
// difference of two running sums; over a chunk of 256 those reach several
// hundred, and the difference keeps only about 1e-4 of a short segment's
// exponent.  Here every exponent is a sum of same-sign terms (dt > 0 > A),
// so nothing cancels: within a tile's diagonal each row sums its own
// segments, and below it seg(j, i] = (rest of j's tile) + (whole tiles
// between) + (start of i's tile up to i).  The plain version sums each
// segment on its own too.
//
// Shared memory, float32, at chunk 256, hd 64, ds 128: the chunk is cut
// into row tiles of 64 (T = min(chunk, 64)), so B and C are never held
// whole (128 KB each): C's row tile (64 x 129 x 4 = 33 KB), B's column
// tile (33 KB), the state (64 x 129 x 4 = 33 KB), dt x of the column tile
// (16 KB), the decayed score tile and the diagonal tile's segment sums
// (64 x 65 x 4 = 16.6 KB each) and six per-row vectors of the chunk
// (6 KB): 154,880 B, one block per SM.  At ds 64 it is 105,728 B, two
// blocks per SM.  Rows are padded by one float where a warp reads down a
// column, so those reads hit 32 banks.
//
// Order inside a chunk (the old state must serve every row of the chunk
// before it is updated): for each row tile, the off-diagonal part from the
// old state, then for each column tile up to the diagonal the scores, the
// mask-then-exp weights (masked entries are set to 0 without computing
// the exponent: above the diagonal cs_i - cs_j can be large and positive)
// and their product with dt x; on the diagonal tile the column tile's
// share of the new state is added to registers.  After the last row tile
// the state is decayed and the new share added.
//
// Simple before fast: tiles are loaded synchronously with scalar loads
// (no cp.async or TMA), products are scalar FMAs from shared memory on a
// 16 x 16 thread grid (no tensor cores, no mma), one head per block.
//
// Plain C interface, loaded with ctypes: ssd_scan_launch returns the
// cudaError_t of the launch (0 on success); a size, chunk or type it does
// not take returns cudaErrorInvalidValue before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
