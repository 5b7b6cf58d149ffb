// Blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel (pl.pallas_call in
// flash_attention, file line 139).  For q (B, Sq, H, D), k and v
// (B, Sk, Hkv, D), H % Hkv == 0:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, h / (H / Hkv)] / sqrt(D))
//                * v[b, j, h / (H / Hkv)]
// over the columns j < Sk that the masks leave: causal (i >= j) and, for
// window > 0, i - j < window.  The running (acc, m, l) are float32; the
// output has the input's type.  When the caller passes an lse buffer (a
// call whose output autograd will differentiate), each row's log-sum-exp
// m + log l goes there too, for the backward in flash_attention_bwd.cu.
//
// What bounds it on this card: operations.  At the prefill shape
// (2, 4096, 12, 2, 128) in bf16 a causal call does 4*B*H*D*(S(S+1)/2)
// = 103 GFLOP against 59 MB of traffic, about 1,750 flop per byte, far
// above the ~295 flop/B where an H100's bf16 tensor cores, not HBM, set
// the pace: the least time is 103 GFLOP / 989 TFLOP/s = 104 us.
//
// Two kernels, a fixed function of the dtype at every head dim:
//  - bf16: flash_fwd_tma, after FlashAttention-3.  Tiles come in by TMA
//    (cp.async.bulk.tensor through one tensor map per q, k, v, read
//    through the caller's strides) into a ring of shared-memory stages
//    completed on mbarriers, so the next kv tiles are in flight while one
//    is computed; one thread issues the loads.  Two warpgroups of 64 q
//    rows run both products on wgmma: S = Q K^T from shared memory (both
//    K-major), O += P V with P in registers (the m64nN accumulator layout
//    is the register-A layout) and V read transposed from its (kv, d)
//    tile.  The score tile never leaves registers.  P V of one tile and
//    Q K^T of the next are issued together, and the two warpgroups take
//    turns at the tensor cores so that one's softmax overlaps the other's
//    products.  TMA's zero fill stands in for rows >= Sq and >= Sk; only
//    tiles that cross the diagonal, the window's edge or Sk are masked.
//    Causal q-tiles run heaviest first.
//  - float32: flash_fwd_f32, scalar FMAs from shared memory (a float32
//    product on the tensor cores would be TF32 and miss the float32
//    tolerance).
//
// How the TPU kernel maps here.  Its grid (B, H, q-blocks, kv-blocks)
// runs the kv axis in order with (acc, m, l) in VMEM scratch; here one
// block owns one (b, h, q-tile) and loops over the kv tiles itself, so
// nothing is carried between blocks.  A kv tile wholly above the
// diagonal or wholly older than the window is never loaded.  The layout
// is read through strides (no transposes), the kv head is h / (H / Hkv)
// (no repeated K/V), and ragged Sq and Sk are handled in the kernel (no
// padded copies): rows >= Sq are not stored, columns >= Sk are masked
// explicitly -- the TPU kernel leaves them to the causal mask, which
// does not hide them when Sq > Sk, and refuses a non-causal call whose Sk
// its kv block would pad; here a non-causal call takes any Sk (whisper's
// encoder and cross-attention: Sk = 1500), its last kv tile's rows past
// Sk zero-filled by TMA and masked, not scored as 0.  A row that sees no
// key at all (Sq > Sk + window) gets zeros from the bf16 kernel.
//
// Plain C interface, loaded with ctypes: flash_attention_launch returns
// the cudaError_t of the launch (0 on success); a shape, type or head
// size it does not take returns cudaErrorInvalidValue before launching.

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides of (B, S, H) of q, k, v, o; d is 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

struct Problem {
  int Sq, Sk, group, causal, window;
  float scale;
  // (B, H, Sq) float32: each row's log-sum-exp of its scaled scores, for
  // the backward (flash_attention_bwd.cu); null when nothing needs it
  float* lse;
};

// First and one-past-last kv tile that a q-tile [q0, q0 + bq) can see.
__device__ __forceinline__ void kv_tile_range(const Problem& p, int q0,
                                              int bq, int bk, int* lo,
                                              int* hi) {
  int kv_lo = 0, kv_hi = p.Sk;
  if (p.causal) kv_hi = min(kv_hi, min(q0 + bq, p.Sq));
  if (p.window > 0) kv_lo = max(0, q0 - p.window + 1);
  *lo = kv_lo / bk;
  *hi = kv_hi > kv_lo ? (kv_hi + bk - 1) / bk : *lo;
}

__device__ __forceinline__ bool visible(const Problem& p, int row, int col) {
  bool ok = col < p.Sk;
  if (p.causal) ok = ok && col <= row;
  if (p.window > 0) ok = ok && row - col < p.window;
  return ok;
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs.  128 threads, a 32-row q-tile, 32-column kv tiles.
// Thread t owns q row t / 4 and, of that row, score columns t % 4 + 4 jj
// and output features t % 4 + 4 dd.
// ---------------------------------------------------------------------------

constexpr int kF32Bq = 32, kF32Bk = 32, kF32Threads = 128;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kF32Bq * (D + 1) + kF32Bk * (D + 1) + kF32Bk * D +
                          kF32Bq * (kF32Bk + 1));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  Strides st, Problem p) {
  constexpr int BQ = kF32Bq, BK = kF32Bk, NT = kF32Threads;
  constexpr int DP = D + 1;    // padded rows: column reads hit 32 banks
  constexpr int PP = BK + 1;
  constexpr int DV = D / 4;    // output features per thread
  constexpr int CV = BK / 4;   // score columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int qrow = q0 + row;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;

  for (int idx = tid; idx < BQ * (D / 4); idx += NT) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < p.Sq)
      x = *reinterpret_cast<const float4*>(qb + (q0 + r) * st.qs + c);
    float* d = sQ + r * DP + c;
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }

  float acc[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  int t_lo, t_hi;
  kv_tile_range(p, q0, BQ, BK, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's sK, sV, sP are no longer read
    for (int idx = tid; idx < BK * (D / 4); idx += NT) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      float4 xk = make_float4(0.f, 0.f, 0.f, 0.f), xv = xk;
      if (k0 + r < p.Sk) {
        xk = *reinterpret_cast<const float4*>(kb + (k0 + r) * st.ks + c);
        xv = *reinterpret_cast<const float4*>(vb + (k0 + r) * st.vs + c);
      }
      float* dk = sK + r * DP + c;
      dk[0] = xk.x; dk[1] = xk.y; dk[2] = xk.z; dk[3] = xk.w;
      *reinterpret_cast<float4*>(sV + r * D + c) = xv;
    }
    __syncthreads();

    float s[CV];
#pragma unroll
    for (int jj = 0; jj < CV; ++jj) s[jj] = 0.f;
    for (int c = 0; c < D; ++c) {
      const float qc = sQ[row * DP + c];
#pragma unroll
      for (int jj = 0; jj < CV; ++jj)
        s[jj] = fmaf(qc, sK[(sub + 4 * jj) * DP + c], s[jj]);
    }
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < CV; ++jj) {
      const int col = k0 + sub + 4 * jj;
      s[jj] = visible(p, qrow, col) ? s[jj] * p.scale : kNegInf;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < CV; ++jj) {
      const float e = expf(s[jj] - m_new);
      sP[row * PP + sub + 4 * jj] = e;
      ps += e;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l = l * alpha + ps;
    m = m_new;
    __syncwarp();  // a row's probabilities come from the 4 threads of its warp
#pragma unroll
    for (int i = 0; i < DV; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float pj = sP[row * PP + j];
#pragma unroll
      for (int i = 0; i < DV; ++i)
        acc[i] = fmaf(pj, sV[j * D + sub + 4 * i], acc[i]);
    }
  }

  // m is of the scaled scores.  The row's LSE goes out first, its index
  // from the block and thread indices: computed after the output's store
  // it kept one more value live and ptxas spilled 8 bytes at D = 80.
  if (p.lse != nullptr && sub == 0 && qrow < p.Sq)
    p.lse[(blockIdx.z * gridDim.y + blockIdx.y) * p.Sq + blockIdx.x * BQ +
          (threadIdx.x >> 2)] = m + __logf(l);  // B H Sq < 2^31: checked
  if (qrow < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-20f);
    float* ob = o + b * st.ob + qrow * st.os + h * st.oh;
#pragma unroll
    for (int i = 0; i < DV; ++i) ob[sub + 4 * i] = acc[i] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma.  One block of two warpgroups (256 threads) owns
// a 128-row q-tile of one (b, h); warpgroup wg holds rows 64 wg .. 64 wg
// + 63, its warp w rows 16 w + g and 16 w + g + 8 (g = lane / 4), as the
// m64nN accumulator lays them out.  Thread 0 loads the q-tile and the
// first STAGES kv tiles with TMA (cp.async.bulk.tensor); each stage of
// the ring completes on its full mbarrier (expect_tx with the K and V
// tiles' bytes).  A stage is refilled as soon as all eight warps are done
// with it: each warp counts itself out on the stage's counter, and the
// eighth issues the load of the tile STAGES on.  No __syncthreads() sits
// in the kv loop.
//
// Tiles land in shared memory in swizzled column blocks (hopper.cuh); at
// D = 80 five 16-column blocks with the 32-byte swizzle, since
// zero-filling to 128 columns would cost 1.6x the tensor work; at D = 96
// three 32-column blocks with the 64-byte swizzle, P V an m64n96k16.
//
// Why no producer warp: with a producer warpgroup beside the two (384
// threads), ptxas (CUDA 12.9) held every thread to 168 registers with or
// without setmaxnreg, which forced 64-row kv tiles at D = 128 and was
// slower there (PERF.md); 256 threads may use 255.
// ---------------------------------------------------------------------------

template <int D>
struct Geo : Swizzle<D> {
  static constexpr int BQ = 128, BK = 128;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one of K, V
  // as many stages as fit (3 at D = 128, 4 at D = 96, 5 at D = 80), at
  // most 4; each stage has a full barrier and a counter, then the
  // q-tile's barrier, and 1024 bytes of slack align the base to the
  // 128-byte swizzle's period, which TMA and the descriptors assume
  static constexpr int STAGES_FIT =
      (kSmemMax - 1024 - 8 - Q_BYTES) / (2 * KV_BYTES + 16);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
  static_assert(STAGES >= 2 && SMEM <= kSmemMax, "tiles do not fit");
};

constexpr int kTmaThreads = 256;  // two warpgroups of 64 q rows

// Named barriers 1 and 2 over the block's 256 threads: a warpgroup waits
// for its turn (sync) and hands the turn to the other (arrive).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

struct OutArgs {  // o (B, Sq, H, D): pointer and element strides
  __nv_bfloat16* o;
  long long ob, os, oh;
};

// K and V of kv tile t into stage s, completing on its full barrier.
template <int D>
__device__ __forceinline__ void load_kv(const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t sQ,
                                        uint32_t bar, int hk, int b, int t,
                                        int s) {
  using G = Geo<D>;
  const uint32_t full = bar + 8 * s;
  const uint32_t sK = sQ + G::Q_BYTES + 2 * s * G::KV_BYTES;
  mbar_expect_tx(full, 2 * G::KV_BYTES);
  tma_tile(sK, tk, hk, t * G::BK, b, full);
  tma_tile(sK + G::KV_BYTES, tv, hk, t * G::BK, b, full);
}

template <int D>
__global__ void __launch_bounds__(kTmaThreads, 1)
    flash_fwd_tma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, OutArgs out,
                  Problem p, int H, int B, int n_qt) {
  using G = Geo<D>;
  constexpr int BQ = G::BQ, BK = G::BK, ST = G::STAGES, SW = G::SW;
  constexpr int NK = D / 16;      // k16 steps of Q K^T
  constexpr int KPB = SW / 32;    // of them in one swizzle row
  constexpr int NS = BK / 8;      // n8 tiles of the score tile
  constexpr int NO = D / 8;       // n8 tiles of the output
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + G::Q_BYTES;  // stage s: K, then V
  const uint32_t bar = sQ + G::BAR_OFF;  // full[ST], counter[ST], q
  const uint32_t qbar = bar + 16 * ST;

  // Heavy q-tiles first: the q-tile index is the slowest of the grid and,
  // for causal calls, runs from the last tile (the longest kv loop) down.
  const int bh = blockIdx.x % (B * H), it = blockIdx.x / (B * H);
  const int qt = p.causal ? n_qt - 1 - it : it;
  const int h = bh % H, b = bh / H, hk = h / p.group;
  const int q0 = qt * BQ;
  int t_lo, t_hi;
  kv_tile_range(p, q0, BQ, BK, &t_lo, &t_hi);
  const int n_t = t_hi - t_lo;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar + 8 * s, 1);
      asm volatile("st.shared.u32 [%0], 0;\n" ::"r"(bar + 8 * (ST + s))
                   : "memory");
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_t > 0) {
    mbar_expect_tx(qbar, G::Q_BYTES);
    tma_tile(sQ, &tq, h, q0, b, qbar);
    for (int i = 0; i < ST && i < n_t; ++i)
      load_kv<D>(&tk, &tv, sQ, bar, hk, b, t_lo + i, i);
  }

  const int g = lane >> 2, tg = lane & 3;
  const int wr = q0 + 16 * warp;  // the warp's first row
  const int r0 = wr + g, r1 = r0 + 8;
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x log2 e)

  // Iteration i issues Q K^T of tile i and P V of tile i - 1 together, in
  // this warpgroup's turn (the two warpgroups take turns, so one's softmax
  // runs while the other's products do), then waits for both and leaves
  // the stage of tile i - 1.
  uint32_t pa[BK / 16][4];  // P of the previous tile
  const int turn = 1 + wg, other = 2 - wg;  // named barriers 1 and 2
  if (n_t > 0) {
    mbar_wait(qbar, 0);
    if (wg == 1) named_arrive(other);  // warpgroup 0 goes first
  }
  for (int i = 0; i < n_t; ++i) {
    const int s = i % ST, sp = (i + ST - 1) % ST;
    const int k0 = (t_lo + i) * BK;
    const uint32_t sK = sKV + 2 * s * G::KV_BYTES;
    const uint32_t sVp = sKV + (2 * sp + 1) * G::KV_BYTES;
    mbar_wait(bar + 8 * s, (i / ST) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions

    // S = Q K^T: A is the warpgroup's 64 rows of the q-tile, B the kv
    // tile, both K-major (d contiguous) in NB swizzled column blocks; a
    // k16 step is 32 bytes into a swizzle row, or the next block.
    // O += P V (tile i - 1): A is P in registers, B the V tile, N-major
    // (d contiguous), read transposed: a k16 step is 16 rows on, the
    // next swizzle atom along d the next column block.
    float sc[NS * 4];
    named_sync(turn);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t koff = (kk % KPB) * 32;
      const uint64_t da = make_desc<SW>(
          sQ + (kk / KPB) * BQ * SW + 64 * wg * SW + koff, 16, 8 * SW);
      const uint64_t db =
          make_desc<SW>(sK + (kk / KPB) * BK * SW + koff, 16, 8 * SW);
      wgmma_ss<BK>(sc, da, db, kk > 0);
    }
    if (i > 0) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk],
                    make_desc<SW>(sVp + kk * 16 * SW, BK * SW, 8 * SW));
    }
    wgmma_commit();
    named_arrive(other);
    wgmma_wait_all();
    fence_regs<NS * 4>(sc);
    fence_regs<NO * 4>(acc);
    fence_regs<BK / 4>(&pa[0][0]);
    if (i > 0) {
      __syncwarp();
      if (lane == 0 && last_to_leave<8>(bar + 8 * (ST + sp)) &&
          i - 1 + ST < n_t)
        load_kv<D>(&tk, &tv, sQ, bar, hk, b, t_lo + i - 1 + ST, sp);
    }

    // a tile that every row of the warp sees whole needs no mask
    const bool whole = k0 + BK <= p.Sk &&
                       (!p.causal || k0 + BK - 1 <= wr) &&
                       (p.window <= 0 || wr + 15 - k0 < p.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = k0 + j * 8 + tg * 2;
      if (!whole) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(p, e < 2 ? r0 : r1, c + (e & 1)))
            sc[4 * j + e] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    // m is the running max of the unscaled scores; a row that has seen no
    // key yet keeps it at kNegInf and takes 0 as its reference, so its
    // masked columns weigh exp2(kNegInf scale2) = 0
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = (mn0 == kNegInf ? 0.f : mn0) * scale2;
    const float mu1 = (mn1 == kNegInf ? 0.f : mn1) * scale2;
    const float a0 = ex2(fmaf(m0, scale2, -mu0));
    const float a1 = ex2(fmaf(m1, scale2, -mu1));
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale2, -mu0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale2, -mu0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale2, -mu1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale2, -mu1));
      ps0 += sc[4 * j] + sc[4 * j + 1];
      ps1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    // l is kept per thread (its own columns) and summed over the row's
    // four threads once, at the end
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[4 * n] *= a0; acc[4 * n + 1] *= a0;
      acc[4 * n + 2] *= a1; acc[4 * n + 3] *= a1;
    }
    // P leaves the accumulator as bf16 in the register-A layout: n8 tiles
    // 2 kk and 2 kk + 1 are k16 step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  if (n_t > 0) {  // the last tile's P V
    const uint32_t sVp = sKV + (2 * ((n_t - 1) % ST) + 1) * G::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, pa[kk],
                  make_desc<SW>(sVp + kk * 16 * SW, BK * SW, 8 * SW));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NO * 4>(acc);
    fence_regs<BK / 4>(&pa[0][0]);
    if (wg == 0) named_sync(turn);  // the arrival warpgroup 1 made last
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  if (p.lse != nullptr && tg == 0) {
    // l sums exp2(s scale2 - mu) with mu the final reference of the row;
    // a row that saw no key (l = 0) gets +inf, so every P of it is 0
    const float kInf = __int_as_float(0x7f800000);
    float* lb = p.lse + (static_cast<long long>(b) * H + h) * p.Sq;
    const float mu0 = (m0 == kNegInf ? 0.f : m0) * scale2;
    const float mu1 = (m1 == kNegInf ? 0.f : m1) * scale2;
    if (r0 < p.Sq) lb[r0] = l0 > 0.f ? (mu0 + log2f(l0)) * kLn2 : kInf;
    if (r1 < p.Sq) lb[r1] = l1 > 0.f ? (mu1 + log2f(l1)) * kLn2 : kInf;
  }
  __nv_bfloat16* ob = out.o + b * out.ob + h * out.oh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * out.os + c) =
          pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * out.os + c) =
          pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, const Strides& st, const Problem& p,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kF32Bq - 1) / kF32Bq, H, B);
  flash_fwd_f32<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* o, int B, int H, const Strides& st,
                        const Problem& p, cudaStream_t stream) {
  using G = Geo<D>;
  const int Hkv = H / p.group;
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, H, p.Sq, B, st.qh, st.qs, st.qb, G::BQ) ||
      !encode_map<D>(&tk, k, Hkv, p.Sk, B, st.kh, st.ks, st.kb, G::BK) ||
      !encode_map<D>(&tv, v, Hkv, p.Sk, B, st.vh, st.vs, st.vb, G::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      G::SMEM);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.Sq + G::BQ - 1) / G::BQ;
  const long long blocks = static_cast<long long>(n_qt) * H * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const OutArgs out{static_cast<__nv_bfloat16*>(o), st.ob, st.os, st.oh};
  flash_fwd_tma<D><<<static_cast<unsigned>(blocks), kTmaThreads, G::SMEM,
                     stream>>>(tq, tk, tv, out, p, H, B, n_qt);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int H, const Strides& st,
                   const Problem& p, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, B, H, st, p, stream)
                    : launch_bf16<D>(q, k, v, o, B, H, st, p, stream);
}

template <int D>
int info_of(int dtype, int* out) {
  return dtype == 0
             ? kernel_info(flash_fwd_f32<D>, f32_smem_bytes<D>(), out)
             : kernel_info(flash_fwd_tma<D>, Geo<D>::SMEM, out);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous, and the caller has checked
// 16-byte alignment of the pointers and of the (B, S, H) strides (the
// bf16 kernel's tensor maps need exactly that).  lse, when not null, is a
// packed (B, H, Sq) float32 tensor that receives each row's log-sum-exp
// of its scaled scores over the visible columns (+inf in bf16, about
// -1e30 in float32, for a row that sees no key).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int Hkv, int D, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int window, float scale, float* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1) || H > 65535 || B > 65535 ||
      (lse != nullptr && static_cast<long long>(B) * H * Sq >= (1LL << 31)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const Problem p{Sq, Sk, H / Hkv, causal, window, scale, lse};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 32: err = launch<32>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 64: err = launch<64>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 80: err = launch<80>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 96: err = launch<96>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 128: err = launch<128>(dtype, q, k, v, o, B, H, st, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Registers per thread, shared memory per block (static + dynamic) and
// local memory per thread (spills, stack) of the kernel that a call of
// (dtype, D) launches, into info[0..2].  Returns a cudaError_t.
extern "C" int flash_attention_kernel_info(int dtype, int D, int* info) {
  switch (D) {
    case 16: return info_of<16>(dtype, info);
    case 32: return info_of<32>(dtype, info);
    case 64: return info_of<64>(dtype, info);
    case 80: return info_of<80>(dtype, info);
    case 96: return info_of<96>(dtype, info);
    case 128: return info_of<128>(dtype, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
