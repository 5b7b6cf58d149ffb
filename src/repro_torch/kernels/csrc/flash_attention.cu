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
// output has the input's type.
//
// What bounds it on this card: operations.  At the prefill shape
// (2, 4096, 12, 2, 128) in bf16 a causal call does 4*B*H*D*(S(S+1)/2)
// = 103 GFLOP against 59 MB of traffic, about 1,750 flop per byte, far
// above the ~295 flop/B where an H100's bf16 tensor cores, not HBM, set
// the pace: the least time is 103 GFLOP / 989 TFLOP/s = 104 us.  So the
// bf16 path runs its two products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate) and keeps the score tile in
// registers, never in memory; K and V tiles are read once per q-tile into
// shared memory.  Simple before fast: the tiles are loaded synchronously
// (no cp.async/TMA pipeline), V's fragments are read element by element
// (no ldmatrix), and the tensor cores are driven by mma.sync, not wgmma.
// The float32 path is scalar FMAs from shared memory (a float32 product
// on the tensor cores would be TF32 and miss the float32 tolerance).
//
// How the TPU kernel maps here.  Its grid (B, H, q-blocks, kv-blocks)
// runs the kv axis in order with (acc, m, l) in VMEM scratch; here one
// block owns one (b, h, q-tile) and loops over the kv tiles itself, so
// nothing is carried between blocks.  A kv tile wholly above the
// diagonal or wholly older than the window is never loaded.  The layout
// is read through strides (no transposes), the kv head is h / (H / Hkv)
// (no repeated K/V), and ragged Sq and Sk are masked in the kernel (no
// padded copies): rows >= Sq are not stored, columns >= Sk are masked
// explicitly -- the TPU kernel leaves them to the causal mask, which
// does not hide them when Sq > Sk.
//
// Plain C interface, loaded with ctypes: flash_attention_launch returns
// the cudaError_t of the launch (0 on success); a shape, type or head
// size it does not take returns cudaErrorInvalidValue before launching.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // element strides of (B, S, H) of q, k, v, o; d is 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

struct Problem {
  int Sq, Sk, group, causal, window;
  float scale;
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

  if (qrow < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-20f);
    float* ob = o + b * st.ob + qrow * st.os + h * st.oh;
#pragma unroll
    for (int i = 0; i < DV; ++i) ob[sub + 4 * i] = acc[i] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// 128 threads = 4 warps, a 64-row q-tile (16 rows per warp), 64-column kv
// tiles.  Q's fragments stay in registers for the whole kv loop; the
// score tile S = Q K^T lives in the accumulator registers and is reused,
// rounded to bf16, as the A operand of P V (the accumulator layout of
// m16n8 tiles j and j+1 is the A layout of one k16 step).
// ---------------------------------------------------------------------------

constexpr int kBfBq = 64, kBfBk = 64, kBfThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int D>
__global__ void __launch_bounds__(kBfThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, Strides st, Problem p) {
  constexpr int BQ = kBfBq, BK = kBfBk, NT = kBfThreads;
  constexpr int KS = D + 8;    // padded rows: fragment reads hit 32 banks
  constexpr int NK = D / 16;   // k16 steps of Q K^T
  constexpr int NS = BK / 8;   // n8 tiles of the score tile
  constexpr int NO = D / 8;    // n8 tiles of the output
  constexpr int VEC = 8;       // bf16 per 16-byte load
  __shared__ __align__(16) __nv_bfloat16 sK[BK * KS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * KS];

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = kk * 16 + tg * 2;
    const uint32_t* q0p = reinterpret_cast<const uint32_t*>(qb + r0 * st.qs);
    const uint32_t* q1p = reinterpret_cast<const uint32_t*>(qb + r1 * st.qs);
    qf[kk][0] = r0 < p.Sq ? q0p[c / 2] : 0u;
    qf[kk][1] = r1 < p.Sq ? q1p[c / 2] : 0u;
    qf[kk][2] = r0 < p.Sq ? q0p[c / 2 + 4] : 0u;
    qf[kk][3] = r1 < p.Sq ? q1p[c / 2 + 4] : 0u;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale2 = p.scale * kLog2e;  // exp(x) = exp2(x log2 e)

  int t_lo, t_hi;
  kv_tile_range(p, q0, BQ, BK, &t_lo, &t_hi);
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * (D / VEC); idx += NT) {
      const int r = idx / (D / VEC), c = (idx % (D / VEC)) * VEC;
      uint4 xk = make_uint4(0u, 0u, 0u, 0u), xv = xk;
      if (k0 + r < p.Sk) {
        xk = *reinterpret_cast<const uint4*>(kb + (k0 + r) * st.ks + c);
        xv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * st.vs + c);
      }
      *reinterpret_cast<uint4*>(sK + r * KS + c) = xk;
      *reinterpret_cast<uint4*>(sV + r * KS + c) = xv;
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const uint32_t* kr =
          reinterpret_cast<const uint32_t*>(sK + (j * 8 + g) * KS);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        mma_bf16(s[j], qf[kk], kr[kk * 8 + tg], kr[kk * 8 + 4 + tg]);
    }

    // a tile that every row of the block sees whole needs no mask
    const bool whole = k0 + BK <= p.Sk &&
                       (!p.causal || k0 + BK - 1 <= q0) &&
                       (p.window <= 0 || q0 + BQ - 1 - k0 < p.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int c = k0 + j * 8 + tg * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1, col = c + (e & 1);
        s[j][e] = (whole || visible(p, row, col)) ? s[j][e] * scale2
                                                  : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    // l is kept per thread (its own columns) and summed over the row's
    // four threads once, at the end
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= a0; acc[n][1] *= a0;
      acc[n][2] *= a1; acc[n][3] *= a1;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = sV + (kk * 16 + tg * 2) * KS;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int c = n * 8 + g;
        const uint32_t b0 = pack_raw(v0[c], v0[KS + c]);
        const uint32_t b1 = pack_raw(v0[8 * KS + c], v0[9 * KS + c]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  __nv_bfloat16* ob = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tg * 2;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * st.os + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * st.os + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
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
  const dim3 grid((p.Sq + kBfBq - 1) / kBfBq, H, B);
  flash_fwd_bf16<D><<<grid, kBfThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      st, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int H, const Strides& st,
                   const Problem& p, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, B, H, st, p, stream)
                    : launch_bf16<D>(q, k, v, o, B, H, st, p, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; the last
// dimension of every tensor is contiguous, and the caller has checked
// 16-byte alignment of the pointers and of the (B, S, H) strides.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Sq, int Sk, int H, int Hkv, int D, long long qb, long long qs,
    long long qh, long long kb, long long ks, long long kh, long long vb,
    long long vs, long long vh, long long ob, long long os, long long oh,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      (dtype != 0 && dtype != 1) || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh};
  const Problem p{Sq, Sk, H / Hkv, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 32: err = launch<32>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 64: err = launch<64>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 80: err = launch<80>(dtype, q, k, v, o, B, H, st, p, s); break;
    case 128: err = launch<128>(dtype, q, k, v, o, B, H, st, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
