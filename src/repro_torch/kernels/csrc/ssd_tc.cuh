// Tensor-core helpers shared by the SSD scan's bf16 paths, the forward
// (ssd_scan.cu) and the backward (ssd_scan_bwd.cu): 16-byte cp.async,
// ldmatrix, bf16 mma.sync.m16n8k16 with f32 accumulators, the bf16 hi + lo
// split of an f32 pair, a tile copy into padded shared rows, and a chunk's
// per-row decay exponents, each a sum of same-sign terms.  Both paths run
// 128-thread blocks: four warps, each owning 16 rows of a 64-row tile.
//
// Everything lives in namespace ssd_tc inside an anonymous namespace: each
// .cu is its own library, and this header is compiled into each.  A source
// takes the names it uses by using-declarations, so that its own constants
// of the same name (the f32 paths' kThreads) stay its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace ssd_tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps, each owning 16 rows of a tile
constexpr int kTile = 64;      // rows of a chunk's row and column tiles
constexpr int kPad = 8;        // bf16 elements after each shared row
constexpr int kMaxChunk = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, rows) of a tile W elements wide into shared rows of ld
// elements by 16-byte cp.async; rows [rows, padded) are zeroed (the m16 /
// k16 tile's pad).
template <int W>
__device__ __forceinline__ void tile_to_smem(bf16* dst, int ld,
                                             const bf16* src,
                                             long long row_stride, int rows,
                                             int padded) {
  constexpr int kChunks = W / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < padded * kChunks; idx += kThreads) {
    const int r = idx / kChunks, q = idx % kChunks;
    bf16* d = dst + r * ld + q * 8;
    if (r < rows)
      cp_async16(d, src + r * row_stride + q * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// v as bf16 pairs hi + lo, lo = v - hi (about 16 bits of v between them)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack2(v0 - f.x, v1 - f.y);
}

// Per-row decay exponents of one chunk, each a sum of same-sign terms
// (the sources' head notes: precision), in shared memory.
struct Decay {
  float *dt, *dA;        // [kMaxChunk] dt, dt A
  float *pre16, *suf16;  // [kMaxChunk] sum of dA over block start..i, and
                         // over i+1..block end, in i's 16-row block
  float *pre64, *suf64;  // [kMaxChunk] the same over i's 64-row tile
  float *tot16;          // [kMaxChunk / 16] 16-row block totals
  float *tot64;          // [kMaxChunk / 64] 64-row tile totals
};

constexpr int kDecayFloats = 6 * kMaxChunk + kMaxChunk / 16 + kMaxChunk / 64;

__device__ __forceinline__ Decay decay_at(float* p) {
  Decay d;
  d.dt = p;
  d.dA = p + kMaxChunk;
  d.pre16 = p + 2 * kMaxChunk;
  d.suf16 = p + 3 * kMaxChunk;
  d.pre64 = p + 4 * kMaxChunk;
  d.suf64 = p + 5 * kMaxChunk;
  d.tot16 = p + 6 * kMaxChunk;
  d.tot64 = d.tot16 + kMaxChunk / 16;
  return d;
}

// Fills the chunk's vectors.  Within a 16-row block the sums are
// warp-shuffle scans over 16 lanes (a block of a chunk of 8 is padded with
// zeros), the suffix one over dA shifted up by a row, so no sum is a
// difference.  Called by every thread of the block; ends in a barrier.
__device__ void chunk_decays(const Decay& d, const float* dt, long long dts,
                             float Ah, int Q) {
  const int tid = threadIdx.x, l16 = tid & 15;
  for (int base = 0; base < Q; base += kThreads) {
    const int i = base + tid;
    const float v = i < Q ? dt[i * dts] : 0.f;
    const float da = v * Ah;
    float pre = da, suf = __shfl_down_sync(0xffffffffu, da, 1, 16);
    if (l16 == 15) suf = 0.f;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, pre, o, 16);
      const float dn = __shfl_down_sync(0xffffffffu, suf, o, 16);
      if (l16 >= o) pre += up;
      if (l16 + o < 16) suf += dn;
    }
    if (i < Q) {
      d.dt[i] = v;
      d.dA[i] = da;
      d.pre16[i] = pre;
      d.suf16[i] = suf;
    }
    if (l16 == 15 && i - 15 < Q) d.tot16[i >> 4] = pre;
  }
  __syncthreads();
  const int nb = (Q + 15) >> 4;  // 16-row blocks in the chunk
  for (int i = tid; i < Q; i += kThreads) {
    const int u = i >> 4, u0 = (i >> 6) << 2, u1 = min(u0 + 4, nb);
    float pre = d.pre16[i], suf = d.suf16[i];
    for (int w = u0; w < u; ++w) pre += d.tot16[w];
    for (int w = u + 1; w < u1; ++w) suf += d.tot16[w];
    d.pre64[i] = pre;
    d.suf64[i] = suf;
    if ((i & (kTile - 1)) == kTile - 1 || i == Q - 1) d.tot64[i >> 6] = pre;
  }
  __syncthreads();
}

}  // namespace ssd_tc
}  // namespace
