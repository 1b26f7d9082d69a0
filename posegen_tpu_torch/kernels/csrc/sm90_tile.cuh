// The 128-point activation tile of the port's wgmma kernels (sm_90a), shared
// by kernel 4's pass (a) (field_grad.cu) and the eval kernels (field.cu): a
// block of kATile points runs two consumer warpgroups of 64 points each and
// one producer warp; the producer streams each product's weights in 64-wide
// K chunks through a TMA ring (a 256 x 64 slab per chunk: four 64 x 64
// boxes) and the points' encodings through a ring of their own; the
// consumers run wgmma with A from the activation tile (128 x 256 bf16 in
// four 64-column blocks, 128-byte swizzled) or the encoding slab, and B from
// the weight slab. A warpgroup reads and overwrites only its own 64 rows of
// the tile, after its wgmma wait and a warpgroup barrier.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace posegen {

constexpr int kATile = 128;
constexpr int kAThreads = 384;  // warpgroups 0 and 1 consume; warp 8 of warpgroup 2 produces
constexpr int kEStages = 2;     // stages of the encoding ring
constexpr uint32_t kBlockBytes = kATile * 128;           // one 64-column block of the tile
constexpr uint32_t kHalfBlock = kBlockBytes / 2;         // a warpgroup's 64 rows of it
constexpr uint32_t kSlabW = 4 * sm90::kBoxBytes;         // 256 x 64 weights
constexpr uint32_t kSlabE = kBlockBytes;                 // 128 points x 64 encodings
constexpr uint32_t kRingW = 4 * kBlockBytes;             // offset of the weight ring
constexpr size_t kSmemLimit = 232448;                    // an H100 block's shared memory

// The two rings: ws weight stages and kEStages encoding stages, each with a
// full and an empty mbarrier; `it` and `ie` count their chunks. e1: a ring
// whose encoding stages fill in two 64-row halves (the eval kernel's split
// variant) keeps warpgroup 1's full barriers there, and its slot barrier
// after them.
struct Ring {
  uint32_t w, e, bars;  // shared addresses: weight slabs, encoding slabs, barriers
  int ws;
  uint32_t e1 = 0;
  __device__ uint32_t wslab(int s) const { return w + s * kSlabW; }
  __device__ uint32_t eslab(int s) const { return e + s * kSlabE; }
  __device__ uint32_t wfull(int s) const { return bars + 8 * s; }
  __device__ uint32_t wempty(int s) const { return bars + 8 * (ws + s); }
  __device__ uint32_t efull(int s) const { return bars + 8 * (2 * ws + s); }
  __device__ uint32_t eempty(int s) const { return bars + 8 * (2 * ws + kEStages + s); }
};

// acc (+)= the next nk chunks of the ring: A from the encoding slab (enc) or
// from tile blocks at a0, a0 + 1 block, ...; B the chunk's weights, K-major
// or (TB) MN-major. zero: the first chunk overwrites acc. SPLIT: warpgroup
// 1 waits for its half of an encoding stage on R.e1's barriers.
template <int N, int TB, bool SPLIT = false>
__device__ __forceinline__ void consume(float (&acc)[128], int nk, bool enc, uint32_t a0,
                                        bool zero, int& it, int& ie, const Ring& R, int wg) {
  for (int c = 0; c < nk; ++c) {
    const int s = it % R.ws, se = ie % kEStages;
    sm90::mbar_wait(R.wfull(s), (it / R.ws) & 1);
    if (enc) sm90::mbar_wait(SPLIT && wg ? R.e1 + 8 * se : R.efull(se), (ie / kEStages) & 1);
    const uint32_t a = (enc ? R.eslab(se) : a0 + c * kBlockBytes) + wg * kHalfBlock;
    sm90::fence_acc<N / 2>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sm90::desc_k(a, kk);
      const uint64_t db = TB ? sm90::desc_mn(R.wslab(s), kk) : sm90::desc_k(R.wslab(s), kk);
      const int sd = zero && c == 0 && kk == 0 ? 0 : 1;
      if constexpr (N == 256) {
        sm90::wgmma_m64n256k16<0, TB>(acc, da, db, sd);
      } else {
        sm90::wgmma_m64n128k16<0, TB>(acc, da, db, sd);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_acc<N / 2>(acc);
    if ((threadIdx.x & 127) == 0) {
      sm90::mbar_arrive(R.wempty(s));
      if (enc) sm90::mbar_arrive(R.eempty(se));
    }
    ++it;
    ie += enc;
  }
}

// A consumer thread's place: d[4 j + e] is at tile row r0 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + e % 2.
struct Frag {
  int wg, t, lane, r0;
  __device__ Frag()
      : wg(threadIdx.x >> 7), t(threadIdx.x & 127), lane(threadIdx.x & 31),
        r0(64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2)) {}
  __device__ int col(int j, int e) const { return 8 * j + 2 * (lane & 3) + (e & 1); }
  __device__ int row(int e) const { return r0 + 8 * (e >> 1); }
};

// The bits of a bf16 pair, the first value in the low half.
__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__low2bfloat16(v))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__high2bfloat16(v))) << 16);
}

// v[0 .. N / 2) as bf16 into the tile's swizzled blocks from blk0 (this
// thread's rows and columns). For values past a ReLU, m collects the mask
// bf16(v) > 0 from the bf16 bits (bit i of word i / 32 for v[i]).
template <int N>
__device__ __forceinline__ void put_tile(const float (&v)[128], unsigned char* tile, int blk0,
                                         const Frag& f, uint32_t (&m)[4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      unsigned char* p = tile + (blk0 + j / 8) * kBlockBytes + (f.r0 + 8 * h) * 128 +
                         (((j & 7) ^ (f.lane >> 2)) << 4) + 4 * (f.lane & 3);
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[i], v[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(p) = b2;
      const uint32_t bits = bf162_bits(b2);
      m[i >> 5] |= (static_cast<uint32_t>((bits & 0x7fffu) != 0u) << (i & 31)) |
                   (static_cast<uint32_t>((bits & 0x7fff0000u) != 0u) << ((i + 1) & 31));
    }
  }
}

// Before a warpgroup overwrites its tile rows: its TMA stores have read them.
__device__ __forceinline__ void tile_ready(const Frag& f) {
  if (f.t == 0) sm90::tma_store_wait_read();
  sm90::bar_sync(1 + f.wg, 128);
}

// After it wrote them: visible to the async proxy (TMA, wgmma).
__device__ __forceinline__ void tile_publish(const Frag& f) {
  sm90::fence_async_shared();
  sm90::bar_sync(1 + f.wg, 128);
}

}  // namespace posegen
