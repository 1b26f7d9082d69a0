// Device code shared by the port's field kernels: the Layout record and its
// reader, and the WMMA body, the per-point skeleton encode and the MLP,
// written once and instantiated by the stash kernel (field_grad.cu) and the
// A/B harness's variant kernel (field_variants.cu). The eval kernels
// (field.cu) run encode_tile's arithmetic and the MLP on wgmma instead.
//
// Replaces the shared body of the Pallas kernels in
// posegen_tpu/kernels/field.py: encode_intermediates / _kp_side (:264-374)
// and _mlp_heads (:509-563).
//
// What bounds it on an H100: operations. Per point the MLP is ~0.86M
// multiply-adds per net (1.72 MFLOP), against ~40-56 bytes of input and
// output, so the work sits far above the card's ~295 FLOP/byte balance
// point; the weights (~1.7 MB of bf16 per net) stay resident in the 50 MB L2.
// What the design does about it: every product runs on the bf16 tensor
// cores (warp-level WMMA 16x16x16, f32 accumulation, as mm_t in the TPU
// kernel), the encodings and activations never leave shared memory, and a
// block of kTile points reads each weight once from L2 for all its points.
// The transcendental-heavy encode is done once per (point, joint) with one
// sin/cos pair per ladder and the double-angle recurrence.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace posegen {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kJoints = 24;
constexpr int kTile = 64;           // points per block of the stash kernel; the
                                    // shared body takes any multiple of 16 (TILE below)
constexpr int kMTiles = kTile / 16;  // 16-row MMA tiles per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWidth = 256;       // trunk width
constexpr int kViewWidth = 128;   // view-head width
constexpr int kPad = 8;           // shared-memory row padding (bf16): spreads
                                  // the 16-byte rows of an MMA load over banks
constexpr int kHLd = kWidth + kPad;
constexpr int kMaxDepth = 16;
constexpr int kPoseFloats = kJoints * 13 + 1;  // rot 24x9 | trn 24x3 | cut 24 | tau
constexpr int kMaxOctaves = 64;               // then nf_kp + nf_view BARF weights
constexpr int kPoseBytes = 1536;              // the pose operand, 128-aligned
constexpr int kScratch = 256;                 // floats per warp (one 16x16 tile)

static_assert(kTile * 4 == kThreads, "the heads give each point 4 threads");
static_assert((kPoseFloats + kMaxOctaves) * 4 <= kPoseBytes, "pose region too small");

// One packed net (posegen_tpu_torch/kernels/field.py NetLayout.as_ints):
// matrices are (out, in) row-major bf16 at element offsets w_*, biases f32
// at b_*. Trunk layer i takes x_pts (i == 0), [x_pts | h] (i == skip + 1)
// or h; the view head takes [feat | x_views padded to vcp].
struct Layout {
  int depth, skip, nf_kp, nf_view, pc, vc, vcp;
  int w_alpha, b_alpha, w_feat, b_feat, w_view, b_view, w_rgb, b_rgb;
  int w_layer[kMaxDepth], b_layer[kMaxDepth];

  // input width of trunk layer i
  __host__ __device__ int layer_in_of(int i) const {
    return i == 0 ? pc : (i - 1 == skip ? pc + kWidth : kWidth);
  }
};
constexpr int kLayoutHead = 15;  // ints before the per-layer (w, b) pairs

__host__ __device__ inline int pts_ld(const Layout& L) { return L.pc + kPad; }
__host__ __device__ inline int view_ld(const Layout& L) { return L.vcp + kPad; }

// Dynamic shared memory: pose | x_pts | x_views (if any) | h | per-warp
// scratch. Every region starts 128-byte aligned (each bf16 region is
// TILE rows of a multiple of 8 elements).
template <int TILE = kTile>
__host__ __device__ inline size_t smem_bytes(const Layout& L, bool with_view) {
  const size_t rows = pts_ld(L) + (with_view ? view_ld(L) : 0) + kHLd;
  return kPoseBytes + sizeof(bf16) * TILE * rows + sizeof(float) * kWarps * kScratch;
}

// ---------------------------------------------------------------------------
// Encode: world point -> 24 joint frames -> cutoff-gated encodings, joint-
// major (the channel order of render.raycast.encode_inputs):
//   x_pts[k*24 + j]           k = 0: v*w; k = 1+2f / 2+2f: sin / cos(2^f v)*w
//   x_pts[24(1+2nf) + 3j + a] reldir p_local[a] / max(v, 1e-12), ungated
//   x_views[k*72 + 3j + a]    k = 0: dn[a]*w; 1+2f / 2+2f: sin / cos(2^f dn[a])*w
// with v = |p_local|, w = 1 - sigmoid(tau (v - cut_j)), dn the normalised
// local ray direction; each octave's gate also carries its BARF weight
// (1 when unscheduled). Rows past the last point repeat it (never stored).
// With pose_ld > 0, `pose` is a table of pose rows pose_ld floats apart and
// point gp reads row gp / ppg (its pose group); else every point reads the
// one pose.
// ---------------------------------------------------------------------------
template <bool kView, int TILE = kTile>
__device__ void encode_tile(const float* __restrict__ pts, const float* __restrict__ dirs,
                            int n_pts, int spr, int p0, const float* pose_in,
                            const Layout& L, bf16* e_pts, bf16* e_view, int pose_ld = 0,
                            int ppg = 1) {
  const int ldp = pts_ld(L), ldv = view_ld(L);
  const int kc = kJoints * (1 + 2 * L.nf_kp);
  for (int t = threadIdx.x; t < TILE * kJoints; t += kThreads) {
    const int p = t / kJoints;
    const int j = t - p * kJoints;
    const int gp = min(p0 + p, n_pts - 1);
    const float* s_pose = pose_in + (pose_ld ? static_cast<size_t>(gp / ppg) * pose_ld : 0);
    const float tau = s_pose[kJoints * 13];
    const float* sw = s_pose + kPoseFloats;  // kp octaves, then view octaves
    const float* R = s_pose + 9 * j;
    const float* T = s_pose + kJoints * 9 + 3 * j;
    const float cut = s_pose[kJoints * 12 + j];

    const float x = pts[3 * gp], y = pts[3 * gp + 1], z = pts[3 * gp + 2];
    const float X = R[0] * x + R[1] * y + R[2] * z + T[0];
    const float Y = R[3] * x + R[4] * y + R[5] * z + T[1];
    const float Z = R[6] * x + R[7] * y + R[8] * z + T[2];
    const float v = sqrtf(X * X + Y * Y + Z * Z);
    const float w = 1.f - 1.f / (1.f + expf(-(tau * (v - cut))));
    const float inv_v = 1.f / fmaxf(v, 1e-12f);

    bf16* ep = e_pts + p * ldp;
    ep[j] = __float2bfloat16(v * w);
    float s, c;
    sincosf(v, &s, &c);
    for (int f = 0; f < L.nf_kp; ++f) {
      const float wf = w * sw[f];
      ep[(1 + 2 * f) * kJoints + j] = __float2bfloat16(s * wf);
      ep[(2 + 2 * f) * kJoints + j] = __float2bfloat16(c * wf);
      const float s2 = 2.f * s * c;
      c = 1.f - 2.f * s * s;
      s = s2;
    }
    ep[kc + 3 * j + 0] = __float2bfloat16(X * inv_v);
    ep[kc + 3 * j + 1] = __float2bfloat16(Y * inv_v);
    ep[kc + 3 * j + 2] = __float2bfloat16(Z * inv_v);

    if (kView) {
      const int ray = gp / spr;
      const float dx = dirs[3 * ray], dy = dirs[3 * ray + 1], dz = dirs[3 * ray + 2];
      const float D[3] = {R[0] * dx + R[1] * dy + R[2] * dz,
                          R[3] * dx + R[4] * dy + R[5] * dz,
                          R[6] * dx + R[7] * dy + R[8] * dz};
      const float dn_inv = rsqrtf(fmaxf(D[0] * D[0] + D[1] * D[1] + D[2] * D[2], 1e-24f));
      bf16* ev = e_view + p * ldv;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float q = D[a] * dn_inv;
        ev[3 * j + a] = __float2bfloat16(q * w);
        float sq, cq;
        sincosf(q, &sq, &cq);
        for (int f = 0; f < L.nf_view; ++f) {
          const float wf = w * sw[L.nf_kp + f];
          ev[(1 + 2 * f) * 3 * kJoints + 3 * j + a] = __float2bfloat16(sq * wf);
          ev[(2 + 2 * f) * 3 * kJoints + 3 * j + a] = __float2bfloat16(cq * wf);
          const float s2 = 2.f * sq * cq;
          cq = 1.f - 2.f * sq * sq;
          sq = s2;
        }
      }
    }
  }
  if (kView) {  // the view head reads its zero-weight pad columns too
    const int npad = L.vcp - L.vc;
    for (int t = threadIdx.x; t < TILE * npad; t += kThreads) {
      e_view[(t / npad) * ldv + L.vc + t % npad] = __float2bfloat16(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// MLP body: out[TILE, N] = act(A @ W^T + b) on the tensor cores, with the
// input in up to two segments [A1 (K1 wide) | A2 (K2 wide)] so that the skip
// concat and the view-head concat are never materialized. W is (N, K1 + K2)
// row-major in device memory (read as a column-major B operand). Each warp
// owns NT 16-column tiles of the output for all TILE / 16 row tiles; the next
// K step's weight fragments load while the current one multiplies.
// ---------------------------------------------------------------------------
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int NT, int TILE = kTile>
__device__ __forceinline__ void gemm_segment(FragC (&acc)[TILE / 16][NT], const bf16* A, int lda,
                                             int K, const bf16* __restrict__ W, int ldw,
                                             int n0) {
  if (K == 0) return;
  FragB b[NT], bn[NT];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    wmma::load_matrix_sync(b[jn], W + (size_t)(n0 + 16 * jn) * ldw, ldw);
  }
  for (int k = 0; k < K; k += 16) {
    if (k + 16 < K) {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        wmma::load_matrix_sync(bn[jn], W + (size_t)(n0 + 16 * jn) * ldw + k + 16, ldw);
      }
    }
#pragma unroll
    for (int im = 0; im < TILE / 16; ++im) {
      FragA a;
      wmma::load_matrix_sync(a, A + im * 16 * lda + k, lda);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) wmma::mma_sync(acc[im][jn], a, b[jn], acc[im][jn]);
    }
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) b[jn] = bn[jn];
  }
}

// Per-row bias rows (the training kernels' per-pose-group view bias): row r
// of the block at p0 adds bias row min(p0 + r, n_pts - 1) / ppg, rows ld
// floats apart. ld == 0: one bias row for every point.
struct RowBias {
  int ld = 0, p0 = 0, ppg = 1, n_pts = 1;
};

// acc + bias (+ ReLU) -> bf16 rows of `out` (row stride kHLd), through the
// warp's f32 scratch tile (the accumulator's register layout is opaque).
template <int NT, int TILE = kTile>
__device__ __forceinline__ void store_tile(FragC (&acc)[TILE / 16][NT],
                                           const float* __restrict__ bias, bool relu,
                                           bf16* out, int n0, float* scratch,
                                           const RowBias rb = RowBias{}) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int im = 0; im < TILE / 16; ++im) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) {
      wmma::store_matrix_sync(scratch, acc[im][jn], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int n = n0 + 16 * jn + (e & 15);
        const float* brow =
            rb.ld ? bias + static_cast<size_t>(min(rb.p0 + 16 * im + (e >> 4), rb.n_pts - 1) /
                                               rb.ppg) * rb.ld
                  : bias;
        float v = scratch[e] + brow[n];
        if (relu) v = fmaxf(v, 0.f);
        out[(16 * im + (e >> 4)) * kHLd + n] = __float2bfloat16(v);
      }
      __syncwarp();
    }
  }
}

// One dense layer of width NT * 16 * kWarps. `out` may alias an input: the
// block synchronises between the last read and the first write.
template <int NT, int TILE = kTile>
__device__ void dense(const bf16* A1, int lda1, int K1, const bf16* A2, int lda2, int K2,
                      const bf16* __restrict__ W, const float* __restrict__ bias, bool relu,
                      bf16* out, float* scratch, const RowBias rb = RowBias{}) {
  const int warp = threadIdx.x >> 5;
  const int n0 = warp * NT * 16;
  FragC acc[TILE / 16][NT];
#pragma unroll
  for (int im = 0; im < TILE / 16; ++im) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) wmma::fill_fragment(acc[im][jn], 0.f);
  }
  const int ldw = K1 + K2;
  gemm_segment<NT, TILE>(acc, A1, lda1, K1, W, ldw, n0);
  gemm_segment<NT, TILE>(acc, A2, lda2, K2, W + K1, ldw, n0);
  __syncthreads();
  store_tile<NT, TILE>(acc, bias, relu, out, n0, scratch + warp * kScratch, rb);
  __syncthreads();
}

// The depth x 256 ReLU trunk: x_pts -> h (TILE x 256 in shared memory).
template <int TILE = kTile>
__device__ inline void trunk(const Layout& L, const bf16* __restrict__ W,
                             const float* __restrict__ B, const bf16* e_pts, bf16* h,
                             float* scratch) {
  const int ldp = pts_ld(L);
  for (int i = 0; i < L.depth; ++i) {
    const bool first = i == 0;
    const bool cat = !first && i - 1 == L.skip;
    dense<2, TILE>(cat ? e_pts : nullptr, ldp, cat ? L.pc : 0,
             first ? e_pts : h, first ? ldp : kHLd, first ? L.pc : kWidth,
             W + L.w_layer[i], B + L.b_layer[i], true, h, scratch);
  }
}

// A narrow head's dot product for point threadIdx.x / TPP: its TPP threads
// (a power of two up to 32, neighbours in one warp) split the K terms and
// end with the full sum each.
template <int TPP = 4>
__device__ __forceinline__ float row_dot(const bf16* row, const bf16* __restrict__ w, int K) {
  static_assert(TPP >= 1 && TPP <= 32 && (TPP & (TPP - 1)) == 0, "TPP: a power of two <= 32");
  float s = 0.f;
  for (int k = threadIdx.x & (TPP - 1); k < K; k += TPP) {
    s += __bfloat162float(row[k]) * __bfloat162float(w[k]);
  }
#pragma unroll
  for (int m = 1; m < TPP; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The integer record -> Layout; false when it is not a layout the kernels
// take.
static inline bool read_layout(const int* v, int n, Layout* L) {
  if (v == nullptr || n < kLayoutHead) return false;
  *L = Layout{};
  L->depth = v[0];
  L->skip = v[1];
  L->nf_kp = v[2];
  L->nf_view = v[3];
  L->pc = v[4];
  L->vc = v[5];
  L->vcp = v[6];
  L->w_alpha = v[7];
  L->b_alpha = v[8];
  L->w_feat = v[9];
  L->b_feat = v[10];
  L->w_view = v[11];
  L->b_view = v[12];
  L->w_rgb = v[13];
  L->b_rgb = v[14];
  if (L->depth < 1 || L->depth > kMaxDepth || n != kLayoutHead + 2 * L->depth) return false;
  if (L->nf_kp < 0 || L->nf_view < 0 || L->nf_kp + L->nf_view > kMaxOctaves) return false;
  if (L->pc != kJoints * (1 + 2 * L->nf_kp) + 3 * kJoints) return false;
  if (L->vc != 3 * kJoints * (1 + 2 * L->nf_view) || L->vcp % 16 != 0 || L->vcp < L->vc) {
    return false;
  }
  for (int i = 0; i < L->depth; ++i) {
    L->w_layer[i] = v[kLayoutHead + 2 * i];
    L->b_layer[i] = v[kLayoutHead + 2 * i + 1];
  }
  return true;
}

// Opt a kernel in to `smem` bytes of dynamic shared memory; an error when
// the card offers less.
template <typename Kernel>
static inline cudaError_t set_smem(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace posegen
