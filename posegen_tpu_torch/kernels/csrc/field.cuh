// Device code shared by the port's field kernels: the Layout record and its
// reader, the constants of the encode and the nets, and the shared-memory
// opt-in. The eval, stash and variant kernels (field.cu, field_eval.cuh,
// field_variants.cu) and the backward (field_grad.cu) build on it.
//
// Replaces the shared operands of the Pallas kernels in
// posegen_tpu/kernels/field.py: encode_intermediates / _kp_side (:264-374)
// and _mlp_heads (:509-563).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace posegen {

using bf16 = __nv_bfloat16;

constexpr int kJoints = 24;
constexpr int kTile = 64;         // points per block of pass (c)'s chain rule
constexpr int kThreads = 256;     // threads per block of pass (c)'s chain rule
constexpr int kWidth = 256;       // trunk width
constexpr int kViewWidth = 128;   // view-head width
constexpr int kMaxDepth = 16;
constexpr int kPoseFloats = kJoints * 13 + 1;  // rot 24x9 | trn 24x3 | cut 24 | tau
constexpr int kMaxOctaves = 64;               // then nf_kp + nf_view BARF weights
constexpr int kPoseBytes = 1536;              // the pose operand, 128-aligned

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

// Per-row bias rows (the backward's per-pose-group view bias): point p adds
// bias row p / ppg, rows ld floats apart. ld == 0: one bias row for every
// point.
struct RowBias {
  int ld = 0, ppg = 1;
};

// n_pts points in n_vgroups view-bias groups of vppg points: the last group
// holds at least one point.
static inline bool view_groups_ok(int n_pts, int n_vgroups, int vppg) {
  return n_vgroups >= 1 && vppg >= 1 && static_cast<long long>(n_vgroups) * vppg >= n_pts &&
         static_cast<long long>(n_vgroups - 1) * vppg < n_pts;
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
