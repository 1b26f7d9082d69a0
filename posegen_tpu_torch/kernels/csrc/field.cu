// Fused skeleton-encode + NeRF MLP field kernels for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
//   posegen_field  replaces posegen_tpu/kernels/field.py::_field_kernel
//                  (full raw, or density_only: trunk + alpha head only)
//   posegen_dual   replaces posegen_tpu/kernels/field.py::_dual_kernel
//                  (one encode, coarse trunk + alpha head and the full fine net)
//
// One template, three instantiations, on the shared encode and MLP body of
// field.cuh. A block owns kTile points: it builds their encodings in shared
// memory as bf16, runs every layer on the tensor cores with the activation
// tile kept in shared memory, and writes only the (4,) raw row per point.
// The ragged last tile is masked here; the host pads nothing.
//
// Bound on an H100 (see field.cuh): operations. The flagship field
// evaluation is 1,723,648 FLOP per point and the dual one 3,084,032, against
// 40-56 bytes of input and output per point; at 989 TFLOP/s (bf16 dense)
// that is 1.74 ns and 3.12 ns per point. This first version keeps the
// design simple (WMMA from L2-resident weights, one block of 8 warps per
// SM); wgmma, TMA-staged weights and warp specialisation come later.

#include "field.cuh"

namespace posegen {

enum Mode { kFull = 0, kDensity = 1, kDual = 2 };

// out0 / w0 / b0: the net (kFull, kDensity) or the coarse net (kDual);
// out1 / w1 / b1: the fine net of kDual.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    field_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, int n_pts,
                 int spr, const float* __restrict__ pose, const Layout L,
                 const bf16* __restrict__ w0, const float* __restrict__ b0,
                 const bf16* __restrict__ w1, const float* __restrict__ b1,
                 float* __restrict__ out0, float* __restrict__ out1) {
  constexpr bool kView = MODE != kDensity;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_pose = reinterpret_cast<float*>(smem);
  bf16* e_pts = reinterpret_cast<bf16*>(smem + kPoseBytes);
  bf16* e_view = e_pts + kTile * pts_ld(L);
  bf16* h = e_view + (kView ? kTile * view_ld(L) : 0);
  float* scratch = reinterpret_cast<float*>(h + kTile * kHLd);

  const int n_pose = kPoseFloats + L.nf_kp + L.nf_view;
  for (int i = threadIdx.x; i < n_pose; i += kThreads) s_pose[i] = pose[i];
  __syncthreads();
  const int p0 = blockIdx.x * kTile;
  encode_tile<kView>(pts, dirs, n_pts, spr, p0, s_pose, L, e_pts, e_view);
  __syncthreads();

  // heads: 4 threads per point; thread q < 3 writes rgb channel q, q == 3 sigma
  const int p = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int gp = p0 + p;
  const bool store = gp < n_pts;

  const bf16* W = w0;
  const float* B = b0;
  float* out = out0;
  if (MODE == kDual) {
    trunk(L, w0, b0, e_pts, h, scratch);
    const float a_c = row_dot(h + p * kHLd, w0 + L.w_alpha, kWidth) + b0[L.b_alpha];
    if (store) out0[4 * gp + q] = q == 3 ? a_c : 0.f;
    W = w1;
    B = b1;
    out = out1;
  }
  trunk(L, W, B, e_pts, h, scratch);
  const float alpha = row_dot(h + p * kHLd, W + L.w_alpha, kWidth) + B[L.b_alpha];
  if (MODE == kDensity) {
    if (store) out[4 * gp + q] = q == 3 ? alpha : 0.f;
    return;
  }
  // feature head (no activation), then the 128-wide view head on
  // [feat | x_views] into h[:, :128]
  dense<2>(nullptr, 0, 0, h, kHLd, kWidth, W + L.w_feat, B + L.b_feat, false, h, scratch);
  dense<1>(h, kHLd, kWidth, e_view, view_ld(L), L.vcp, W + L.w_view, B + L.b_view, true, h,
           scratch);
  float v = alpha;
  if (q < 3) {
    const bf16* row = h + p * kHLd;
    const bf16* wr = W + L.w_rgb + q * kViewWidth;
    v = B[L.b_rgb + q];
    for (int k = 0; k < kViewWidth; ++k) v += __bfloat162float(row[k]) * __bfloat162float(wr[k]);
  }
  if (store) out[4 * gp + q] = v;
}

template <int MODE>
static int launch(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                  const int* layout, int n_layout, const void* w0, const float* b0,
                  const void* w1, const float* b1, float* out0, float* out1,
                  cudaStream_t stream) {
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || spr <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(L, MODE != kDensity);
  const cudaError_t e = set_smem(field_kernel<MODE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = (n_pts + kTile - 1) / kTile;
  field_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      pts, dirs, n_pts, spr, pose, L, static_cast<const bf16*>(w0), b0,
      static_cast<const bf16*>(w1), b1, out0, out1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace posegen

extern "C" {

// raw (n_pts, 4) [r, g, b, sigma] of one net; rgb zero when density_only.
// pts (n_pts, 3), dirs (n_pts / spr, 3), pose (kPoseFloats + nf_kp + nf_view,)
// f32 (posegen_tpu_torch/kernels/field.py pack_pose); w bf16 and
// b f32 packed per `layout`. Returns a cudaError_t code (0 = launched).
int posegen_field(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                  const int* layout, int n_layout, const void* w, const float* b, float* out,
                  int density_only, void* stream) {
  using namespace posegen;
  const auto s = static_cast<cudaStream_t>(stream);
  if (density_only) {
    return launch<kDensity>(pts, dirs, n_pts, spr, pose, layout, n_layout, w, b, nullptr,
                            nullptr, out, nullptr, s);
  }
  return launch<kFull>(pts, dirs, n_pts, spr, pose, layout, n_layout, w, b, nullptr, nullptr,
                       out, nullptr, s);
}

// (raw_c with rgb zero, raw_f): the coarse net's density and the fine net's
// full raw from one encode of the same points.
int posegen_dual(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                 const int* layout, int n_layout, const void* wc, const float* bc,
                 const void* wf, const float* bf, float* out_c, float* out_f, void* stream) {
  using namespace posegen;
  return launch<kDual>(pts, dirs, n_pts, spr, pose, layout, n_layout, wc, bc, wf, bf, out_c,
                       out_f, static_cast<cudaStream_t>(stream));
}

const char* posegen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
