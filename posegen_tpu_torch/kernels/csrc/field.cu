// Fused skeleton-encode + NeRF MLP kernels for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
//   posegen_field            replaces posegen_tpu/kernels/field.py::_field_kernel
//                            (full raw, or density_only: trunk + alpha head only)
//   posegen_field_grouped    the same on grouped poses (_field_kernel under
//                            grouped_specs, field.py:581): kFullGroups,
//                            kDensityGroups
//   posegen_field_ray_ladder the same with the per-ray view ladder (the ray_s
//                            branch of encode_channels, field.py:436):
//                            kFullLadder
//   posegen_dual             replaces posegen_tpu/kernels/field.py::_dual_kernel
//                            (one encode, coarse trunk + alpha head and the full
//                            fine net)
//   posegen_field_stash      replaces posegen_tpu/kernels/field_grad.py::
//                            _field_fwd_stash_kernel (the full net on grouped
//                            poses, its bf16 encodings written out for the
//                            backward, csrc/field_grad.cu)
//
// Bound on an H100: operations. The flagship field evaluation is 1,723,648
// FLOP per point and the dual one 3,084,032, against 40-56 bytes of input and
// output per point (the stash adds 2,160 bytes of encodings written); at 989
// TFLOP/s (bf16 dense) that is 1.74 ns and 3.12 ns per point (the stash's
// bytes 0.64 ns at 3.35 TB/s).
//
// One template (eval_sm90_kernel, field_eval.cuh), seven instantiations here
// (the Mode enum; field_variants.cu adds the A/B harness's), on the 128-point
// tile of sm90_tile.cuh (kernel 4's pass (a) design): a persistent grid of
// min(tiles, slots) blocks, each of two consumer warpgroups and one producer
// warp, walks the tiles blockIdx.x, + gridDim.x, ... For each tile:
//   1. The consumers encode the tile's points on the CUDA cores (encode_slot,
//      whose comment gives the channels) into the block's slot of a device
//      scratch buffer: 128 rows of e_pts (pc) and of e_view (vc) bf16, the
//      stash layout, in 8-byte vectors. The slot passes to the async proxy:
//      each writer fences (fence.proxy.async.global), each warpgroup syncs
//      and one of its threads arrives on the slot's mbarrier, which the
//      producer waits on before its first TMA load of the tile's encodings.
//      A warpgroup rewrites its slot rows only after it has waited for every
//      encoding chunk of the previous tile, so every TMA read of them is done.
//   2. Each net runs on wgmma: the producer streams every product's weights
//      (64-wide K chunks, a 256 x 64 slab a chunk) through a 3-stage TMA ring
//      and the slot's 64-column encoding chunks (layer 0 and the skip consumer
//      of each trunk, the view layer's e_view) through a 2-stage ring; TMA
//      zero-fills the columns past pc and vc. The consumers multiply
//      (m64n256k16; m64n128k16 for the view layer) with the activation tile as
//      the next layer's A operand, and take the alpha and rgb heads from their
//      accumulator registers (a butterfly over the 4 lanes of each row), so
//      only each point's (4,) raw row leaves the block. The dual runs the
//      coarse net's trunk and alpha head, then the fine net, both on the
//      slot's one encode.
// The rings' mbarrier phases carry from tile to tile. The slots (276,480
// bytes each at the flagship, 36.5 MB for 132) stay in the 50 MB L2, and each
// point is encoded once per launch, as on the TPU. Shared memory is the same
// at every depth and multires (eval_smem_bytes). Rows of the ragged last tile
// past n_pts encode a copy of the last point and are never stored.
// kDensity runs kFull's trunk and alpha head code: its sigma is kFull's, bit
// for bit.
//
// kStash is kFull with three differences. Point p reads pose row p / ppg of
// a table (each row its rotations, translations, cutoffs, tau and octave
// weights; read per point through L1, so a tile may straddle any number of
// groups) and adds view-bias row p / vppg in the view layer. Its slots are
// the outputs: tile t encodes into rows 128 t .. of e_pts (n_pts, pc) and
// e_view (n_pts, vc), so no slot is reused and the grid is min(tiles, SMs).
// Rows past n_pts are neither encoded nor stored; TMA reads them as zeros.
// On one group its raw is kFull's, bit for bit.
//
// kFullGroups and kDensityGroups are kFull and kDensity on kStash's grouped
// operands (the pose table, the view-bias rows), encoding into the slots as
// kFull does: rows past n_pts encode a copy of the last point. On one group
// their raw is kFull's / kDensity's, bit for bit, and a launch on G groups is
// G single-pose launches' raws, bit for bit: every row of a product depends
// only on its own row of the operands.
//
// kFullLadder is kFull with the view ladder built once per ray. A ray's view
// channels are its direction in each joint frame, normalised, and their
// sin / cos octaves, scaled per point by that point's cutoff gates (and the
// BARF weights): only the gates depend on the point. A first pass
// (view_ladder_kernel) writes each ray's ungated ladder, view_ch(nf_view)
// float32 values in e_view's channel order, to a device buffer of
// (n_pts / spr) rows; the encode then reads its ray's row through L1 and
// multiplies it by the gates. Per point that leaves 12 float4 loads and the
// multiplies of each joint quad, in place of 3 rotations, a normalisation, 3
// sin / cos pairs and the double-angle recurrence of every octave. The buffer,
// not shared memory: a 128-point tile touches up to 65 rays (spr 2), 168,480
// bytes of ladders at multires_views 4, and the eval plan leaves 31,144 of
// the 232,448 bytes a block may take; the buffer (21.2 MB at 8192 rays) stays
// in the 50 MB L2 between the two passes at the render's chunk sizes, and
// every spr takes the same code. Both passes compute the ladder in the same
// inline functions (local_dir, double_angle) and keep it in float32 up to the
// per-point multiply, so the raw is the per-point mode's, bit for bit.

#include "field_eval.cuh"

namespace posegen {

// kFullLadder's first pass: each ray's view ladder, once per ray, into vlad
// (n_rays rows of view_ch(nf_view) floats) in e_view's channel order,
// ungated and without the BARF weights: [dn (24 joints x 3) | per octave f:
// sin, cos of 2^f dn (24 x 3 each)]. One thread per (ray, joint).
__global__ void __launch_bounds__(256)
    view_ladder_kernel(const float* __restrict__ dirs, int n_rays,
                       const float* __restrict__ pose, int nf_view, int vc,
                       float* __restrict__ vlad) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_rays) * kJoints) return;
  const int ray = static_cast<int>(i / kJoints), j = static_cast<int>(i % kJoints);
  float dn[3], s[3], c[3];
  local_dir(pose + 9 * j, __ldg(dirs + 3 * ray), __ldg(dirs + 3 * ray + 1),
            __ldg(dirs + 3 * ray + 2), dn);
  float* out = vlad + static_cast<size_t>(ray) * vc + 3 * j;
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    out[b] = dn[b];
    sincosf(dn[b], &s[b], &c[b]);
  }
  for (int f = 0; f < nf_view; ++f) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      out[(1 + 2 * f) * 3 * kJoints + b] = s[b];
      out[(2 + 2 * f) * 3 * kJoints + b] = c[b];
      double_angle(s[b], c[b]);
    }
  }
}

}  // namespace posegen

extern "C" {

// raw (n_pts, 4) [r, g, b, sigma] of one net; rgb zero when density_only.
// pts (n_pts, 3), dirs (n_pts / spr, 3), pose (kPoseFloats + nf_kp + nf_view,)
// f32 (posegen_tpu_torch/kernels/field.py pack_pose); w bf16 and
// b f32 packed per `layout`; scratch: scratch_bytes of device memory for the
// encode, one slot (posegen_field_eval_slot_bytes) per block of the grid.
// Returns a cudaError_t code (0 = launched).
int posegen_field(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                  const int* layout, int n_layout, const void* w, const float* b, float* out,
                  int density_only, void* scratch, long long scratch_bytes, void* stream) {
  using namespace posegen;
  const auto s = static_cast<cudaStream_t>(stream);
  if (density_only) {
    return launch<kDensity>(pts, dirs, n_pts, spr, pose, layout, n_layout, w, b, nullptr,
                            nullptr, out, nullptr, scratch, scratch_bytes, s);
  }
  return launch<kFull>(pts, dirs, n_pts, spr, pose, layout, n_layout, w, b, nullptr, nullptr,
                       out, nullptr, scratch, scratch_bytes, s);
}

// posegen_field on grouped poses: point p reads pose row p / ppg of `poses`
// (rows pose_ld floats apart, each as field.py pack_pose) and view-bias row
// p / vppg of bview (rows vb_ld floats apart; vb_ld == 0: one row for every
// point); b's view bias slot is not read. The rest as posegen_field.
int posegen_field_grouped(const float* pts, const float* dirs, int n_pts, int spr,
                          const float* poses, int pose_ld, int ppg, const int* layout,
                          int n_layout, const void* w, const float* b, const float* bview,
                          int vb_ld, int vppg, float* out, int density_only, void* scratch,
                          long long scratch_bytes, void* stream) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || ppg <= 0 || vppg <= 0 || poses == nullptr ||
      bview == nullptr || pose_ld < kPoseFloats + L.nf_kp + L.nf_view ||
      (vb_ld != 0 && vb_ld < kViewWidth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const Groups G{bview, pose_ld, ppg, vb_ld, vppg};
  if (density_only) {
    return launch<kDensityGroups>(pts, dirs, n_pts, spr, poses, layout, n_layout, w, b, nullptr,
                                  nullptr, out, nullptr, scratch, scratch_bytes, s, G);
  }
  return launch<kFullGroups>(pts, dirs, n_pts, spr, poses, layout, n_layout, w, b, nullptr,
                             nullptr, out, nullptr, scratch, scratch_bytes, s, G);
}

// posegen_field (full raw) with the per-ray view ladder: view_ladder_kernel
// writes each ray's ladder to vlad (vlad_bytes of device memory, at least
// n_pts / spr rows of view_ch(nf_view) floats), then the eval kernel's
// kFullLadder mode reads it. n_pts must be a multiple of spr.
int posegen_field_ray_ladder(const float* pts, const float* dirs, int n_pts, int spr,
                             const float* pose, const int* layout, int n_layout, const void* w,
                             const float* b, float* out, float* vlad, long long vlad_bytes,
                             void* scratch, long long scratch_bytes, void* stream) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || spr <= 0 || n_pts % spr != 0 ||
      vlad == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_rays = n_pts / spr;
  if (vlad_bytes < n_rays * L.vc * static_cast<long long>(sizeof(float))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const long long n_threads = n_rays * kJoints;
  view_ladder_kernel<<<static_cast<unsigned>((n_threads + 255) / 256), 256, 0, s>>>(
      dirs, static_cast<int>(n_rays), pose, L.nf_view, L.vc, vlad);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch<kFullLadder>(pts, dirs, n_pts, spr, pose, layout, n_layout, w, b, nullptr,
                             nullptr, out, nullptr, scratch, scratch_bytes, s, Groups{}, vlad);
}

// (raw_c with rgb zero, raw_f): the coarse net's density and the fine net's
// full raw from one encode of the same points.
int posegen_dual(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                 const int* layout, int n_layout, const void* wc, const float* bc,
                 const void* wf, const float* bf, float* out_c, float* out_f, void* scratch,
                 long long scratch_bytes, void* stream) {
  using namespace posegen;
  return launch<kDual>(pts, dirs, n_pts, spr, pose, layout, n_layout, wc, bc, wf, bf, out_c,
                       out_f, scratch, scratch_bytes, static_cast<cudaStream_t>(stream));
}

// Bytes of dynamic shared memory the eval kernels take for this layout (0:
// invalid layout): the same for every layout.
long long posegen_field_eval_smem(const int* layout, int n_layout) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L)) return 0;
  return static_cast<long long>(eval_smem_bytes());
}

// raw (n_pts, 4) f32 and the stashes e_pts (n_pts, pc), e_view (n_pts, vc)
// bf16 of one net on grouped poses: point p reads pose row p / ppg of
// `poses` (rows pose_ld floats apart, each as field.py pack_pose) and view
// bias row p / vppg of bview (n_vgroups rows of 128; its single row when
// n_vgroups == 1). w bf16 and b f32 packed per `layout` (b's view bias slot
// is not read). Returns a cudaError_t code (0 = launched).
int posegen_field_stash(const float* pts, const float* dirs, int n_pts, int spr,
                        const float* poses, int pose_ld, int ppg, const int* layout, int n_layout,
                        const void* w, const float* b, const float* bview, int n_vgroups,
                        int vppg, float* out, void* e_pts, void* e_view, void* stream) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || spr <= 0 || ppg <= 0 ||
      pose_ld < kPoseFloats + L.nf_kp + L.nf_view || !view_groups_ok(n_pts, n_vgroups, vppg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the maps cover the stashes (n_pts rows); one block per SM at most
  const auto* W = static_cast<const bf16*>(w);
  auto* ep = static_cast<bf16*>(e_pts);
  auto* ev = static_cast<bf16*>(e_view);
  EvalMaps M{};
  if (!net_maps(L, W, &M.net[0]) || !sm90::make_map(&M.ep, ep, L.pc, n_pts, L.pc, kATile) ||
      !sm90::make_map(&M.ev, ev, L.vc, n_pts, L.vc, kATile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = eval_smem_bytes();
  cudaError_t e = set_smem(eval_sm90_kernel<kStash>, smem);
  int dev = 0, n_sm = 0;
  if (e != cudaSuccess || (e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const Groups G{bview, pose_ld, ppg, n_vgroups > 1 ? kViewWidth : 0, vppg};
  eval_sm90_kernel<kStash><<<eval_grid(n_pts, n_sm), kAThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      M, pts, dirs, n_pts, spr, poses, L, W, b, nullptr, nullptr, ep, ev, out, nullptr, nullptr,
      G);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of dynamic shared memory the stash kernel takes for this layout (0:
// invalid layout): the eval kernels' plan, which it shares.
long long posegen_field_stash_smem(const int* layout, int n_layout) {
  return posegen_field_eval_smem(layout, n_layout);
}

// Bytes of one slot of the eval kernels' scratch for this layout (0: invalid).
long long posegen_field_eval_slot_bytes(const int* layout, int n_layout) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L)) return 0;
  return static_cast<long long>(eval_slot_bytes(L));
}

// Blocks of the eval kernels' persistent grid on n_pts points with n_slots
// slots; block b takes tiles b, b + grid, ... of 128 points (0: invalid).
int posegen_field_eval_grid(int n_pts, int n_slots) {
  if (n_pts <= 0 || n_slots <= 0) return 0;
  return posegen::eval_grid(n_pts, n_slots);
}

const char* posegen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
