// The field kernel's A/B variants for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes), like field.cu and field_grad.cu.
//
//   posegen_field_variant  replaces tools/exp_kernel_variants.py::variant_field
//                          (:269): kernel 2's encode + MLP on points grouped by
//                          pose, under the A/B harness's flags
//
// The variants are the eval kernel itself (field_eval.cuh): its grouped
// modes, kFullGroups and kDensityGroups, with one direction per point (spr
// 1) and the packed view bias for every point, on its persistent 128-point
// tile, producer warp, TMA rings and L2-resident slots. The harness's flags
// map onto its VAR template argument (kernels/variants.py):
//   base, dens_base     VAR 0: posegen_field_grouped, the main path's kernel
//   bf16enc             enc kEncBf16
//   pipe2               enc kEncBf16, split (halves = 2)
//   mxenc, dens_mxenc   enc kEncMx
//   encode_only=True    probe kProbeEncode
//   encode_only="gates" probe kProbeGates
// Only these are built; the wrapper refuses every other combination. The
// harness's skipsplit, viewsplit and bf16act choose how the TPU lays out its
// operands; this body never builds a concatenation and keeps every
// activation as bf16, so it always is their bf16 form and they select no
// code. halves = 4 would split the tile into 32-row parts, and wgmma's M is
// 64 rows: the wrapper refuses it.
//
// Bound on an H100: operations, as kernel 2. The flagship field is 1,723,648
// FLOP per point and the density-only one 1,360,384, against 40 bytes of
// input and output per point: 1.142 ms and 0.901 ms at 655,360 points at 989
// TFLOP/s. The probes do no tensor-core work and have no bound. Shared
// memory is the eval plan's (201,304 bytes) in every variant.

#include <type_traits>

#include "field_eval.cuh"

extern "C" int posegen_field_grouped(const float* pts, const float* dirs, int n_pts, int spr,
                                     const float* poses, int pose_ld, int ppg, const int* layout,
                                     int n_layout, const void* w, const float* b,
                                     const float* bview, int vb_ld, int vppg, float* out,
                                     int density_only, void* scratch, long long scratch_bytes,
                                     void* stream);

namespace posegen {

// the VAR of each built variant (field_eval.cuh)
constexpr int kVarBf16 = kEncBf16;
constexpr int kVarBf16Split = kEncBf16 | kVarSplit;
constexpr int kVarMx = kEncMx;
constexpr int kVarEncSums = kProbeEncode << 2;
constexpr int kVarGates = kProbeGates << 2;

template <int V>
using Var = std::integral_constant<int, V>;

}  // namespace posegen

extern "C" {

// (n_pts, 4) raw [r, g, b, sigma] (rgb zero when density_only), or a probe's
// per-point sum in all four columns. pts and dirs (n_pts, 3) f32, one
// direction per point; poses (n_groups, n_pose) f32, one pack_pose row per
// pose group (posegen_tpu_torch/kernels/field.py pack_poses), group g owning
// points [g * n_pts / n_groups, (g + 1) * n_pts / n_groups); w bf16 and b f32
// packed per `layout`. tile 128; enc 0 / 1 / 2 (base, bf16enc, mxenc); probe
// 0 / 1 / 2 (none, encode sums, gate sums); halves 1 or 2 (2 only with
// bf16enc), in the combinations listed above; scratch as posegen_field's.
// Returns a cudaError_t code (0 = launched).
int posegen_field_variant(const float* pts, const float* dirs, int n_pts, const float* poses,
                          int n_groups, int n_pose, const int* layout, int n_layout,
                          const void* w, const float* b, float* out, int tile, int density_only,
                          int enc, int probe, int halves, void* scratch, long long scratch_bytes,
                          void* stream) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || n_groups <= 0 ||
      n_pts % n_groups != 0 || n_pose != kPoseFloats + L.nf_kp + L.nf_view || tile != kATile ||
      enc < kEncBase || enc > kEncMx || probe < kProbeNone || probe > kProbeGates ||
      (halves != 1 && halves != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ppg = n_pts / n_groups;
  const float* bview = b + L.b_view;
  const auto s = static_cast<cudaStream_t>(stream);
  const Groups G{bview, n_pose, ppg, 0, n_pts};
  // eval_sm90_kernel<mode, var> on the variant's operands
  auto run = [&](auto mode, auto var) {
    return launch<decltype(mode)::value, decltype(var)::value>(
        pts, dirs, n_pts, 1, poses, layout, n_layout, w, b, nullptr, nullptr, out, nullptr,
        scratch, scratch_bytes, s, G);
  };
  const auto full = Var<kFullGroups>{};
  const auto dens = Var<kDensityGroups>{};
  switch ((density_only ? 32 : 0) | enc | (probe << 2) | (halves == 2 ? kVarSplit : 0)) {
    case 0:  // base: the main path's kernel
      return posegen_field_grouped(pts, dirs, n_pts, 1, poses, n_pose, ppg, layout, n_layout, w,
                                   b, bview, 0, n_pts, out, 0, scratch, scratch_bytes, stream);
    case 32:  // dens_base
      return posegen_field_grouped(pts, dirs, n_pts, 1, poses, n_pose, ppg, layout, n_layout, w,
                                   b, bview, 0, n_pts, out, 1, scratch, scratch_bytes, stream);
    case kVarBf16:
      return run(full, Var<kVarBf16>{});
    case kVarBf16Split:
      return run(full, Var<kVarBf16Split>{});
    case kVarMx:
      return run(full, Var<kVarMx>{});
    case 32 | kVarMx:
      return run(dens, Var<kVarMx>{});
    case kVarEncSums:
      return run(full, Var<kVarEncSums>{});
    case kVarGates:
      return run(full, Var<kVarGates>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
