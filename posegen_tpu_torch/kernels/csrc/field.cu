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
// One template, seven instantiations (the Mode enum), on the 128-point tile
// of sm90_tile.cuh (kernel 4's pass (a) design): a persistent grid of
// min(tiles, slots) blocks, each of two consumer warpgroups and one producer
// warp, walks the tiles blockIdx.x, + gridDim.x, ... For each tile:
//   1. The consumers encode the tile's points on the CUDA cores (encode_slot:
//      field.cuh's encode_tile arithmetic) into the block's slot of a device
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

#include <limits.h>

#include "field.cuh"
#include "sm90.cuh"
#include "sm90_tile.cuh"

namespace posegen {

enum Mode {
  kFull = 0,
  kDensity = 1,
  kDual = 2,
  kStash = 3,
  kFullGroups = 4,
  kDensityGroups = 5,
  kFullLadder = 6
};

// Whether the mode encodes the view channels (some net runs the view layer).
__host__ __device__ constexpr bool has_view(int mode) {
  return mode != kDensity && mode != kDensityGroups;
}

// Whether the mode reads a pose table and view-bias rows per point (Groups).
__host__ __device__ constexpr bool grouped(int mode) {
  return mode == kStash || mode == kFullGroups || mode == kDensityGroups;
}

// Whether net k of the mode runs the feature and view layers and rgb head.
__host__ __device__ constexpr bool full_net(int mode, int k) {
  return mode == kFull || mode == kStash || mode == kFullGroups || mode == kFullLadder ||
         (mode == kDual && k == 1);
}

// The grouped modes' operands: point p reads pose row p / ppg (rows pose_ld
// floats apart) and view-bias row p / vppg of bview (rows vb_ld floats
// apart; vb_ld == 0: one row for every point).
struct Groups {
  const float* bview;
  int pose_ld, ppg, vb_ld, vppg;
};

// Shared memory (bytes, from a 1,024-aligned base): the tile 65,536 | weight
// ring 3 x 32,768 | encoding ring 2 x 16,384 | pose operand 1,536 | head
// weights 2,048 (w_alpha of each net, then the full net's w_rgb) | 11
// mbarriers (the rings', the slot's): 201,304 with the alignment slack.
constexpr int kWStages = 3;
constexpr uint32_t kRingE = kRingW + kWStages * kSlabW;
constexpr uint32_t kEvalPose = kRingE + kEStages * kSlabE;
constexpr uint32_t kEvalHeads = kEvalPose + kPoseBytes;
constexpr uint32_t kHeadBytes = 2048;
constexpr uint32_t kEvalBars = kEvalHeads + kHeadBytes;
constexpr int kEvalBarCount = 2 * (kWStages + kEStages) + 1;

__host__ __device__ inline size_t eval_smem_bytes() {
  return 1024 + kEvalBars + kEvalBarCount * sizeof(uint64_t);
}

// One block's slot of the scratch: 128 rows of e_pts and of e_view, bf16.
__host__ __device__ inline size_t eval_slot_bytes(const Layout& L) {
  return sizeof(bf16) * kATile * static_cast<size_t>(L.pc + L.vc);
}

// Blocks of the persistent grid: one per tile, at most one per slot.
__host__ __device__ inline int eval_grid(int n_pts, int n_slots) {
  const int tiles = (n_pts + kATile - 1) / kATile;
  return tiles < n_slots ? tiles : n_slots;
}

// One net's weights in boxes of 64 rows x 64 columns: every 256-column
// matrix at a multiple of 256 elements (the trunk layers but the skip
// consumer, the feature layer) as rows of one map over the packed buffer
// (matrix at offset o from row o / 256); layer 0, the skip consumer's e_pts
// and h columns, and the view layer's feature and e_view columns each as a
// map of its own.
struct NetMaps {
  CUtensorMap w256, w0, wk_e, wk_h, wv_f, wv_e;
};

struct EvalMaps {
  NetMaps net[2];      // the net, or kDual's coarse and fine nets
  CUtensorMap ep, ev;  // the slots' e_pts and e_view rows, in boxes of 128 x 64
};

// The producer: every chunk of the block's tiles, in the consumers' order. A
// tile's first encoding chunk waits for its slot (phase n & 1 of slot_bar
// for the block's n-th tile).
template <int MODE>
__device__ void eval_produce(const EvalMaps& M, const Layout& L, int n_tiles, const Ring& R,
                             uint32_t slot_bar) {
  const int nk_p = (L.pc + 63) / 64, nk_v = (L.vc + 63) / 64;
  int row0 = blockIdx.x * kATile;  // the block's slot (kStash: the tile's rows)
  int it = 0, ie = 0, n = 0;
  bool ready = false;
  auto issue = [&](const CUtensorMap* wm, int nbox, int kc, int wrow, const CUtensorMap* em) {
    const int s = it % R.ws;
    sm90::mbar_wait(R.wempty(s), ((it / R.ws) & 1) ^ 1);
    sm90::mbar_expect_tx(R.wfull(s), nbox * sm90::kBoxBytes);
    for (int b = 0; b < nbox; ++b) {
      sm90::tma_load_2d(R.wslab(s) + b * sm90::kBoxBytes, wm, R.wfull(s), 64 * kc,
                        wrow + 64 * b);
    }
    ++it;
    if (em != nullptr) {
      if (!ready) {
        sm90::mbar_wait(slot_bar, n & 1);
        ready = true;
      }
      const int se = ie % kEStages;
      sm90::mbar_wait(R.eempty(se), ((ie / kEStages) & 1) ^ 1);
      sm90::mbar_expect_tx(R.efull(se), kSlabE);
      sm90::tma_load_2d(R.eslab(se), em, R.efull(se), 64 * kc, row0);
      ++ie;
    }
  };
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
    ready = false;
    if (MODE == kStash) row0 = t * kATile;
    for (int k = 0; k < (MODE == kDual ? 2 : 1); ++k) {
      const NetMaps& N = M.net[k];
      for (int i = 0; i < L.depth; ++i) {
        if (i == 0) {
          for (int kc = 0; kc < nk_p; ++kc) issue(&N.w0, 4, kc, 0, &M.ep);
        } else if (i - 1 == L.skip) {
          for (int kc = 0; kc < nk_p; ++kc) issue(&N.wk_e, 4, kc, 0, &M.ep);
          for (int kc = 0; kc < 4; ++kc) issue(&N.wk_h, 4, kc, 0, nullptr);
        } else {
          for (int kc = 0; kc < 4; ++kc) issue(&N.w256, 4, kc, L.w_layer[i] / kWidth, nullptr);
        }
      }
      if (full_net(MODE, k)) {
        for (int kc = 0; kc < 4; ++kc) issue(&N.w256, 4, kc, L.w_feat / kWidth, nullptr);
        for (int kc = 0; kc < 4; ++kc) issue(&N.wv_f, 2, kc, 0, nullptr);
        for (int kc = 0; kc < nk_v; ++kc) issue(&N.wv_e, 2, kc, 0, &M.ev);
      }
    }
  }
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Four values as bf16 into 8 bytes at p.
__device__ __forceinline__ void st_bf16x4(bf16* p, float a, float b, float c, float d) {
  uint2 v;
  v.x = bf162_bits(__floats2bfloat162_rn(a, b));
  v.y = bf162_bits(__floats2bfloat162_rn(c, d));
  *reinterpret_cast<uint2*>(p) = v;
}

// Joint frame R's direction of the ray direction (dx, dy, dz), normalised:
// the per-point and the per-ray view ladders both compute it here, so that
// they round alike.
__device__ __forceinline__ void local_dir(const float* R, float dx, float dy, float dz,
                                          float (&dn)[3]) {
  const float D0 = R[0] * dx + R[1] * dy + R[2] * dz;
  const float D1 = R[3] * dx + R[4] * dy + R[5] * dz;
  const float D2 = R[6] * dx + R[7] * dy + R[8] * dz;
  const float dn_inv = rsqrtf(fmaxf(D0 * D0 + D1 * D1 + D2 * D2, 1e-24f));
  dn[0] = D0 * dn_inv;
  dn[1] = D1 * dn_inv;
  dn[2] = D2 * dn_inv;
}

// One octave up a ladder: (sin, cos) of 2x from those of x.
__device__ __forceinline__ void double_angle(float& s, float& c) {
  const float s2 = 2.f * s * c;
  c = 1.f - 2.f * s * s;
  s = s2;
}

// 12 floats from p (16-byte aligned), through L1.
__device__ __forceinline__ void ld_f32x12(const float* p, float (&v)[12]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = x.x;
    v[4 * k + 1] = x.y;
    v[4 * k + 2] = x.z;
    v[4 * k + 3] = x.w;
  }
}

// The encodings of the 64 points from p0 (rows past n_pts repeat the last
// point; kStash skips them) into 64 slot rows: e_pts rows of pc and, with
// the view channels, e_view rows of vc bf16, in encode_tile's channel order
// and arithmetic (field.cuh). `pose` is the one pose in shared memory or, in
// the grouped modes, a table whose row gp / ppg (pose_ld floats apart) point
// gp reads. kFullLadder reads its ray's view ladder from vlad (rows of vc
// floats, view_ladder_kernel) in place of computing it.
// Work item (p, q) is point p's joints 4q .. 4q + 3: their kp channels in
// 8-byte vectors of 4 joints, their reldir and view channels in three vectors
// of 12 (joint, axis) values; a warpgroup's 128 threads take 3 items each.
template <int MODE>
__device__ __forceinline__ void encode_slot(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, int n_pts, int spr,
                                            int p0, const float* pose, int pose_ld, int ppg,
                                            const float* __restrict__ vlad, const Layout& L,
                                            bf16* __restrict__ e_pts, bf16* __restrict__ e_view,
                                            int t) {
  constexpr bool kView = has_view(MODE), kTable = grouped(MODE);
  const int kc = kJoints * (1 + 2 * L.nf_kp);
  const float* s_pose = pose;
  float tau = s_pose[kJoints * 13];
  const float* sw = s_pose + kPoseFloats;  // kp octaves, then view octaves
  for (int item = t; item < 64 * 6; item += 128) {
    const int p = item / 6, q = item - 6 * p;
    if (MODE == kStash && p0 + p >= n_pts) break;  // items run in point order
    const int gp = min(p0 + p, n_pts - 1);
    if (kTable) {
      s_pose = pose + static_cast<size_t>(gp / ppg) * pose_ld;
      tau = s_pose[kJoints * 13];
      sw = s_pose + kPoseFloats;
    }
    const float x = __ldg(pts + 3 * gp), y = __ldg(pts + 3 * gp + 1), z = __ldg(pts + 3 * gp + 2);
    float w[4], s[4], c[4], vw[4], u[12];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int j = 4 * q + a;
      const float* R = s_pose + 9 * j;
      const float* T = s_pose + kJoints * 9 + 3 * j;
      const float X = R[0] * x + R[1] * y + R[2] * z + T[0];
      const float Y = R[3] * x + R[4] * y + R[5] * z + T[1];
      const float Z = R[6] * x + R[7] * y + R[8] * z + T[2];
      const float v = sqrtf(X * X + Y * Y + Z * Z);
      w[a] = 1.f - 1.f / (1.f + expf(-(tau * (v - s_pose[kJoints * 12 + j]))));
      const float inv_v = 1.f / fmaxf(v, 1e-12f);
      vw[a] = v * w[a];
      sincosf(v, &s[a], &c[a]);
      u[3 * a] = X * inv_v;
      u[3 * a + 1] = Y * inv_v;
      u[3 * a + 2] = Z * inv_v;
    }
    bf16* ep = e_pts + static_cast<size_t>(p) * L.pc + 4 * q;
    st_bf16x4(ep, vw[0], vw[1], vw[2], vw[3]);
    for (int f = 0; f < L.nf_kp; ++f) {
      float os[4], oc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float wf = w[a] * sw[f];
        os[a] = s[a] * wf;
        oc[a] = c[a] * wf;
        const float s2 = 2.f * s[a] * c[a];
        c[a] = 1.f - 2.f * s[a] * s[a];
        s[a] = s2;
      }
      st_bf16x4(ep + (1 + 2 * f) * kJoints, os[0], os[1], os[2], os[3]);
      st_bf16x4(ep + (2 + 2 * f) * kJoints, oc[0], oc[1], oc[2], oc[3]);
    }
    bf16* rd = e_pts + static_cast<size_t>(p) * L.pc + kc + 12 * q;
#pragma unroll
    for (int k = 0; k < 3; ++k) st_bf16x4(rd + 4 * k, u[4 * k], u[4 * k + 1], u[4 * k + 2], u[4 * k + 3]);

    if (kView) {
      const int ray = gp / spr;
      bf16* ev = e_view + static_cast<size_t>(p) * L.vc + 12 * q;
      float sq[12], cq[12], o[12];
      // block 0: dn * w; then per octave sin, cos * w * the BARF weight
      const float* lr =
          MODE == kFullLadder ? vlad + static_cast<size_t>(ray) * L.vc + 12 * q : nullptr;
      if (MODE == kFullLadder) {
        ld_f32x12(lr, sq);
      } else {
        const float dx = __ldg(dirs + 3 * ray), dy = __ldg(dirs + 3 * ray + 1),
                    dz = __ldg(dirs + 3 * ray + 2);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float dn[3];
          local_dir(s_pose + 9 * (4 * q + a), dx, dy, dz, dn);
#pragma unroll
          for (int b = 0; b < 3; ++b) sq[3 * a + b] = dn[b];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int i = 3 * a + b;
          o[i] = sq[i] * w[a];
          if (MODE != kFullLadder) sincosf(sq[i], &sq[i], &cq[i]);
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) st_bf16x4(ev + 4 * k, o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
      for (int f = 0; f < L.nf_view; ++f) {
        float oc[12];
        if (MODE == kFullLadder) {
          ld_f32x12(lr + (1 + 2 * f) * 3 * kJoints, sq);
          ld_f32x12(lr + (2 + 2 * f) * 3 * kJoints, cq);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float wf = w[a] * sw[L.nf_kp + f];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int i = 3 * a + b;
            o[i] = sq[i] * wf;
            oc[i] = cq[i] * wf;
            if (MODE != kFullLadder) double_angle(sq[i], cq[i]);
          }
        }
        bf16* es = ev + (1 + 2 * f) * 3 * kJoints;
        bf16* ec = ev + (2 + 2 * f) * 3 * kJoints;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          st_bf16x4(es + 4 * k, o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
          st_bf16x4(ec + 4 * k, oc[4 * k], oc[4 * k + 1], oc[4 * k + 2], oc[4 * k + 3]);
        }
      }
    }
  }
}

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

// A head row w (N bf16) against this thread's rows r0 and r0 + 8 of v (its
// N / 2 accumulator columns, rounded to bf16 as the tile holds them): s[h],
// summed over the 4 lanes of the rows (every lane holds the sums).
template <int N>
__device__ __forceinline__ void head_dot(const float (&v)[128], const bf16* w, int quad,
                                         float (&s)[2]) {
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(w) + quad;
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 ww = __bfloat1622float2(w2[4 * j]);
    a += bf16r(v[4 * j]) * ww.x + bf16r(v[4 * j + 1]) * ww.y;
    b += bf16r(v[4 * j + 2]) * ww.x + bf16r(v[4 * j + 3]) * ww.y;
  }
#pragma unroll
  for (int m = 1; m < 4; m <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, m);
    b += __shfl_xor_sync(0xffffffffu, b, m);
  }
  s[0] = a;
  s[1] = b;
}

// out0 / w0 / b0: the net (kDual: the coarse net); out1 / w1 / b1: the fine
// net of kDual. ep / ev: the scratch's slots (kStash: the stashes). pose: the
// one pose (the grouped modes: the table of G). vlad: kFullLadder's per-ray
// view ladders.
template <int MODE>
__global__ void __launch_bounds__(kAThreads, 1)
    eval_sm90_kernel(const __grid_constant__ EvalMaps M, const float* __restrict__ pts,
                     const float* __restrict__ dirs, int n_pts, int spr,
                     const float* __restrict__ pose, const Layout L,
                     const bf16* __restrict__ w0, const float* __restrict__ b0,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     bf16* __restrict__ ep, bf16* __restrict__ ev, float* __restrict__ out0,
                     float* __restrict__ out1, const float* __restrict__ vlad, const Groups G) {
  constexpr bool kView = has_view(MODE);
  constexpr int kNets = MODE == kDual ? 2 : 1;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t tile = raw + pad;
  float* s_pose = reinterpret_cast<float*>(base + kEvalPose);
  bf16* s_head = reinterpret_cast<bf16*>(base + kEvalHeads);  // w_alpha x 2 | w_rgb
  const Ring R{tile + kRingW, tile + kRingE, tile + kEvalBars, kWStages};
  const uint32_t slot_bar = R.bars + 8 * 2 * (kWStages + kEStages);
  const int n_tiles = (n_pts + kATile - 1) / kATile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(R.wfull(s), 1);
      sm90::mbar_init(R.wempty(s), 2);
    }
    for (int s = 0; s < kEStages; ++s) {
      sm90::mbar_init(R.efull(s), 1);
      sm90::mbar_init(R.eempty(s), 2);
    }
    sm90::mbar_init(slot_bar, 2);
    sm90::fence_mbar_init();
  }
  const int n_pose = kPoseFloats + L.nf_kp + L.nf_view;
  if (!grouped(MODE)) {
    for (int i = threadIdx.x; i < n_pose; i += kAThreads) s_pose[i] = pose[i];
  }
  {
    const int t = threadIdx.x;
    uint4* h = reinterpret_cast<uint4*>(s_head);
    const bf16* wr = (MODE == kDual ? w1 : w0) + L.w_rgb;
    if (t < 32) {
      h[t] = reinterpret_cast<const uint4*>(w0 + L.w_alpha)[t];
    } else if (t < 64) {
      if (MODE == kDual) h[t] = reinterpret_cast<const uint4*>(w1 + L.w_alpha)[t - 32];
    } else if (t < 112) {
      if (kView) h[t] = reinterpret_cast<const uint4*>(wr)[t - 64];
    }
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) eval_produce<MODE>(M, L, n_tiles, R, slot_bar);
    return;
  }
  sm90::reg_alloc<232>();

  const Frag f;
  const int quad = f.lane & 3;
  const int nk_p = (L.pc + 63) / 64, nk_v = (L.vc + 63) / 64;
  const size_t srow = static_cast<size_t>(blockIdx.x) * kATile + 64 * f.wg;  // its slot rows
  bf16* const ep_w = ep + srow * L.pc;
  bf16* const ev_w = kView ? ev + srow * L.vc : nullptr;
  const bf16* wr_s = s_head + 2 * kWidth;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0, ie = 0;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = t * kATile;
    bf16* ep_t = ep_w;
    bf16* ev_t = ev_w;
    if (MODE == kStash) {  // the tile's own rows of the stashes
      ep_t = ep + static_cast<size_t>(p0 + 64 * f.wg) * L.pc;
      ev_t = ev + static_cast<size_t>(p0 + 64 * f.wg) * L.vc;
    }
    sm90::fence_async_global();
    encode_slot<MODE>(pts, dirs, n_pts, spr, p0 + 64 * f.wg, grouped(MODE) ? pose : s_pose,
                      G.pose_ld, G.ppg, vlad, L, ep_t, ev_t, f.t);
    sm90::fence_async_global();
    sm90::bar_sync(1 + f.wg, 128);
    if (f.t == 0) sm90::mbar_arrive(slot_bar);

    for (int k = 0; k < kNets; ++k) {
      const bool full = full_net(MODE, k);
      const float* __restrict__ B = k ? b1 : b0;
      float* __restrict__ out = k ? out1 : out0;
      float alpha[2] = {0.f, 0.f};
      // the trunk, then (full) the feature layer, i == depth, with no ReLU
      for (int i = 0; i < L.depth + full; ++i) {
        const bool trunk = i < L.depth;
        const bool cat = trunk && i > 0 && i - 1 == L.skip;
        if (i == 0 || cat) consume<256, 0>(acc, nk_p, true, 0, true, it, ie, R, f.wg);
        if (i > 0) consume<256, 0>(acc, 4, false, tile, !cat, it, ie, R, f.wg);
        // column 8 j + 2 quad + e of the bias (f.col), by immediate offsets
        const float* bias = B + (trunk ? L.b_layer[i] : L.b_feat) + 2 * quad;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bb = __ldg(bias + 8 * j + e);
            const float x0 = acc[4 * j + e] + bb, x1 = acc[4 * j + e + 2] + bb;
            acc[4 * j + e] = trunk ? fmaxf(x0, 0.f) : x0;
            acc[4 * j + e + 2] = trunk ? fmaxf(x1, 0.f) : x1;
          }
        }
        if (i == L.depth - 1) head_dot<256>(acc, s_head + kWidth * k, quad, alpha);
        if (i + 1 < L.depth || full) {  // the next layer's A operand
          tile_ready(f);
          uint32_t unused[4] = {0u, 0u, 0u, 0u};
          put_tile<256>(acc, base, 0, f, unused);
          tile_publish(f);
        }
      }
      const float b_alpha = __ldg(B + L.b_alpha);
      float rgb[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
      if (full) {  // the view layer on [feat | e_view], then the rgb head
        consume<128, 0>(acc, 4, false, tile, true, it, ie, R, f.wg);
        consume<128, 0>(acc, nk_v, true, 0, false, it, ie, R, f.wg);
        // the view bias of rows r0 and r0 + 8: the packed b's, or (grouped)
        // each row's group row of G.bview
        const float* bview = B + L.b_view + 2 * quad;
        const float* bview8 = bview;
        if (grouped(MODE)) {
          const int r = min(p0 + f.r0, n_pts - 1), r8 = min(p0 + f.r0 + 8, n_pts - 1);
          bview = G.bview + static_cast<size_t>(r / G.vppg) * G.vb_ld + 2 * quad;
          bview8 = G.bview + static_cast<size_t>(r8 / G.vppg) * G.vb_ld + 2 * quad;
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bb = __ldg(bview + 8 * j + e);
            const float bb8 = grouped(MODE) ? __ldg(bview8 + 8 * j + e) : bb;
            acc[4 * j + e] = fmaxf(acc[4 * j + e] + bb, 0.f);
            acc[4 * j + e + 2] = fmaxf(acc[4 * j + e + 2] + bb8, 0.f);
          }
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float s[2];
          head_dot<128>(acc, wr_s + kViewWidth * c, quad, s);
          const float bc = __ldg(B + L.b_rgb + c);
          rgb[0][c] = s[0] + bc;
          rgb[1][c] = s[1] + bc;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // lane q of a row's quad writes channel q
        const int gp = p0 + f.r0 + 8 * h;
        const float v = quad == 3   ? alpha[h] + b_alpha
                        : quad == 0 ? rgb[h][0]
                        : quad == 1 ? rgb[h][1]
                                    : rgb[h][2];
        if (gp < n_pts) out[4 * gp + quad] = v;
      }
    }
  }
}

// One net's weight maps; false when the encoder refuses one or a matrix of
// w256 is not at a multiple of 256 elements.
static bool net_maps(const Layout& L, const bf16* W, NetMaps* N) {
  using sm90::make_map;
  for (int i = 1; i < L.depth; ++i) {
    if (L.w_layer[i] % kWidth != 0) return false;
  }
  if (L.w_feat % kWidth != 0) return false;
  const int ld_k = L.pc + kWidth, ld_v = kWidth + L.vcp;
  const uint64_t rows256 = static_cast<uint64_t>(L.w_feat) / kWidth + kWidth;
  bool ok = make_map(&N->w256, W, kWidth, rows256, kWidth, 64) &&
            make_map(&N->w0, W + L.w_layer[0], L.pc, kWidth, L.pc, 64) &&
            make_map(&N->wv_f, W + L.w_view, kWidth, kViewWidth, ld_v, 64) &&
            make_map(&N->wv_e, W + L.w_view + kWidth, L.vc, kViewWidth, ld_v, 64);
  if (ok && L.skip >= 0 && L.skip + 1 < L.depth) {
    const bf16* wk = W + L.w_layer[L.skip + 1];
    ok = make_map(&N->wk_e, wk, L.pc, kWidth, ld_k, 64) &&
         make_map(&N->wk_h, wk + L.pc, kWidth, kWidth, ld_k, 64);
  }
  return ok;
}

// The slot modes' launch: the scratch's slots, the maps and the grid. G: the
// grouped modes' operands; vlad: kFullLadder's per-ray ladders.
template <int MODE>
static int launch(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                  const int* layout, int n_layout, const void* w0, const float* b0,
                  const void* w1, const float* b1, float* out0, float* out1, void* scratch,
                  long long scratch_bytes, cudaStream_t stream, const Groups& G = Groups{},
                  const float* vlad = nullptr) {
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || spr <= 0 || scratch == nullptr ||
      scratch_bytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long slots = scratch_bytes / static_cast<long long>(eval_slot_bytes(L));
  if (slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slots = slots < INT_MAX ? static_cast<int>(slots) : INT_MAX;
  const uint64_t slot_rows = static_cast<uint64_t>(n_slots) * kATile;
  bf16* ep = static_cast<bf16*>(scratch);
  bf16* ev = ep + slot_rows * L.pc;
  const auto* W0 = static_cast<const bf16*>(w0);
  const auto* W1 = static_cast<const bf16*>(w1);
  EvalMaps M{};
  if (!net_maps(L, W0, &M.net[0]) || (MODE == kDual && !net_maps(L, W1, &M.net[1])) ||
      !sm90::make_map(&M.ep, ep, L.pc, slot_rows, L.pc, kATile) ||
      (has_view(MODE) && !sm90::make_map(&M.ev, ev, L.vc, slot_rows, L.vc, kATile))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = eval_smem_bytes();
  const cudaError_t e = set_smem(eval_sm90_kernel<MODE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  eval_sm90_kernel<MODE><<<eval_grid(n_pts, n_slots), kAThreads, smem, stream>>>(
      M, pts, dirs, n_pts, spr, pose, L, W0, b0, W1, b1, ep, ev, out0, out1, vlad, G);
  return static_cast<int>(cudaGetLastError());
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
