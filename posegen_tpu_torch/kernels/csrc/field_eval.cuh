// The eval kernel's template, eval_sm90_kernel<MODE, VAR>, and its launch.
// field.cu instantiates the seven production modes at VAR 0 and describes
// their design; field_variants.cu instantiates the A/B harness's variants
// of the grouped modes (VAR below).

#pragma once

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

// The A/B harness's variants (field_variants.cu; VAR 0 is the production
// kernel). VAR packs enc (bits 0-1), probe (bits 2-3) and split (bit 4):
//   enc    kEncBf16 (bf16enc): the gate and each octave's sin / cos rounded to
//          bf16 and each gated channel a bf16 x bf16 product (the double-angle
//          recurrence stays f32); kEncMx (mxenc): the joint transforms as
//          (16 x 4) @ (4 x 8) products on the tensor cores (mma.sync, TF32 in
//          three passes), the rest as kEncBase
//   probe  kProbeEncode: the encode into the slot, then each point's sum of
//          its bf16 slot rows, with no products; kProbeGates: each point's sum
//          over the joints of v * w, with no slot and no products. The sum
//          fills the point's four output columns, and the producer issues no
//          load
//   split  (the harness's halves = 2) each consumer warpgroup releases its 64
//          slot rows on a barrier of its own and the producer loads them as
//          64-row boxes into full barriers of their own, so warpgroup 0's
//          first product runs while warpgroup 1 still encodes
enum VarEnc { kEncBase = 0, kEncBf16 = 1, kEncMx = 2 };
enum VarProbe { kProbeNone = 0, kProbeEncode = 1, kProbeGates = 2 };
constexpr int kVarSplit = 16;

__host__ __device__ constexpr int var_enc(int var) { return var & 3; }
__host__ __device__ constexpr int var_probe(int var) { return (var >> 2) & 3; }
__host__ __device__ constexpr bool var_split(int var) { return (var & kVarSplit) != 0; }

// Shared memory (bytes, from a 1,024-aligned base): the tile 65,536 | weight
// ring 3 x 32,768 | encoding ring 2 x 16,384 | pose operand 1,536 | head
// weights 2,048 (w_alpha of each net, then the full net's w_rgb) | 11
// mbarriers (the rings', the slot's): 201,304 with the alignment slack.
// The split variant keeps warpgroup 1's encoding full barriers and slot
// barrier in the head weights' last 256 bytes, which no mode reads (w_alpha
// x 2 and w_rgb take 1,792).
constexpr int kWStages = 3;
constexpr uint32_t kRingE = kRingW + kWStages * kSlabW;
constexpr uint32_t kEvalPose = kRingE + kEStages * kSlabE;
constexpr uint32_t kEvalHeads = kEvalPose + kPoseBytes;
constexpr uint32_t kHeadBytes = 2048;
constexpr uint32_t kEvalBars = kEvalHeads + kHeadBytes;
constexpr int kEvalBarCount = 2 * (kWStages + kEStages) + 1;
constexpr uint32_t kSplitBars = kEvalHeads + 1792;
static_assert(1792 + 8 * (kEStages + 1) <= kHeadBytes, "split barriers past the head region");

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
// for the block's n-th tile; split: each warpgroup's 64 rows for its own).
template <int MODE, int VAR>
__device__ void eval_produce(const EvalMaps& M, const Layout& L, int n_tiles, const Ring& R,
                             uint32_t slot_bar) {
  const int nk_p = (L.pc + 63) / 64, nk_v = (L.vc + 63) / 64;
  int row0 = blockIdx.x * kATile;  // the block's slot (kStash: the tile's rows)
  int it = 0, ie = 0, n = 0;
  bool ready = false, ready1 = false;
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
      if constexpr (var_split(VAR)) {
        sm90::mbar_expect_tx(R.efull(se), kSlabE / 2);
        sm90::tma_load_2d(R.eslab(se), em, R.efull(se), 64 * kc, row0);
        if (!ready1) {
          sm90::mbar_wait(R.e1 + 8 * kEStages, n & 1);
          ready1 = true;
        }
        sm90::mbar_expect_tx(R.e1 + 8 * se, kSlabE / 2);
        sm90::tma_load_2d(R.eslab(se) + kHalfBlock, em, R.e1 + 8 * se, 64 * kc, row0 + 64);
      } else {
        sm90::mbar_expect_tx(R.efull(se), kSlabE);
        sm90::tma_load_2d(R.eslab(se), em, R.efull(se), 64 * kc, row0);
      }
      ++ie;
    }
  };
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++n) {
    ready = ready1 = false;
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

// (D0, D1, D2) normalised.
__device__ __forceinline__ void normalise(float D0, float D1, float D2, float (&dn)[3]) {
  const float dn_inv = rsqrtf(fmaxf(D0 * D0 + D1 * D1 + D2 * D2, 1e-24f));
  dn[0] = D0 * dn_inv;
  dn[1] = D1 * dn_inv;
  dn[2] = D2 * dn_inv;
}

// Joint frame R's direction of the ray direction (dx, dy, dz), normalised:
// the per-point and the per-ray view ladders both compute it here, so that
// they round alike.
__device__ __forceinline__ void local_dir(const float* R, float dx, float dy, float dz,
                                          float (&dn)[3]) {
  normalise(R[0] * dx + R[1] * dy + R[2] * dz, R[3] * dx + R[4] * dy + R[5] * dz,
            R[6] * dx + R[7] * dy + R[8] * dz, dn);
}

// kEncMx's frame, in the warpgroup's 64 rows of the activation tile (frame:
// its first row), which are free while it encodes: its products of the
// previous tile are done, and nothing but put_tile writes the tile. Point p's
// channel c at row p, float c % 32 of the tile's 64-column block c / 32:
// channels 0-71 the joint transform (X of the 24 joints, then Y, then Z),
// 72-95 the gates.
constexpr int kFrameGates = 3 * kJoints;

__device__ __forceinline__ float* frame_at(unsigned char* frame, int p, int c) {
  return reinterpret_cast<float*>(frame + (c >> 5) * kBlockBytes + p * 128) + (c & 31);
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
// the view channels, e_view rows of vc bf16, joint-major (the channel order
// of render.raycast.encode_inputs):
//   e_pts[k*24 + j]           k = 0: v*w; k = 1+2f / 2+2f: sin / cos(2^f v)*w
//   e_pts[24(1+2nf) + 3j + a] reldir p_local[a] / max(v, 1e-12), ungated
//   e_view[k*72 + 3j + a]     k = 0: dn[a]*w; 1+2f / 2+2f: sin / cos(2^f dn[a])*w
// with p_local = R_j p + t_j, v = |p_local|, w = 1 - sigmoid(tau (v - cut_j)),
// dn the normalised local ray direction; each octave's gate also carries its
// BARF weight, and the octaves come from one sin / cos pair and the
// double-angle recurrence. `pose` is the one pose in shared memory or, in
// the grouped modes, a table whose row gp / ppg (pose_ld floats apart) point
// gp reads. kFullLadder reads its ray's view ladder from vlad (rows of vc
// floats, view_ladder_kernel) in place of computing it.
// Work item (p, q) is point p's joints 4q .. 4q + 3: their kp channels in
// 8-byte vectors of 4 joints, their reldir and view channels in three vectors
// of 12 (joint, axis) values; a warpgroup's 128 threads take 3 items each.
// VAR's enc rounds as bf16enc or, for kEncMx, reads each joint's local point
// from the warpgroup's frame (transform_mx): PART kPartPts writes e_pts and
// keeps the gates in the frame, then, once the frame holds the local
// directions, kPartView writes e_view.
enum EncPart { kPartPts = 1, kPartView = 2, kPartAll = 3 };

template <int MODE, int VAR = 0, int PART = kPartAll>
__device__ __forceinline__ void encode_slot(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, int n_pts, int spr,
                                            int p0, const float* pose, int pose_ld, int ppg,
                                            const float* __restrict__ vlad, const Layout& L,
                                            bf16* __restrict__ e_pts, bf16* __restrict__ e_view,
                                            int t, unsigned char* frame = nullptr) {
  constexpr bool kTable = grouped(MODE), kPts = (PART & kPartPts) != 0;
  constexpr bool kView = has_view(MODE) && (PART & kPartView) != 0;
  constexpr bool kBf16 = var_enc(VAR) == kEncBf16, kMx = var_enc(VAR) == kEncMx;
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
    float w[4], s[4], c[4], vw[4], u[12];
    if constexpr (kPts) {
      const float x = __ldg(pts + 3 * gp), y = __ldg(pts + 3 * gp + 1),
                  z = __ldg(pts + 3 * gp + 2);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = 4 * q + a;
        float X, Y, Z;
        if constexpr (kMx) {
          X = *frame_at(frame, p, j);
          Y = *frame_at(frame, p, kJoints + j);
          Z = *frame_at(frame, p, 2 * kJoints + j);
        } else {
          const float* R = s_pose + 9 * j;
          const float* T = s_pose + kJoints * 9 + 3 * j;
          X = R[0] * x + R[1] * y + R[2] * z + T[0];
          Y = R[3] * x + R[4] * y + R[5] * z + T[1];
          Z = R[6] * x + R[7] * y + R[8] * z + T[2];
        }
        const float v = sqrtf(X * X + Y * Y + Z * Z);
        w[a] = 1.f - 1.f / (1.f + expf(-(tau * (v - s_pose[kJoints * 12 + j]))));
        if constexpr (kMx && has_view(MODE)) *frame_at(frame, p, kFrameGates + j) = w[a];
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
          const float wf = kBf16 ? bf16r(w[a] * sw[f]) : w[a] * sw[f];
          os[a] = (kBf16 ? bf16r(s[a]) : s[a]) * wf;
          oc[a] = (kBf16 ? bf16r(c[a]) : c[a]) * wf;
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
    } else {  // kMx's second part: the gates its first part kept
#pragma unroll
      for (int a = 0; a < 4; ++a) w[a] = *frame_at(frame, p, kFrameGates + 4 * q + a);
    }

    if constexpr (kView) {
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
          const int j = 4 * q + a;
          float dn[3];
          if constexpr (kMx) {
            normalise(*frame_at(frame, p, j), *frame_at(frame, p, kJoints + j),
                      *frame_at(frame, p, 2 * kJoints + j), dn);
          } else {
            local_dir(s_pose + 9 * j, dx, dy, dz, dn);
          }
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
          const float wf =
              kBf16 ? bf16r(w[a] * sw[L.nf_kp + f]) : w[a] * sw[L.nf_kp + f];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int i = 3 * a + b;
            o[i] = (kBf16 ? bf16r(sq[i]) : sq[i]) * wf;
            oc[i] = (kBf16 ? bf16r(cq[i]) : cq[i]) * wf;
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

// ---------------------------------------------------------------------------
// The variants' own device code (VAR != 0)
// ---------------------------------------------------------------------------

// x = big + small, both TF32: big * big + big * small + small * big keeps
// about 21 of float32's 24 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// d += A (16 x 8, row-major) @ B (8 x 8, column-major): TF32 operands, f32
// accumulation. Only K columns 0-3 are used: the A and B registers of
// columns / rows 4-7 are zero.
__device__ __forceinline__ void mma_k4(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
}

// kEncMx: channel 24 a + j of the frame = (R_j p + t_j)[a] of the
// warpgroup's 64 points from p0 (dirs: (R_j d)[a] of each point's ray
// direction), as one 16-point m-tile of [p | 1] ([d | 0]) against one
// 8-channel n-tile of [R_j row a | t_j[a]] per warp task, 9 n-tiles x 4
// m-tiles over the warpgroup's 4 warps. An m-tile whose points span pose
// groups runs once per group and keeps its rows.
template <int MODE>
__device__ void transform_mx(const float* __restrict__ src, bool dirs, int spr, int n_pts,
                             int p0, const float* pose, int pose_ld, int ppg,
                             unsigned char* frame, int t) {
  constexpr bool kTable = grouped(MODE);
  constexpr int kNt = 3 * kJoints / 8;
  const int warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group, column
  for (int task = warp; task < 4 * kNt; task += 4) {
    const int mt = task / kNt, nt = task - kNt * mt;
    const int r0 = 16 * mt + gid, r1 = r0 + 8;
    const int gp0 = min(p0 + r0, n_pts - 1), gp1 = min(p0 + r1, n_pts - 1);
    const int i0 = dirs ? gp0 / spr : gp0, i1 = dirs ? gp1 / spr : gp1;
    // A: rows r0, r1 of [x y z 1] ([dx dy dz 0]), column tig
    const float one = dirs ? 0.f : 1.f;
    uint32_t a0b, a0s, a1b, a1s;
    split_tf32(tig < 3 ? __ldg(src + 3 * i0 + tig) : one, a0b, a0s);
    split_tf32(tig < 3 ? __ldg(src + 3 * i1 + tig) : one, a1b, a1s);
    // B: column gid of the n-tile is channel c = (a, j), row tig its K term
    const int c = 8 * nt + gid, a = c / kJoints, j = c - a * kJoints;
    const int g_lo = kTable ? min(p0 + 16 * mt, n_pts - 1) / ppg : 0;
    const int g_hi = kTable ? min(p0 + 16 * mt + 15, n_pts - 1) / ppg : 0;
    const int col = 8 * nt + 2 * tig;
    for (int g = g_lo; g <= g_hi; ++g) {
      const float* P = pose + static_cast<size_t>(g) * pose_ld;
      uint32_t bb, bs;
      split_tf32(tig < 3 ? P[9 * j + 3 * a + tig] : P[kJoints * 9 + 3 * j + a], bb, bs);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k4(d, a0s, a1s, bb);
      mma_k4(d, a0b, a1b, bs);
      mma_k4(d, a0b, a1b, bb);
      if (!kTable || gp0 / ppg == g) {
        *frame_at(frame, r0, col) = d[0];
        *frame_at(frame, r0, col + 1) = d[1];
      }
      if (!kTable || gp1 / ppg == g) {
        *frame_at(frame, r1, col) = d[2];
        *frame_at(frame, r1, col + 1) = d[3];
      }
    }
  }
}

// kProbeGates: each of the warpgroup's 64 points from p0 (encode_slot's
// transforms and gates) -> its sum over the joints of v * w in its four
// columns of out; two threads a point, 12 joints each.
template <int MODE>
__device__ __forceinline__ void gate_sums(const float* __restrict__ pts, int n_pts, int p0,
                                          const float* pose, int pose_ld, int ppg,
                                          float* __restrict__ out, int t) {
  const int p = t >> 1, h = t & 1;
  const int gp = min(p0 + p, n_pts - 1);
  const float* s_pose = grouped(MODE) ? pose + static_cast<size_t>(gp / ppg) * pose_ld : pose;
  const float tau = s_pose[kJoints * 13];
  const float x = __ldg(pts + 3 * gp), y = __ldg(pts + 3 * gp + 1), z = __ldg(pts + 3 * gp + 2);
  float sum = 0.f;
  for (int j = 12 * h; j < 12 * h + 12; ++j) {
    const float* R = s_pose + 9 * j;
    const float* T = s_pose + kJoints * 9 + 3 * j;
    const float X = R[0] * x + R[1] * y + R[2] * z + T[0];
    const float Y = R[3] * x + R[4] * y + R[5] * z + T[1];
    const float Z = R[6] * x + R[7] * y + R[8] * z + T[2];
    const float v = sqrtf(X * X + Y * Y + Z * Z);
    sum += v * (1.f - 1.f / (1.f + expf(-(tau * (v - s_pose[kJoints * 12 + j])))));
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (p0 + p < n_pts) {
    out[4 * gp + 2 * h] = sum;
    out[4 * gp + 2 * h + 1] = sum;
  }
}

// kProbeEncode: each of the warpgroup's 64 points from p0 -> the sum of its
// slot rows (e_pts, and e_view with the view channels), the bf16 values the
// products would read, in its four columns of out; two threads a point,
// alternate bf16 pairs.
template <int MODE>
__device__ __forceinline__ void slot_sums(const bf16* e_pts, const bf16* e_view, const Layout& L,
                                          int n_pts, int p0, float* __restrict__ out, int t) {
  const int p = t >> 1, h = t & 1;
  float sum = 0.f;
  const auto* rp = reinterpret_cast<const __nv_bfloat162*>(e_pts + static_cast<size_t>(p) * L.pc);
  for (int k = h; k < L.pc / 2; k += 2) {
    const float2 v = __bfloat1622float2(rp[k]);
    sum += v.x + v.y;
  }
  if constexpr (has_view(MODE)) {
    const auto* rv =
        reinterpret_cast<const __nv_bfloat162*>(e_view + static_cast<size_t>(p) * L.vc);
    for (int k = h; k < L.vc / 2; k += 2) {
      const float2 v = __bfloat1622float2(rv[k]);
      sum += v.x + v.y;
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (p0 + p < n_pts) {
    out[4 * (p0 + p) + 2 * h] = sum;
    out[4 * (p0 + p) + 2 * h + 1] = sum;
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
// view ladders. VAR: the A/B harness's variants (0: the production kernel).
template <int MODE, int VAR = 0>
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
  constexpr bool kSplit = var_split(VAR);
  constexpr int kProbe = var_probe(VAR);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t tile = raw + pad;
  float* s_pose = reinterpret_cast<float*>(base + kEvalPose);
  bf16* s_head = reinterpret_cast<bf16*>(base + kEvalHeads);  // w_alpha x 2 | w_rgb
  const Ring R{tile + kRingW, tile + kRingE, tile + kEvalBars, kWStages,
               kSplit ? tile + kSplitBars : 0u};
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
    sm90::mbar_init(slot_bar, kSplit ? 1 : 2);
    if (kSplit) {  // warpgroup 1's encoding full barriers, then its slot barrier
      for (int s = 0; s <= kEStages; ++s) sm90::mbar_init(R.e1 + 8 * s, 1);
    }
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
    if (threadIdx.x == 256 && kProbe == kProbeNone) {
      eval_produce<MODE, VAR>(M, L, n_tiles, R, slot_bar);
    }
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

  const float* const pose_e = grouped(MODE) ? pose : s_pose;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int p0 = t * kATile;
    const int pw = p0 + 64 * f.wg;  // the warpgroup's first point
    if constexpr (kProbe == kProbeGates) {
      gate_sums<MODE>(pts, n_pts, pw, pose_e, G.pose_ld, G.ppg, out0, f.t);
      continue;
    }
    bf16* ep_t = ep_w;
    bf16* ev_t = ev_w;
    if (MODE == kStash) {  // the tile's own rows of the stashes
      ep_t = ep + static_cast<size_t>(p0 + 64 * f.wg) * L.pc;
      ev_t = ev + static_cast<size_t>(p0 + 64 * f.wg) * L.vc;
    }
    sm90::fence_async_global();
    if constexpr (var_enc(VAR) == kEncMx) {  // the points' frame, then the directions'
      unsigned char* frame = base + 64 * f.wg * 128;
      sm90::bar_sync(1 + f.wg, 128);  // every warp's products of the last tile are done
      transform_mx<MODE>(pts, false, spr, n_pts, pw, pose_e, G.pose_ld, G.ppg, frame, f.t);
      sm90::bar_sync(1 + f.wg, 128);
      encode_slot<MODE, VAR, kPartPts>(pts, dirs, n_pts, spr, pw, pose_e, G.pose_ld, G.ppg,
                                       vlad, L, ep_t, ev_t, f.t, frame);
      if constexpr (kView) {
        sm90::bar_sync(1 + f.wg, 128);
        transform_mx<MODE>(dirs, true, spr, n_pts, pw, pose_e, G.pose_ld, G.ppg, frame, f.t);
        sm90::bar_sync(1 + f.wg, 128);
        encode_slot<MODE, VAR, kPartView>(pts, dirs, n_pts, spr, pw, pose_e, G.pose_ld, G.ppg,
                                          vlad, L, ep_t, ev_t, f.t, frame);
      }
    } else {
      encode_slot<MODE, VAR>(pts, dirs, n_pts, spr, p0 + 64 * f.wg, pose_e, G.pose_ld, G.ppg,
                             vlad, L, ep_t, ev_t, f.t);
    }
    if constexpr (kProbe == kProbeEncode) {  // its rows, read before the next tile's encode
      sm90::bar_sync(1 + f.wg, 128);
      slot_sums<MODE>(ep_t, ev_t, L, n_pts, pw, out0, f.t);
      sm90::bar_sync(1 + f.wg, 128);
      continue;
    }
    sm90::fence_async_global();
    sm90::bar_sync(1 + f.wg, 128);
    if (f.t == 0) sm90::mbar_arrive(kSplit && f.wg ? R.e1 + 8 * kEStages : slot_bar);

    for (int k = 0; k < kNets; ++k) {
      const bool full = full_net(MODE, k);
      const float* __restrict__ B = k ? b1 : b0;
      float* __restrict__ out = k ? out1 : out0;
      float alpha[2] = {0.f, 0.f};
      // the trunk, then (full) the feature layer, i == depth, with no ReLU
      for (int i = 0; i < L.depth + full; ++i) {
        const bool trunk = i < L.depth;
        const bool cat = trunk && i > 0 && i - 1 == L.skip;
        if (i == 0 || cat) consume<256, 0, kSplit>(acc, nk_p, true, 0, true, it, ie, R, f.wg);
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
        consume<128, 0, kSplit>(acc, nk_v, true, 0, false, it, ie, R, f.wg);
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
// grouped modes' operands; vlad: kFullLadder's per-ray ladders; VAR: the A/B
// harness's variants (the split variant reads the slots in 64-row boxes).
template <int MODE, int VAR = 0>
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
  const uint32_t box = var_split(VAR) ? kATile / 2 : kATile;
  EvalMaps M{};
  if (!net_maps(L, W0, &M.net[0]) || (MODE == kDual && !net_maps(L, W1, &M.net[1])) ||
      !sm90::make_map(&M.ep, ep, L.pc, slot_rows, L.pc, box) ||
      (has_view(MODE) && !sm90::make_map(&M.ev, ev, L.vc, slot_rows, L.vc, box))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = eval_smem_bytes();
  const cudaError_t e = set_smem(eval_sm90_kernel<MODE, VAR>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  eval_sm90_kernel<MODE, VAR><<<eval_grid(n_pts, n_slots), kAThreads, smem, stream>>>(
      M, pts, dirs, n_pts, spr, pose, L, W0, b0, W1, b1, ep, ev, out0, out1, vlad, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace posegen
