// Fused skeleton-encode + NeRF MLP eval kernels for Hopper (sm_90a), bound
// to Python through a plain C interface (ctypes).
//
//   posegen_field  replaces posegen_tpu/kernels/field.py::_field_kernel
//                  (full raw, or density_only: trunk + alpha head only)
//   posegen_dual   replaces posegen_tpu/kernels/field.py::_dual_kernel
//                  (one encode, coarse trunk + alpha head and the full fine net)
//
// Bound on an H100: operations. The flagship field evaluation is 1,723,648
// FLOP per point and the dual one 3,084,032, against 40-56 bytes of input and
// output per point; at 989 TFLOP/s (bf16 dense) that is 1.74 ns and 3.12 ns
// per point.
//
// One template, three instantiations (kFull, kDensity, kDual), on the
// 128-point tile of sm90_tile.cuh (kernel 4's pass (a) design): a persistent
// grid of min(tiles, slots) blocks, each of two consumer warpgroups and one
// producer warp, walks the tiles blockIdx.x, + gridDim.x, ... For each tile:
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

#include <limits.h>

#include "field.cuh"
#include "sm90.cuh"
#include "sm90_tile.cuh"

namespace posegen {

enum Mode { kFull = 0, kDensity = 1, kDual = 2 };

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
  const int row0 = blockIdx.x * kATile;  // the block's slot
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
      if (MODE == kFull || (MODE == kDual && k == 1)) {
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

// The encodings of the 64 points from p0 (rows past n_pts repeat the last
// point) into 64 slot rows: e_pts rows of pc and, with kView, e_view rows of
// vc bf16, in encode_tile's channel order and arithmetic (field.cuh). Work
// item (p, q) is point p's joints 4q .. 4q + 3: their kp channels in 8-byte
// vectors of 4 joints, their reldir and view channels in three vectors of 12
// (joint, axis) values; a warpgroup's 128 threads take 3 items each.
template <bool kView>
__device__ __forceinline__ void encode_slot(const float* __restrict__ pts,
                                            const float* __restrict__ dirs, int n_pts, int spr,
                                            int p0, const float* s_pose, const Layout& L,
                                            bf16* __restrict__ e_pts, bf16* __restrict__ e_view,
                                            int t) {
  const int kc = kJoints * (1 + 2 * L.nf_kp);
  const float tau = s_pose[kJoints * 13];
  const float* sw = s_pose + kPoseFloats;  // kp octaves, then view octaves
  for (int item = t; item < 64 * 6; item += 128) {
    const int p = item / 6, q = item - 6 * p;
    const int gp = min(p0 + p, n_pts - 1);
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
      const float dx = __ldg(dirs + 3 * ray), dy = __ldg(dirs + 3 * ray + 1),
                  dz = __ldg(dirs + 3 * ray + 2);
      float sq[12], cq[12], o[12];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* R = s_pose + 9 * (4 * q + a);
        const float D0 = R[0] * dx + R[1] * dy + R[2] * dz;
        const float D1 = R[3] * dx + R[4] * dy + R[5] * dz;
        const float D2 = R[6] * dx + R[7] * dy + R[8] * dz;
        const float dn_inv = rsqrtf(fmaxf(D0 * D0 + D1 * D1 + D2 * D2, 1e-24f));
        const float dn[3] = {D0 * dn_inv, D1 * dn_inv, D2 * dn_inv};
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          o[3 * a + b] = dn[b] * w[a];
          sincosf(dn[b], &sq[3 * a + b], &cq[3 * a + b]);
        }
      }
      bf16* ev = e_view + static_cast<size_t>(p) * L.vc + 12 * q;
#pragma unroll
      for (int k = 0; k < 3; ++k) st_bf16x4(ev + 4 * k, o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
      for (int f = 0; f < L.nf_view; ++f) {
        float oc[12];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float wf = w[a] * sw[L.nf_kp + f];
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            const int i = 3 * a + b;
            o[i] = sq[i] * wf;
            oc[i] = cq[i] * wf;
            const float s2 = 2.f * sq[i] * cq[i];
            cq[i] = 1.f - 2.f * sq[i] * sq[i];
            sq[i] = s2;
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

// out0 / w0 / b0: the net (kFull, kDensity) or the coarse net (kDual);
// out1 / w1 / b1: the fine net of kDual. ep / ev: the scratch's slots.
template <int MODE>
__global__ void __launch_bounds__(kAThreads, 1)
    eval_sm90_kernel(const __grid_constant__ EvalMaps M, const float* __restrict__ pts,
                     const float* __restrict__ dirs, int n_pts, int spr,
                     const float* __restrict__ pose, const Layout L,
                     const bf16* __restrict__ w0, const float* __restrict__ b0,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     bf16* __restrict__ ep, bf16* __restrict__ ev, float* __restrict__ out0,
                     float* __restrict__ out1) {
  constexpr bool kView = MODE != kDensity;
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
  for (int i = threadIdx.x; i < n_pose; i += kAThreads) s_pose[i] = pose[i];
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
    sm90::fence_async_global();
    encode_slot<kView>(pts, dirs, n_pts, spr, p0 + 64 * f.wg, s_pose, L, ep_w, ev_w, f.t);
    sm90::fence_async_global();
    sm90::bar_sync(1 + f.wg, 128);
    if (f.t == 0) sm90::mbar_arrive(slot_bar);

    for (int k = 0; k < kNets; ++k) {
      const bool full = MODE == kFull || (MODE == kDual && k == 1);
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
        const float* bview = B + L.b_view + 2 * quad;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bb = __ldg(bview + 8 * j + e);
            acc[4 * j + e] = fmaxf(acc[4 * j + e] + bb, 0.f);
            acc[4 * j + e + 2] = fmaxf(acc[4 * j + e + 2] + bb, 0.f);
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

template <int MODE>
static int launch(const float* pts, const float* dirs, int n_pts, int spr, const float* pose,
                  const int* layout, int n_layout, const void* w0, const float* b0,
                  const void* w1, const float* b1, float* out0, float* out1, void* scratch,
                  long long scratch_bytes, cudaStream_t stream) {
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
      (MODE != kDensity && !sm90::make_map(&M.ev, ev, L.vc, slot_rows, L.vc, kATile))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = eval_smem_bytes();
  const cudaError_t e = set_smem(eval_sm90_kernel<MODE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  eval_sm90_kernel<MODE><<<eval_grid(n_pts, n_slots), kAThreads, smem, stream>>>(
      M, pts, dirs, n_pts, spr, pose, L, W0, b0, W1, b1, ep, ev, out0, out1);
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
