// The field kernel's A/B variants for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes), like field.cu.
//
//   posegen_field_variant  replaces tools/exp_kernel_variants.py::variant_field
//                          (:269): kernel 2's encode + MLP on points grouped by
//                          pose, under the A/B harness's flags
//
// The flags that change the function are runtime arguments, the same for
// every block (kernels/variants.py maps the harness's flags onto them):
//   enc     0  the field kernels' encode (field.cuh encode_tile);
//           1  bf16enc: the gate and each octave's sin / cos rounded to bf16,
//              each gated channel a bf16 x bf16 product rounded to bf16 (the
//              double-angle recurrence stays f32);
//           2  mxenc: the 24 joint transforms of 16 points as one (16 x 4) @
//              (4 x 72) product on the tensor cores (mma.sync TF32 in three
//              passes, big*big + big*small + small*big, which keeps float32
//              accuracy), the rest as enc 0;
//   probe   0  the field; 1 each point's sum of its encoding channels (the
//              bf16 operands the MLP would read); 2 each point's sum over the
//              joints of v * w (transforms and gates only); a probe's sum
//              fills all four output columns;
//   halves  encode the block's TILE points, then run the MLP over
//           TILE / halves-row sub-tiles in turn.
// TILE (points per block: 32, 64 or 128) and density_only (trunk + alpha
// head, rgb zero) set the shared-memory layout and are template parameters.
// The harness's skipsplit, viewsplit and bf16act choose how the TPU lays out
// its operands; this body never builds a concatenation and keeps every
// activation as bf16 in shared memory, so it always is their bf16 form and
// they select no code.
//
// Bound on an H100 (see field.cuh): operations, as kernel 2. The flagship
// field is 1,723,648 FLOP per point and the density-only one 1,360,384,
// against 40 bytes of input and output per point: 1.142 ms and 0.901 ms at
// 655,360 points at 989 TFLOP/s. The probes do no tensor-core work. Design:
// the field kernels' body (field.cuh) at TILE points per block. At TILE 32 a
// block needs 97,280 bytes of shared memory at the flagship widths, so two
// blocks share an SM and one block's encode can run beside the other's MMA;
// TILE 128 fits only without the view head. mxenc's transform buffer and
// the gate probe's sums reuse the activation tile, free until the MLP.

#include <cstdint>

#include "field.cuh"

namespace posegen {

enum VariantEnc { kEncBase = 0, kEncBf16 = 1, kEncMx = 2 };
enum VariantProbe { kProbeNone = 0, kProbeEncode = 1, kProbeGates = 2 };
constexpr int kFrame = 3 * kJoints;  // X, Y, Z of the 24 joints

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The pose row of point gp: its group's row of the table, or `pose` itself
// when pose_ld == 0.
__device__ __forceinline__ const float* pose_row(const float* pose, int pose_ld, int ppg, int gp) {
  return pose + (pose_ld ? static_cast<size_t>(gp / ppg) * pose_ld : 0);
}

// Distance and cutoff gate of joint j at the local point (X, Y, Z).
__device__ __forceinline__ void joint_gate(const float* s_pose, int j, float X, float Y, float Z,
                                           float* v, float* w) {
  const float tau = s_pose[kJoints * 13];
  const float cut = s_pose[kJoints * 12 + j];
  *v = sqrtf(X * X + Y * Y + Z * Z);
  *w = 1.f - 1.f / (1.f + expf(-(tau * (*v - cut))));
}

// World -> joint j's frame: R p + t, or R d (with_t false).
__device__ __forceinline__ void to_joint(const float* s_pose, int j, const float* p, bool with_t,
                                         float* X, float* Y, float* Z) {
  const float* R = s_pose + 9 * j;
  const float* T = s_pose + kJoints * 9 + 3 * j;
  const float t0 = with_t ? T[0] : 0.f, t1 = with_t ? T[1] : 0.f, t2 = with_t ? T[2] : 0.f;
  *X = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t0;
  *Y = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t1;
  *Z = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t2;
}

// ---------------------------------------------------------------------------
// mxenc: the joint transforms on the tensor cores
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32: big * big + big * small + small * big keeps
// about 21 of float32's 24 bits of each product.
__device__ __forceinline__ void split_tf32(float x, uint32_t* big, uint32_t* small) {
  *big = to_tf32(x);
  *small = to_tf32(x - __uint_as_float(*big));
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

// frame[p * 72 + a * 24 + j] = (R_j p + t_j)[a] for the block's points, and
// with kView the dirs' R_j d at frame + TILE * 72: per warp task, one
// 16-point m-tile against one 8-column n-tile of [R_j | t_j] rows. An m-tile
// whose points span pose groups runs once per group and keeps its rows.
template <int TILE, bool kView>
__device__ void transform_mx(const float* __restrict__ pts, const float* __restrict__ dirs,
                             int n_pts, int p0, const float* pose, int pose_ld, int ppg,
                             float* frame) {
  constexpr int kMt = TILE / 16, kNt = kFrame / 8;
  constexpr int kTasks = (kView ? 2 : 1) * kMt * kNt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;  // the fragments' row group, column
  for (int task = warp; task < kTasks; task += kWarps) {
    const int side = task / (kMt * kNt);  // 0: points, 1: dirs
    const int mt = (task / kNt) % kMt, nt = task % kNt;
    const float* src = side ? dirs : pts;
    const int r0 = 16 * mt + gid, r1 = r0 + 8;
    const int gp0 = min(p0 + r0, n_pts - 1), gp1 = min(p0 + r1, n_pts - 1);
    // A: rows r0, r1 of [x y z 1] (dirs: [dx dy dz 0]), column tig
    const float one = side ? 0.f : 1.f;
    uint32_t a0b, a0s, a1b, a1s;
    split_tf32(tig < 3 ? src[3 * gp0 + tig] : one, &a0b, &a0s);
    split_tf32(tig < 3 ? src[3 * gp1 + tig] : one, &a1b, &a1s);
    // B: column gid of the n-tile is channel c = (a, j), row tig its K term
    const int c = 8 * nt + gid, a = c / kJoints, j = c - a * kJoints;
    const int g_lo = pose_ld ? min(p0 + 16 * mt, n_pts - 1) / ppg : 0;
    const int g_hi = pose_ld ? min(p0 + 16 * mt + 15, n_pts - 1) / ppg : 0;
    float* out = frame + side * TILE * kFrame;
    const int col = 8 * nt + 2 * tig;
    for (int g = g_lo; g <= g_hi; ++g) {
      const float* P = pose + static_cast<size_t>(g) * pose_ld;
      uint32_t bb, bs;
      split_tf32(tig < 3 ? P[9 * j + 3 * a + tig] : P[kJoints * 9 + 3 * j + a], &bb, &bs);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_k4(d, a0s, a1s, bb);
      mma_k4(d, a0b, a1b, bs);
      mma_k4(d, a0b, a1b, bb);
      if (!pose_ld || gp0 / ppg == g) {
        out[r0 * kFrame + col] = d[0];
        out[r0 * kFrame + col + 1] = d[1];
      }
      if (!pose_ld || gp1 / ppg == g) {
        out[r1 * kFrame + col] = d[2];
        out[r1 * kFrame + col + 1] = d[3];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16enc and mxenc encodes: encode_tile's channels (joint-major, see
// field.cuh), rounded as bf16enc rounds them, or from mxenc's frames.
// ---------------------------------------------------------------------------
template <bool kView, int TILE>
__device__ void encode_variant(const float* __restrict__ pts, const float* __restrict__ dirs,
                               int n_pts, int p0, const float* pose, int pose_ld, int ppg,
                               const Layout& L, bool bf16enc, const float* frame, bf16* e_pts,
                               bf16* e_view) {
  const int ldp = pts_ld(L), ldv = view_ld(L);
  const int kc = kJoints * (1 + 2 * L.nf_kp);
  // a gated channel: f32 product rounded once, or bf16 x bf16 rounded
  auto gated = [bf16enc](float s, float wf) {
    return __float2bfloat16(bf16enc ? bf16_round(s) * bf16_round(wf) : s * wf);
  };
  for (int t = threadIdx.x; t < TILE * kJoints; t += kThreads) {
    const int p = t / kJoints;
    const int j = t - p * kJoints;
    const int gp = min(p0 + p, n_pts - 1);
    const float* s_pose = pose_row(pose, pose_ld, ppg, gp);
    const float* sw = s_pose + kPoseFloats;  // kp octaves, then view octaves
    float X, Y, Z;
    if (frame) {
      const float* f = frame + p * kFrame;
      X = f[j], Y = f[kJoints + j], Z = f[2 * kJoints + j];
    } else {
      to_joint(s_pose, j, pts + 3 * gp, true, &X, &Y, &Z);
    }
    float v, w;
    joint_gate(s_pose, j, X, Y, Z, &v, &w);
    const float inv_v = 1.f / fmaxf(v, 1e-12f);

    bf16* ep = e_pts + p * ldp;
    ep[j] = __float2bfloat16(v * w);
    float s, c;
    sincosf(v, &s, &c);
    for (int f = 0; f < L.nf_kp; ++f) {
      const float wf = w * sw[f];
      ep[(1 + 2 * f) * kJoints + j] = gated(s, wf);
      ep[(2 + 2 * f) * kJoints + j] = gated(c, wf);
      const float s2 = 2.f * s * c;
      c = 1.f - 2.f * s * s;
      s = s2;
    }
    ep[kc + 3 * j + 0] = __float2bfloat16(X * inv_v);
    ep[kc + 3 * j + 1] = __float2bfloat16(Y * inv_v);
    ep[kc + 3 * j + 2] = __float2bfloat16(Z * inv_v);

    if (kView) {
      float D[3];
      if (frame) {
        const float* f = frame + (TILE + p) * kFrame;
        D[0] = f[j], D[1] = f[kJoints + j], D[2] = f[2 * kJoints + j];
      } else {
        to_joint(s_pose, j, dirs + 3 * gp, false, &D[0], &D[1], &D[2]);
      }
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
          ev[(1 + 2 * f) * 3 * kJoints + 3 * j + a] = gated(sq, wf);
          ev[(2 + 2 * f) * 3 * kJoints + 3 * j + a] = gated(cq, wf);
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
// The probes
// ---------------------------------------------------------------------------

// probe 2: out[gp, :] = sum_j v_j w_j (joints in order, through `part`,
// TILE x 24 floats of shared memory)
template <int TILE>
__device__ void gate_sums(const float* __restrict__ pts, int n_pts, int p0, const float* pose,
                          int pose_ld, int ppg, float* part, float* __restrict__ out) {
  for (int t = threadIdx.x; t < TILE * kJoints; t += kThreads) {
    const int p = t / kJoints;
    const int j = t - p * kJoints;
    const int gp = min(p0 + p, n_pts - 1);
    const float* s_pose = pose_row(pose, pose_ld, ppg, gp);
    float X, Y, Z, v, w;
    to_joint(s_pose, j, pts + 3 * gp, true, &X, &Y, &Z);
    joint_gate(s_pose, j, X, Y, Z, &v, &w);
    part[t] = v * w;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < TILE; p += kThreads) {
    float s = 0.f;
    for (int j = 0; j < kJoints; ++j) s += part[p * kJoints + j];
    if (p0 + p < n_pts) {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[4 * (p0 + p) + c] = s;
    }
  }
}

// probe 1: out[gp, :] = the sum of point gp's encoding channels (its x_pts
// and, with kView, x_views row, as the bf16 values the MLP reads)
template <int TILE, bool kView>
__device__ void encode_sums(const Layout& L, const bf16* e_pts, const bf16* e_view, int n_pts,
                            int p0, float* __restrict__ out) {
  constexpr int kTpp = kThreads / TILE;
  const int p = threadIdx.x / kTpp, q = threadIdx.x & (kTpp - 1);
  float s = 0.f;
  for (int k = q; k < L.pc; k += kTpp) s += __bfloat162float(e_pts[p * pts_ld(L) + k]);
  if (kView) {
    for (int k = q; k < L.vc; k += kTpp) s += __bfloat162float(e_view[p * view_ld(L) + k]);
  }
#pragma unroll
  for (int m = 1; m < kTpp; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (p0 + p < n_pts) {
    for (int c = q; c < 4; c += kTpp) out[4 * (p0 + p) + c] = s;
  }
}

// ---------------------------------------------------------------------------
// MLP and heads on ROWS points: kThreads / ROWS threads per point in the
// heads (field.cu's 4 at ROWS 64); thread q of a point writes output
// columns q, q + kThreads / ROWS, ... (rgb 0-2, sigma 3).
// ---------------------------------------------------------------------------
template <int ROWS, bool kView>
__device__ void mlp_rows(const Layout& L, const bf16* __restrict__ W, const float* __restrict__ B,
                         const bf16* e_pts, const bf16* e_view, bf16* h, float* scratch,
                         int n_pts, int p0, float* __restrict__ out) {
  constexpr int kTpp = kThreads / ROWS;
  trunk<ROWS>(L, W, B, e_pts, h, scratch);
  const int p = threadIdx.x / kTpp, q = threadIdx.x & (kTpp - 1);
  const float alpha = row_dot<kTpp>(h + p * kHLd, W + L.w_alpha, kWidth) + B[L.b_alpha];
  if (kView) {  // feature head, then the 128-wide view head into h[:, :128]
    dense<2, ROWS>(nullptr, 0, 0, h, kHLd, kWidth, W + L.w_feat, B + L.b_feat, false, h,
                   scratch);
    dense<1, ROWS>(h, kHLd, kWidth, e_view, view_ld(L), L.vcp, W + L.w_view, B + L.b_view,
                   true, h, scratch);
  }
  const int gp = p0 + p;
  for (int c = q; c < 4; c += kTpp) {
    float v = c == 3 ? alpha : 0.f;
    if (kView && c < 3) {
      const bf16* row = h + p * kHLd;
      const bf16* wr = W + L.w_rgb + c * kViewWidth;
      v = B[L.b_rgb + c];
      for (int k = 0; k < kViewWidth; ++k) v += __bfloat162float(row[k]) * __bfloat162float(wr[k]);
    }
    if (gp < n_pts) out[4 * gp + c] = v;
  }
}

// n_sub sub-tiles of SUB rows in turn, on the block's encodings
template <int SUB, bool kView>
__device__ void mlp_sub_tiles(int n_sub, const Layout& L, const bf16* __restrict__ W,
                              const float* __restrict__ B, const bf16* e_pts, const bf16* e_view,
                              bf16* h, float* scratch, int n_pts, int p0,
                              float* __restrict__ out) {
  for (int i = 0; i < n_sub; ++i) {
    mlp_rows<SUB, kView>(L, W, B, e_pts + i * SUB * pts_ld(L), e_view + i * SUB * view_ld(L), h,
                         scratch, n_pts, p0 + i * SUB, out);
  }
}

template <int TILE, bool kView>
__global__ void __launch_bounds__(kThreads, TILE <= 32 ? 2 : 1)
    field_variant_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, int n_pts,
                         const float* __restrict__ poses, int n_pose, int ppg, const Layout L,
                         const bf16* __restrict__ W, const float* __restrict__ B, int enc,
                         int probe, int halves, float* __restrict__ out) {
  static_assert(TILE % 16 == 0 && kThreads % TILE == 0, "TILE: 16-row MMA tiles, whole heads");
  static_assert((kView ? 2 : 1) * TILE * kFrame * sizeof(float) <=
                    sizeof(bf16) * TILE * kHLd + sizeof(float) * kWarps * kScratch,
                "mxenc's frames must fit in the activation tile and the scratch");
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_pose = reinterpret_cast<float*>(smem);
  bf16* e_pts = reinterpret_cast<bf16*>(smem + kPoseBytes);
  bf16* e_view = e_pts + TILE * pts_ld(L);
  bf16* h = e_view + (kView ? TILE * view_ld(L) : 0);
  float* scratch = reinterpret_cast<float*>(h + TILE * kHLd);
  float* work = reinterpret_cast<float*>(h);  // h and the scratch, free until the MLP

  // a block within one pose group keeps its row in shared memory; else each
  // point reads its group's row of the table
  const int p0 = blockIdx.x * TILE;
  const int g0 = p0 / ppg, g1 = (min(p0 + TILE, n_pts) - 1) / ppg;
  const float* pose = poses;
  int pose_ld = n_pose;
  if (g0 == g1) {
    for (int i = threadIdx.x; i < n_pose; i += kThreads) {
      s_pose[i] = poses[static_cast<size_t>(g0) * n_pose + i];
    }
    pose = s_pose;
    pose_ld = 0;
  }
  __syncthreads();
  if (probe == kProbeGates) {
    gate_sums<TILE>(pts, n_pts, p0, pose, pose_ld, ppg, work, out);
    return;
  }
  if (enc == kEncBase) {
    encode_tile<kView, TILE>(pts, dirs, n_pts, 1, p0, pose, L, e_pts, e_view, pose_ld, ppg);
  } else {
    if (enc == kEncMx) {
      transform_mx<TILE, kView>(pts, dirs, n_pts, p0, pose, pose_ld, ppg, work);
      __syncthreads();
    }
    encode_variant<kView, TILE>(pts, dirs, n_pts, p0, pose, pose_ld, ppg, L, enc == kEncBf16,
                                enc == kEncMx ? work : nullptr, e_pts, e_view);
  }
  __syncthreads();
  if (probe == kProbeEncode) {
    encode_sums<TILE, kView>(L, e_pts, e_view, n_pts, p0, out);
    return;
  }
  if (halves == 1) {
    mlp_sub_tiles<TILE, kView>(1, L, W, B, e_pts, e_view, h, scratch, n_pts, p0, out);
  } else if (halves == 2) {
    if constexpr (TILE / 2 >= 16) {
      mlp_sub_tiles<TILE / 2, kView>(2, L, W, B, e_pts, e_view, h, scratch, n_pts, p0, out);
    }
  } else if constexpr (TILE / 4 >= 16) {
    mlp_sub_tiles<TILE / 4, kView>(4, L, W, B, e_pts, e_view, h, scratch, n_pts, p0, out);
  }
}

struct VariantCall {
  const float *pts, *dirs, *poses;
  int n_pts, n_pose, ppg;
  Layout L;
  const bf16* w;
  const float* b;
  int enc, probe, halves;
  float* out;
  cudaStream_t stream;
};

template <int TILE, bool kView>
static cudaError_t launch_variant(const VariantCall& c) {
  const size_t smem = smem_bytes<TILE>(c.L, kView);
  const cudaError_t e = set_smem(field_variant_kernel<TILE, kView>, smem);
  if (e != cudaSuccess) return e;
  const int grid = (c.n_pts + TILE - 1) / TILE;
  field_variant_kernel<TILE, kView><<<grid, kThreads, smem, c.stream>>>(
      c.pts, c.dirs, c.n_pts, c.poses, c.n_pose, c.ppg, c.L, c.w, c.b, c.enc, c.probe, c.halves,
      c.out);
  return cudaGetLastError();
}

// Resident blocks per SM of one instantiation at this layout; 0 when its
// shared memory exceeds what the card lets a block opt in to.
template <int TILE, bool kView>
static cudaError_t blocks_per_sm(const Layout& L, int* blocks) {
  const size_t smem = smem_bytes<TILE>(L, kView);
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  *blocks = 0;
  if (smem > static_cast<size_t>(max_smem)) return cudaSuccess;
  e = set_smem(field_variant_kernel<TILE, kView>, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, field_variant_kernel<TILE, kView>,
                                                       kThreads, smem);
}

// The instantiation of (tile, with_view): fn<TILE, kView>(args...); an
// invalid-value error for another tile.
#define POSEGEN_VARIANT_DISPATCH(tile, view, fn, ...)                      \
  ((tile) == 32    ? ((view) ? fn<32, true>(__VA_ARGS__) : fn<32, false>(__VA_ARGS__))   \
   : (tile) == 64  ? ((view) ? fn<64, true>(__VA_ARGS__) : fn<64, false>(__VA_ARGS__))   \
   : (tile) == 128 ? ((view) ? fn<128, true>(__VA_ARGS__) : fn<128, false>(__VA_ARGS__)) \
                   : cudaErrorInvalidValue)

}  // namespace posegen

extern "C" {

// (n_pts, 4) raw [r, g, b, sigma] (rgb zero when density_only), or a probe's
// per-point sum in all four columns. pts and dirs (n_pts, 3) f32, one
// direction per point; poses (n_groups, n_pose) f32, one pack_pose row per
// pose group (posegen_tpu_torch/kernels/field.py pack_poses), group g owning
// points [g * n_pts / n_groups, (g + 1) * n_pts / n_groups); w bf16 and b f32
// packed per `layout`. tile 32, 64 or 128; enc 0 / 1 / 2 (base, bf16enc,
// mxenc); probe 0 / 1 / 2 (none, encode sums, gate sums); halves 1, 2 or 4,
// only with enc 1 and a tile that is a multiple of 16 * halves. Returns a
// cudaError_t code (0 = launched).
int posegen_field_variant(const float* pts, const float* dirs, int n_pts, const float* poses,
                          int n_groups, int n_pose, const int* layout, int n_layout,
                          const void* w, const float* b, float* out, int tile, int density_only,
                          int enc, int probe, int halves, void* stream) {
  using namespace posegen;
  VariantCall c{pts, dirs, poses, n_pts, n_pose, 0, Layout{}, static_cast<const bf16*>(w), b,
                enc, probe, halves, out, static_cast<cudaStream_t>(stream)};
  if (!read_layout(layout, n_layout, &c.L) || n_pts <= 0 || n_groups <= 0 ||
      n_pts % n_groups != 0 || n_pose != kPoseFloats + c.L.nf_kp + c.L.nf_view ||
      enc < kEncBase || enc > kEncMx || probe < kProbeNone || probe > kProbeGates ||
      (halves != 1 && halves != 2 && halves != 4) || (halves > 1 && enc != kEncBf16) ||
      tile % (16 * halves) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  c.ppg = n_pts / n_groups;
  return static_cast<int>(POSEGEN_VARIANT_DISPATCH(tile, !density_only, launch_variant, c));
}

// *blocks = resident blocks per SM of the (tile, density_only) kernel at
// this layout, 0 when it does not fit in shared memory. Returns a
// cudaError_t code.
int posegen_field_variant_blocks(int tile, int density_only, const int* layout, int n_layout,
                                 int* blocks) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || blocks == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(POSEGEN_VARIANT_DISPATCH(tile, !density_only, blocks_per_sm, L, blocks));
}

}  // extern "C"
