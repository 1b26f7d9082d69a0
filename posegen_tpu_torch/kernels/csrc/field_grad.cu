// Training kernels of the fused field for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
//   posegen_field_stash  replaces posegen_tpu/kernels/field_grad.py::
//                        _field_fwd_stash_kernel: the field kernel's full
//                        forward on grouped poses, plus its bf16 encodings
//                        written out for the backward.
//   posegen_field_bwd    replaces posegen_tpu/kernels/field_grad.py::
//                        _field_bwd_kernel: every weight and bias gradient
//                        of one net, and the view bias gradient per pose
//                        group (the chain rule to framecodes runs on the
//                        host); with the forward's inputs, also its
//                        input_grads branch (_encode_backward): d_pts,
//                        d_dirs per ray and d_rot / d_trn per pose group.
//
// Bound on an H100: operations. The forward is 1,723,648 FLOP per point and
// the backward 5,167,104 (the JAX kernels' counts), against 2,160 bytes of
// stash per point written and read back; at 989 TFLOP/s bf16 dense that is
// 1.74 ns and 5.22 ns per point against 0.64 ns of stash traffic at
// 3.35 TB/s.
//
// The TPU kernel sums every weight gradient into output blocks that stay
// resident across a grid that runs in order. Hopper blocks run concurrently
// in no order, and one net's gradients (~0.6 M floats) fit no block's shared
// memory, so the backward is split in two deterministic passes:
//   (a) field_bwd_tile_kernel: one block per 64 points reloads the stash,
//       recomputes trunk and heads (the forward's own device code, so the
//       activations are the forward's), and backprops the output cotangent
//       through heads and trunk with the W^T products on the tensor cores.
//       It writes each layer's input activation and pre-activation
//       cotangent to a bf16 workspace (the JAX kernel casts both operands
//       of every weight-gradient product to bf16, so nothing is lost), and
//       the tile's bias-gradient column sums in f32.
//   (b) wgrad_gemm_kernel: dW = G^T H over the point axis, split in a fixed
//       number of point ranges whose partial products are summed in a fixed
//       order by wgrad_reduce_kernel; bias and view-bias sums likewise. Two
//       launches on the same inputs give bit-identical gradients.
//   (c) field_bwd_input_kernel (input gradients only): one block per 64
//       points reads layer 0's, the skip consumer's and the view layer's
//       pre-activation cotangents from (a)'s workspace, forms the encodings'
//       cotangents g_e_pts = gz0 W0 + gz5 W5[:, :pc] and g_e_view =
//       gzv Wv[:, 256:] on the tensor cores (bf16 operands, f32 sums, as
//       the JAX kernel's _mm_tn), recomputes the encode from pts, dirs and
//       the point's pose row in f32, and runs the encode's chain rule per
//       (point, joint). d_pts is written per point; d_dirs per point, then
//       ray_sum_kernel sums each ray's samples in order; d_rot / d_trn as
//       per-tile partials for each pose group the tile touches, summed in
//       tile order by pose_reduce_kernel. No atomics: two launches agree bit
//       for bit, and passes (a) and (b) are the weights-only launch's own.
//       Bound: 608,256 FLOP per point of products (2 (256 pc + 256 pc +
//       128 vcp) at multires 7 / 4) against ~1.3 KB of workspace reads, so
//       operations at ~0.6 ns per point; the encode's chain rule adds ~150
//       transcendental and ~3,000 FMA per point on the CUDA cores.

#include "field.cuh"

namespace posegen {

// ---------------------------------------------------------------------------
// Kernel 3: the field kernel's full forward + the stashed encodings
// ---------------------------------------------------------------------------

// The body of field.cu's full field kernel on grouped poses: point p reads
// pose row p / ppg and view bias row p / vppg (one row when vb.ld == 0). Its
// raw equals posegen_field's on a single group bit for bit.
__global__ void __launch_bounds__(kThreads, 1)
    field_stash_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, int n_pts,
                       int spr, const float* __restrict__ poses, int pose_ld, int ppg,
                       const Layout L, const bf16* __restrict__ W, const float* __restrict__ B,
                       const float* __restrict__ bview, RowBias vb, float* __restrict__ out,
                       bf16* __restrict__ ep_out, bf16* __restrict__ ev_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* e_pts = reinterpret_cast<bf16*>(smem + kPoseBytes);
  bf16* e_view = e_pts + kTile * pts_ld(L);
  bf16* h = e_view + kTile * view_ld(L);
  float* scratch = reinterpret_cast<float*>(h + kTile * kHLd);

  const int p0 = blockIdx.x * kTile;
  encode_tile<true>(pts, dirs, n_pts, spr, p0, poses, L, e_pts, e_view, pose_ld, ppg);
  __syncthreads();

  // the stash: each row pc / 8 and vc / 8 16-byte vectors, rows < n_pts
  const int rows = min(kTile, n_pts - p0);
  const int vp = L.pc / 8, vv = L.vc / 8;
  for (int t = threadIdx.x; t < rows * vp; t += kThreads) {
    const int r = t / vp, c = t - r * vp;
    reinterpret_cast<uint4*>(ep_out + static_cast<size_t>(p0 + r) * L.pc)[c] =
        reinterpret_cast<const uint4*>(e_pts + r * pts_ld(L))[c];
  }
  for (int t = threadIdx.x; t < rows * vv; t += kThreads) {
    const int r = t / vv, c = t - r * vv;
    reinterpret_cast<uint4*>(ev_out + static_cast<size_t>(p0 + r) * L.vc)[c] =
        reinterpret_cast<const uint4*>(e_view + r * view_ld(L))[c];
  }

  const int p = threadIdx.x >> 2, q = threadIdx.x & 3;
  const int gp = p0 + p;
  trunk(L, W, B, e_pts, h, scratch);
  const float alpha = row_dot(h + p * kHLd, W + L.w_alpha, kWidth) + B[L.b_alpha];
  dense<2>(nullptr, 0, 0, h, kHLd, kWidth, W + L.w_feat, B + L.b_feat, false, h, scratch);
  vb.p0 = p0;
  dense<1>(h, kHLd, kWidth, e_view, view_ld(L), L.vcp, W + L.w_view, bview, true, h, scratch,
           vb);
  float v = alpha;
  if (q < 3) {
    const bf16* row = h + p * kHLd;
    const bf16* wr = W + L.w_rgb + q * kViewWidth;
    v = B[L.b_rgb + q];
    for (int k = 0; k < kViewWidth; ++k) v += __bfloat162float(row[k]) * __bfloat162float(wr[k]);
  }
  if (gp < n_pts) out[4 * gp + q] = v;
}

// ---------------------------------------------------------------------------
// Kernel 4 (a): per-tile recompute + backprop into the workspace
// ---------------------------------------------------------------------------

// Workspace regions; every per-point region has p_pad = whole tiles of rows.
struct Workspace {
  bf16* hs;          // (depth, p_pad, 256) trunk layer outputs (post-ReLU)
  bf16* feat;        // (p_pad, 256) feature head output
  bf16* hv;          // (p_pad, 128) view layer output (post-ReLU)
  bf16* gz;          // (depth, p_pad, 256) trunk pre-activation cotangents
  bf16* gfeat;       // (p_pad, 256) feature head cotangent
  bf16* gzv;         // (p_pad, 128) view layer pre-activation cotangent
  bf16* ghead;       // (p_pad, 16) [g_alpha | g_r g_g g_b | 0 ...]
  float* gzv32;      // (p_pad, 128) gzv in f32, for the view bias sums
  float* bias_part;  // (n_tiles, n_bias) per-tile bias column sums
  float* gemm_part;  // (gemm tiles, splits, 64, 64) split partial products
  float* vb_part;    // (view groups, view chunks, 128)
  float* d_dirs_pt;  // (p_pad, 3) d_dirs per point (input gradients only)
  float* pose_part;  // (n_tiles, pose slots, 24 x 12) d_rot | d_trn per tile and group
  size_t p_pad;
};

// Bias columns of bias_part: depth x 256 trunk | 256 feature | alpha | rgb x 3
__host__ __device__ inline int n_bias(const Layout& L) { return L.depth * kWidth + kWidth + 4; }

constexpr int kHeadLd = 16;
constexpr int kVbRows = 256;  // rows per view-bias chunk

using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// acc[kTile, NT*16 per warp] += A[kTile, K] @ W[K, :] with W row-major (k, n)
// at W[k * ldw + n]: the W^T products of the backward (W is stored (out, in),
// so its rows are the forward's outputs).
template <int NT>
__device__ __forceinline__ void gemm_segment_t(FragC (&acc)[kMTiles][NT], const bf16* A, int lda,
                                               int K, const bf16* __restrict__ W, int ldw,
                                               int n0) {
  FragBr b[NT], bn[NT];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) wmma::load_matrix_sync(b[jn], W + n0 + 16 * jn, ldw);
  for (int k = 0; k < K; k += 16) {
    if (k + 16 < K) {
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
        wmma::load_matrix_sync(bn[jn], W + static_cast<size_t>(k + 16) * ldw + n0 + 16 * jn,
                               ldw);
      }
    }
#pragma unroll
    for (int im = 0; im < kMTiles; ++im) {
      FragA a;
      wmma::load_matrix_sync(a, A + im * 16 * lda + k, lda);
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) wmma::mma_sync(acc[im][jn], a, b[jn], acc[im][jn]);
    }
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) b[jn] = bn[jn];
  }
}

// Where one backward product's 256-wide result goes.
struct GradOut {
  const bf16* mask;      // ReLU mask source: keep where mask[r * 256 + n] > 0; or none
  const float* g;        // with w_alpha: add bf16(g[4 r + 3]) * w_alpha[n] (alpha head)
  const bf16* w_alpha;
  bf16* global;          // (kTile rows, 256) workspace rows of this tile
  float* bias_part;      // 256 bias column sums of this tile
};

// out[kTile, 256] = A[kTile, K] @ W (row-major view), then + the alpha head's
// outer product, then the ReLU mask; the f32 column sums go to the bias
// partials and the bf16 values to `out` (shared, row stride kHLd, may alias
// A) and to the workspace.
__device__ void dense_t(const bf16* A, int lda, int K, const bf16* __restrict__ W, int ldw,
                        bf16* out, float* scratch, const GradOut go) {
  constexpr int NT = 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = warp * NT * 16;
  FragC acc[kMTiles][NT];
#pragma unroll
  for (int im = 0; im < kMTiles; ++im) {
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) wmma::fill_fragment(acc[im][jn], 0.f);
  }
  gemm_segment_t<NT>(acc, A, lda, K, W, ldw, n0);
  __syncthreads();
  float* sc = scratch + warp * kScratch;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int n = n0 + 16 * jn + (lane & 15);
    float cs = 0.f;
#pragma unroll
    for (int im = 0; im < kMTiles; ++im) {
      wmma::store_matrix_sync(sc, acc[im][jn], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = 16 * im + (e >> 4);
        float v = sc[e];
        if (go.w_alpha != nullptr) {
          v += __bfloat162float(__float2bfloat16(go.g[4 * r + 3])) *
               __bfloat162float(go.w_alpha[n]);
        }
        if (go.mask != nullptr && !(__bfloat162float(go.mask[r * kWidth + n]) > 0.f)) v = 0.f;
        cs += v;
        const bf16 vb = __float2bfloat16(v);
        out[r * kHLd + n] = vb;
        go.global[r * kWidth + n] = vb;
      }
      __syncwarp();
    }
    // lanes l and l + 16 hold the two halves of column n's rows
    cs += __shfl_xor_sync(0xffffffffu, cs, 16);
    if (lane < 16) go.bias_part[n] = cs;
  }
  __syncthreads();
}

// kTile rows of `width` bf16 from src (row stride src_ld) to dst (row stride
// dst_ld): shared to workspace and back.
__device__ __forceinline__ void copy_rows(const bf16* src, int src_ld, bf16* dst, int dst_ld,
                                          int width) {
  const int nv = width / 8;
  for (int t = threadIdx.x; t < kTile * nv; t += kThreads) {
    const int r = t / nv, c = t - r * nv;
    reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) * dst_ld)[c] =
        reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * src_ld)[c];
  }
}

__host__ __device__ inline size_t bwd_smem_bytes(const Layout& L) {
  return sizeof(bf16) * kTile * (pts_ld(L) + view_ld(L) + 2 * kHLd) +
         sizeof(float) * (kWarps * kScratch + kTile * 4);
}

__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_tile_kernel(int n_pts, const Layout L, const bf16* __restrict__ W,
                          const float* __restrict__ B, const float* __restrict__ bview,
                          RowBias vb, const float* __restrict__ g, const bf16* __restrict__ ep,
                          const bf16* __restrict__ ev, const Workspace S) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldp = pts_ld(L), ldv = view_ld(L);
  bf16* e_pts = reinterpret_cast<bf16*>(smem);
  bf16* e_view = e_pts + kTile * ldp;
  bf16* h = e_view + kTile * ldv;
  bf16* gb = h + kTile * kHLd;
  float* scratch = reinterpret_cast<float*>(gb + kTile * kHLd);
  float* s_g = scratch + kWarps * kScratch;

  const int p0 = blockIdx.x * kTile;
  const size_t row0 = p0;
  const size_t P = S.p_pad;
  float* bias_part = S.bias_part + static_cast<size_t>(blockIdx.x) * n_bias(L);

  // the stashed encodings (rows past the last point repeat it, as the
  // forward's encode does) and the output cotangent (zero past it)
  const int vp = L.pc / 8, vv = L.vc / 8;
  for (int t = threadIdx.x; t < kTile * vp; t += kThreads) {
    const int r = t / vp, c = t - r * vp;
    const size_t src = min(p0 + r, n_pts - 1);
    reinterpret_cast<uint4*>(e_pts + r * ldp)[c] =
        reinterpret_cast<const uint4*>(ep + src * L.pc)[c];
  }
  for (int t = threadIdx.x; t < kTile * vv; t += kThreads) {
    const int r = t / vv, c = t - r * vv;
    const size_t src = min(p0 + r, n_pts - 1);
    reinterpret_cast<uint4*>(e_view + r * ldv)[c] =
        reinterpret_cast<const uint4*>(ev + src * L.vc)[c];
  }
  const int npad = L.vcp - L.vc;
  for (int t = threadIdx.x; t < kTile * npad; t += kThreads) {
    e_view[(t / npad) * ldv + L.vc + t % npad] = __float2bfloat16(0.f);
  }
  for (int t = threadIdx.x; t < kTile * 4; t += kThreads) {
    s_g[t] = p0 + t / 4 < n_pts ? g[4 * row0 + t] : 0.f;
  }
  __syncthreads();

  // ---- forward recompute (the forward kernel's device code) -------------
  for (int i = 0; i < L.depth; ++i) {
    const bool first = i == 0;
    const bool cat = !first && i - 1 == L.skip;
    dense<2>(cat ? e_pts : nullptr, ldp, cat ? L.pc : 0, first ? e_pts : h, first ? ldp : kHLd,
             first ? L.pc : kWidth, W + L.w_layer[i], B + L.b_layer[i], true, h, scratch);
    copy_rows(h, kHLd, S.hs + (i * P + row0) * kWidth, kWidth, kWidth);
  }
  dense<2>(nullptr, 0, 0, h, kHLd, kWidth, W + L.w_feat, B + L.b_feat, false, h, scratch);
  copy_rows(h, kHLd, S.feat + row0 * kWidth, kWidth, kWidth);
  vb.p0 = p0;
  dense<1>(h, kHLd, kWidth, e_view, ldv, L.vcp, W + L.w_view, bview, true, h, scratch, vb);
  copy_rows(h, kHLd, S.hv + row0 * kViewWidth, kViewWidth, kViewWidth);

  // ---- heads -------------------------------------------------------------
  // rgb head: g_hv = g_rgb @ W_rgb (bf16 operands), masked where hv == 0
  const bf16* wr = W + L.w_rgb;
  for (int t = threadIdx.x; t < kTile * kViewWidth; t += kThreads) {
    const int r = t / kViewWidth, c = t % kViewWidth;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      s += __bfloat162float(__float2bfloat16(s_g[4 * r + q])) *
           __bfloat162float(wr[q * kViewWidth + c]);
    }
    const float gzv = __bfloat162float(h[r * kHLd + c]) > 0.f ? s : 0.f;
    const bf16 gzb = __float2bfloat16(gzv);
    gb[r * kHLd + c] = gzb;
    S.gzv[(row0 + r) * kViewWidth + c] = gzb;
    S.gzv32[(row0 + r) * kViewWidth + c] = gzv;
  }
  for (int t = threadIdx.x; t < kTile * kHeadLd; t += kThreads) {
    const int r = t / kHeadLd, c = t % kHeadLd;
    const float v = c == 0 ? s_g[4 * r + 3] : c < 4 ? s_g[4 * r + c - 1] : 0.f;
    S.ghead[(row0 + r) * kHeadLd + c] = __float2bfloat16(v);
  }
  if (threadIdx.x < 4) {  // alpha, then r, g, b: bias sums in f32
    const int q = threadIdx.x == 0 ? 3 : threadIdx.x - 1;
    float s = 0.f;
    for (int r = 0; r < kTile; ++r) s += s_g[4 * r + q];
    bias_part[L.depth * kWidth + kWidth + threadIdx.x] = s;
  }
  __syncthreads();

  // feature head: g_feat = g_zv @ W_view[:, :256]
  dense_t(gb, kHLd, kViewWidth, W + L.w_view, kWidth + L.vcp, gb, scratch,
          GradOut{nullptr, nullptr, nullptr, S.gfeat + row0 * kWidth,
                  bias_part + L.depth * kWidth});
  // trunk output: g_feat @ W_feat + g_alpha (x) w_alpha, masked by its ReLU
  const int last = L.depth - 1;
  dense_t(gb, kHLd, kWidth, W + L.w_feat, kWidth, gb, scratch,
          GradOut{S.hs + (last * P + row0) * kWidth, s_g, W + L.w_alpha,
                  S.gz + (last * P + row0) * kWidth, bias_part + last * kWidth});

  // ---- trunk, reversed: layer i's input cotangent (the h part of the skip
  // consumer's [x_pts | h] input), masked by layer i - 1's ReLU ----------
  for (int i = last; i >= 1; --i) {
    const int off = i - 1 == L.skip ? L.pc : 0;
    dense_t(gb, kHLd, kWidth, W + L.w_layer[i] + off, L.layer_in_of(i), gb, scratch,
            GradOut{S.hs + ((i - 1) * P + row0) * kWidth, nullptr, nullptr,
                    S.gz + ((i - 1) * P + row0) * kWidth, bias_part + (i - 1) * kWidth});
  }
}

// ---------------------------------------------------------------------------
// Kernel 4 (b): weight gradients dW = G^T H over the point axis
// ---------------------------------------------------------------------------

// One product: rows [m_lo, m_hi) of G^T H land at out[(m - m_lo) * ldo + n].
// G (n_pts, lda) has ma valid columns and H (n_pts, ldb) nb; both widths are
// multiples of 8 (whole 16-byte vectors).
struct GemmJob {
  const bf16* a;
  const bf16* b;
  float* out;
  int lda, ma, ldb, nb, ldo, m_lo, m_hi, tiles_n, tile0;
};

constexpr int kMaxJobs = 24;
constexpr int kGT = 64;           // output tile edge
constexpr int kGK = 32;           // points per staged step
constexpr int kGLd = kGT + 8;     // shared row stride (bf16)
constexpr int kGThreads = 128;
constexpr int kMaxSplits = 16;

struct GemmJobs {
  GemmJob job[kMaxJobs];
  float* part;
  int n_jobs, n_tiles, splits, chunk, n_pts;
};

__device__ __forceinline__ const GemmJob& find_job(const GemmJobs& J, int tile) {
  int j = 0;
  while (j + 1 < J.n_jobs && J.job[j + 1].tile0 <= tile) ++j;
  return J.job[j];
}

using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;

__global__ void __launch_bounds__(kGThreads)
    wgrad_gemm_kernel(const __grid_constant__ GemmJobs J) {
  __shared__ __align__(128) bf16 sA[kGK * kGLd];
  __shared__ __align__(128) bf16 sB[kGK * kGLd];
  const int tile = blockIdx.x, split = blockIdx.y;
  const GemmJob& jb = find_job(J, tile);
  const int t = tile - jb.tile0;
  const int m0 = (t / jb.tiles_n) * kGT, n0 = (t % jb.tiles_n) * kGT;
  const int k_begin = split * J.chunk;
  const int k_end = min(J.n_pts, k_begin + J.chunk);
  const int warp = threadIdx.x >> 5;

  FragC acc[4];
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) wmma::fill_fragment(acc[jn], 0.f);
  // each thread stages 2 vectors of G and 2 of H per step; the next step's
  // vectors load while this one multiplies
  uint4 va[2], vb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = threadIdx.x + u * kGThreads;
      const int r = v >> 3, c = (v & 7) * 8;
      const int p = k0 + r;
      va[u] = make_uint4(0, 0, 0, 0);
      vb[u] = make_uint4(0, 0, 0, 0);
      if (p < k_end) {
        if (m0 + c < jb.ma) {
          va[u] = *reinterpret_cast<const uint4*>(jb.a + static_cast<size_t>(p) * jb.lda + m0 + c);
        }
        if (n0 + c < jb.nb) {
          vb[u] = *reinterpret_cast<const uint4*>(jb.b + static_cast<size_t>(p) * jb.ldb + n0 + c);
        }
      }
    }
  };
  if (k_begin < k_end) load(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kGK) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int v = threadIdx.x + u * kGThreads;
      const int r = v >> 3, c = (v & 7) * 8;
      *reinterpret_cast<uint4*>(sA + r * kGLd + c) = va[u];
      *reinterpret_cast<uint4*>(sB + r * kGLd + c) = vb[u];
    }
    __syncthreads();
    if (k0 + kGK < k_end) load(k0 + kGK);
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      FragAc a;  // (m, k) = G[k][m]: the staged G rows read column-major
      wmma::load_matrix_sync(a, sA + kk * kGLd + 16 * warp, kGLd);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        FragBr b;
        wmma::load_matrix_sync(b, sB + kk * kGLd + 16 * jn, kGLd);
        wmma::mma_sync(acc[jn], a, b, acc[jn]);
      }
    }
    __syncthreads();
  }
  float* part = J.part + (static_cast<size_t>(tile) * J.splits + split) * kGT * kGT;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    wmma::store_matrix_sync(part + 16 * warp * kGT + 16 * jn, acc[jn], kGT, wmma::mem_row_major);
  }
}

// Sum each tile's split partials in split order into the gradient buffer.
__global__ void wgrad_reduce_kernel(const __grid_constant__ GemmJobs J) {
  const int tile = blockIdx.x;
  const GemmJob& jb = find_job(J, tile);
  const int t = tile - jb.tile0;
  const int m0 = (t / jb.tiles_n) * kGT, n0 = (t % jb.tiles_n) * kGT;
  const float* part = J.part + static_cast<size_t>(tile) * J.splits * kGT * kGT;
  for (int e = threadIdx.x; e < kGT * kGT; e += blockDim.x) {
    const int m = m0 + e / kGT, n = n0 + e % kGT;
    if (m < jb.m_lo || m >= jb.m_hi || n >= jb.nb) continue;
    float s = 0.f;
    for (int sp = 0; sp < J.splits; ++sp) s += part[static_cast<size_t>(sp) * kGT * kGT + e];
    jb.out[static_cast<size_t>(m - jb.m_lo) * jb.ldo + n] = s;
  }
}

// Bias gradients: the tiles' column sums, summed in tile order.
__global__ void bias_reduce_kernel(const float* __restrict__ part, int n_tiles, const Layout L,
                                   float* __restrict__ d_b) {
  const int nb = n_bias(L);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nb) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += part[static_cast<size_t>(t) * nb + c];
  int dst;
  if (c < L.depth * kWidth) {
    dst = L.b_layer[c / kWidth] + c % kWidth;
  } else {
    const int r = c - L.depth * kWidth;
    dst = r < kWidth ? L.b_feat + r : r == kWidth ? L.b_alpha : L.b_rgb + (r - kWidth - 1);
  }
  d_b[dst] = s;
}

// View bias gradient per group: chunks of kVbRows rows, then the chunks in
// order (rows of group g: [g * vppg, min((g + 1) * vppg, n_pts))).
__global__ void vbias_part_kernel(const float* __restrict__ gzv32, int n_pts, int vppg, int nck,
                                  float* __restrict__ vb_part) {
  const int g = blockIdx.x, k = blockIdx.y, c = threadIdx.x;
  const int r0 = g * vppg + k * kVbRows;
  const int r1 = min(min(r0 + kVbRows, (g + 1) * vppg), n_pts);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += gzv32[static_cast<size_t>(r) * kViewWidth + c];
  vb_part[(static_cast<size_t>(g) * nck + k) * kViewWidth + c] = s;
}

__global__ void vbias_sum_kernel(const float* __restrict__ vb_part, int nck,
                                 float* __restrict__ d_bview) {
  const int g = blockIdx.x, c = threadIdx.x;
  float s = 0.f;
  for (int k = 0; k < nck; ++k) s += vb_part[(static_cast<size_t>(g) * nck + k) * kViewWidth + c];
  d_bview[g * kViewWidth + c] = s;
}

// ---------------------------------------------------------------------------
// Kernel 4 (c): input gradients through the encode (input_grads branch)
// ---------------------------------------------------------------------------

constexpr int kPoseGrad = kJoints * 12;  // per group: d_rot (24 x 9) | d_trn (24 x 3), (j, e)
constexpr int kState = 6;                // floats per (point, joint) of the chain rule
constexpr int kViewLd = kViewWidth + kPad;

// Shared memory of pass (c): [gz0 | gz5 | g_e_pts f32] then, reused,
// [gzv | g_e_view f32]; the per-(point, joint) state; the points' pts, dirs.
__host__ __device__ inline size_t input_region_bytes(const Layout& L) {
  const size_t kp = sizeof(bf16) * 2 * kTile * kHLd + sizeof(float) * kTile * L.pc;
  const size_t view = sizeof(bf16) * kTile * kViewLd + sizeof(float) * kTile * L.vcp;
  return kp > view ? kp : view;
}

__host__ __device__ inline size_t input_smem_bytes(const Layout& L) {
  return input_region_bytes(L) + sizeof(float) * (kTile * kJoints * kState + kTile * 6);
}

// out[kTile, ncols] f32 (row stride ldo) = sum over segments of A[kTile, 256
// or 128] @ W[:, col0 ...] (W row-major (k, n), row stride ldw): each warp
// takes every kWarps-th 16-column tile.
struct Segment {
  const bf16* a;
  int lda, K;
  const bf16* w;
  int ldw;
};

template <int NSeg>
__device__ void input_products(const Segment (&seg)[NSeg], int ncols, float* out, int ldo) {
  const int warp = threadIdx.x >> 5;
  for (int ct = warp; ct < ncols / 16; ct += kWarps) {
    FragC acc[kMTiles][1];
#pragma unroll
    for (int im = 0; im < kMTiles; ++im) wmma::fill_fragment(acc[im][0], 0.f);
#pragma unroll
    for (int q = 0; q < NSeg; ++q) {
      gemm_segment_t<1>(acc, seg[q].a, seg[q].lda, seg[q].K, seg[q].w, seg[q].ldw, 16 * ct);
    }
#pragma unroll
    for (int im = 0; im < kMTiles; ++im) {
      wmma::store_matrix_sync(out + 16 * im * ldo + 16 * ct, acc[im][0], ldo,
                              wmma::mem_row_major);
    }
  }
}

// The encode of point gp at joint j, as encode_tile computes it (f32).
struct JointFrame {
  float X, Y, Z, v, sig, w, inv_v;
};

__device__ __forceinline__ JointFrame joint_frame(const float* s_pose, int j, float x, float y,
                                                  float z) {
  const float* R = s_pose + 9 * j;
  const float* T = s_pose + kJoints * 9 + 3 * j;
  JointFrame f;
  f.X = R[0] * x + R[1] * y + R[2] * z + T[0];
  f.Y = R[3] * x + R[4] * y + R[5] * z + T[1];
  f.Z = R[6] * x + R[7] * y + R[8] * z + T[2];
  f.v = sqrtf(f.X * f.X + f.Y * f.Y + f.Z * f.Z);
  f.sig = 1.f / (1.f + expf(-(s_pose[kJoints * 13] * (f.v - s_pose[kJoints * 12 + j]))));
  f.w = 1.f - f.sig;
  f.inv_v = 1.f / fmaxf(f.v, 1e-12f);
  return f;
}

__global__ void __launch_bounds__(kThreads, 1)
    field_bwd_input_kernel(int n_pts, int spr, const float* __restrict__ pts,
                           const float* __restrict__ dirs, const float* __restrict__ poses,
                           int pose_ld, int ppg, int n_slots, const Layout L,
                           const bf16* __restrict__ W, const Workspace S,
                           float* __restrict__ pose_part, float* __restrict__ d_pts,
                           float* __restrict__ d_dirs_pt) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t region = input_region_bytes(L);
  bf16* a0 = reinterpret_cast<bf16*>(smem);  // kp products: gz0, gz5 tiles
  bf16* a5 = a0 + kTile * kHLd;
  float* g_ep = reinterpret_cast<float*>(a5 + kTile * kHLd);
  bf16* av = reinterpret_cast<bf16*>(smem);  // view product: gzv tile
  float* g_ev = reinterpret_cast<float*>(av + kTile * kViewLd);
  float* state = reinterpret_cast<float*>(smem + region);  // (kTile, 24, kState)
  float* s_x = state + kTile * kJoints * kState;           // (kTile, 3) pts
  float* s_d = s_x + kTile * 3;                            // (kTile, 3) dirs

  const int p0 = blockIdx.x * kTile;
  const size_t row0 = p0;
  const size_t P = S.p_pad;
  const int skip_layer = L.skip >= 0 && L.skip + 1 < L.depth ? L.skip + 1 : -1;
  const int kc = kJoints * (1 + 2 * L.nf_kp);

  for (int t = threadIdx.x; t < kTile * 3; t += kThreads) {
    const int r = t / 3, c = t - 3 * r;
    const int gp = min(p0 + r, n_pts - 1);
    s_x[t] = pts[3 * gp + c];
    s_d[t] = dirs[3 * (gp / spr) + c];
  }

  // ---- g_e_pts = gz0 @ W0 + gz5 @ W5[:, :pc] ----------------------------
  copy_rows(S.gz + row0 * kWidth, kWidth, a0, kHLd, kWidth);
  if (skip_layer >= 0) copy_rows(S.gz + (skip_layer * P + row0) * kWidth, kWidth, a5, kHLd,
                                  kWidth);
  __syncthreads();
  if (skip_layer >= 0) {
    const Segment seg[2] = {{a0, kHLd, kWidth, W + L.w_layer[0], L.pc},
                            {a5, kHLd, kWidth, W + L.w_layer[skip_layer], L.pc + kWidth}};
    input_products<2>(seg, L.pc, g_ep, L.pc);
  } else {
    const Segment seg[1] = {{a0, kHLd, kWidth, W + L.w_layer[0], L.pc}};
    input_products<1>(seg, L.pc, g_ep, L.pc);
  }
  __syncthreads();

  // ---- kp rows and reldir rows, per (point, joint) ------------------------
  for (int t = threadIdx.x; t < kTile * kJoints; t += kThreads) {
    const int p = t / kJoints, j = t - p * kJoints;
    float* st = state + t * kState;
    if (p0 + p >= n_pts) {
      for (int k = 0; k < kState; ++k) st[k] = 0.f;
      continue;
    }
    const float* s_pose = poses + static_cast<size_t>((p0 + p) / ppg) * pose_ld;
    const float* sw = s_pose + kPoseFloats;
    const JointFrame f = joint_frame(s_pose, j, s_x[3 * p], s_x[3 * p + 1], s_x[3 * p + 2]);
    const float* G = g_ep + p * L.pc;
    const float g0 = G[j];
    float g_v = g0 * f.w, g_w = g0 * f.v;
    float s, c, fr = 1.f;
    sincosf(f.v, &s, &c);
    for (int o = 0; o < L.nf_kp; ++o) {
      const float gs = G[(1 + 2 * o) * kJoints + j] * sw[o];
      const float gc = G[(2 + 2 * o) * kJoints + j] * sw[o];
      g_v += (gs * c - gc * s) * (fr * f.w);
      g_w += gs * s + gc * c;
      const float s2 = 2.f * s * c;
      c = 1.f - 2.f * s * s;
      s = s2;
      fr *= 2.f;
    }
    const float gdx = G[kc + 3 * j], gdy = G[kc + 3 * j + 1], gdz = G[kc + 3 * j + 2];
    const float g_inv = gdx * f.X + gdy * f.Y + gdz * f.Z;
    if (f.v > 1e-12f) g_v -= g_inv * f.inv_v * f.inv_v;
    st[0] = g_v;
    st[1] = g_w;
    st[2] = gdx * f.inv_v;
    st[3] = gdy * f.inv_v;
    st[4] = gdz * f.inv_v;
  }
  __syncthreads();

  // ---- g_e_view = gzv @ Wv[:, 256:256 + vcp] -----------------------------
  copy_rows(S.gzv + row0 * kViewWidth, kViewWidth, av, kViewLd, kViewWidth);
  __syncthreads();
  {
    const Segment seg[1] = {{av, kViewLd, kViewWidth, W + L.w_view + kWidth, kWidth + L.vcp}};
    input_products<1>(seg, L.vcp, g_ev, L.vcp);
  }
  __syncthreads();

  // ---- view rows, the gate, |p_local| and the direction's norm ------------
  for (int t = threadIdx.x; t < kTile * kJoints; t += kThreads) {
    const int p = t / kJoints, j = t - p * kJoints;
    if (p0 + p >= n_pts) continue;
    float* st = state + t * kState;
    const float* s_pose = poses + static_cast<size_t>((p0 + p) / ppg) * pose_ld;
    const float* sw = s_pose + kPoseFloats + L.nf_kp;
    const JointFrame f = joint_frame(s_pose, j, s_x[3 * p], s_x[3 * p + 1], s_x[3 * p + 2]);
    const float* R = s_pose + 9 * j;
    const float dx = s_d[3 * p], dy = s_d[3 * p + 1], dz = s_d[3 * p + 2];
    const float D[3] = {R[0] * dx + R[1] * dy + R[2] * dz, R[3] * dx + R[4] * dy + R[5] * dz,
                        R[6] * dx + R[7] * dy + R[8] * dz};
    const float dn_inv = rsqrtf(fmaxf(D[0] * D[0] + D[1] * D[1] + D[2] * D[2], 1e-24f));
    const float* H = g_ev + p * L.vcp;
    float g_w = st[1], g_dn[3], sq[3], cq[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float q = D[a] * dn_inv;
      const float h0 = H[3 * j + a];
      g_dn[a] = h0 * f.w;
      g_w += h0 * q;
      sincosf(q, &sq[a], &cq[a]);
    }
    float fr = 1.f;
    for (int o = 0; o < L.nf_view; ++o) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float hs = H[(1 + 2 * o) * 3 * kJoints + 3 * j + a] * sw[o];
        const float hc = H[(2 + 2 * o) * 3 * kJoints + 3 * j + a] * sw[o];
        g_dn[a] += (hs * cq[a] - hc * sq[a]) * (fr * f.w);
        g_w += hs * sq[a] + hc * cq[a];
        const float s2 = 2.f * sq[a] * cq[a];
        cq[a] = 1.f - 2.f * sq[a] * sq[a];
        sq[a] = s2;
      }
      fr *= 2.f;
    }
    const float tau = s_pose[kJoints * 13];
    const float g_v = st[0] + g_w * (-tau * f.sig * (1.f - f.sig));
    st[0] = st[2] + g_v * f.X * f.inv_v;
    st[1] = st[3] + g_v * f.Y * f.inv_v;
    st[2] = st[4] + g_v * f.Z * f.inv_v;
    const float dot = g_dn[0] * D[0] + g_dn[1] * D[1] + g_dn[2] * D[2];
    const float k3 = dn_inv * dn_inv * dn_inv;
#pragma unroll
    for (int a = 0; a < 3; ++a) st[3 + a] = g_dn[a] * dn_inv - D[a] * k3 * dot;
  }
  __syncthreads();

  // ---- d_pts and d_dirs per point: sum_j R_j^T g, joints in order ---------
  for (int t = threadIdx.x; t < kTile * 6; t += kThreads) {
    const int p = t / 6, k = t - 6 * p, c = k % 3, off = k < 3 ? 0 : 3;
    const int gp = p0 + p;
    if (gp >= n_pts) continue;
    const float* s_pose = poses + static_cast<size_t>(gp / ppg) * pose_ld;
    const float* st = state + p * kJoints * kState + off;
    float acc = 0.f;
    for (int j = 0; j < kJoints; ++j, st += kState) {
      const float* R = s_pose + 9 * j;
      acc += R[c] * st[0] + R[3 + c] * st[1] + R[6 + c] * st[2];
    }
    (k < 3 ? d_pts : d_dirs_pt)[3 * gp + c] = acc;
  }

  // ---- d_rot / d_trn: one partial per pose group the tile touches ---------
  const int last = min(p0 + kTile, n_pts) - 1;
  const int g_first = p0 / ppg;
  for (int slot = 0; slot <= last / ppg - g_first; ++slot) {
    const int g = g_first + slot;
    const int r0 = max(g * ppg, p0) - p0, r1 = min((g + 1) * ppg - 1, last) - p0;
    for (int t = threadIdx.x; t < kPoseGrad; t += kThreads) {
      const int j = t / 12, e = t - 12 * j;
      float acc = 0.f;
      if (e < 9) {  // d_rot[j][3r + c] = sum_p g_loc[r] x[c] + g_D[r] d[c]
        const int r = e / 3, c = e - 3 * r;
        for (int p = r0; p <= r1; ++p) {
          const float* st = state + (p * kJoints + j) * kState;
          acc += st[r] * s_x[3 * p + c] + st[3 + r] * s_d[3 * p + c];
        }
      } else {  // d_trn[j][r] = sum_p g_loc[r]
        for (int p = r0; p <= r1; ++p) acc += state[(p * kJoints + j) * kState + e - 9];
      }
      pose_part[(static_cast<size_t>(blockIdx.x) * n_slots + slot) * kPoseGrad + t] = acc;
    }
  }
}

// d_poses rows: group g's partials from the tiles it spans, in tile order,
// into its rot (24 x 9) and trn (24 x 3) slots.
__global__ void pose_reduce_kernel(const float* __restrict__ pose_part, int n_pts, int ppg,
                                   int n_slots, float* __restrict__ d_poses, int pose_ld) {
  const int g = blockIdx.x;
  const int t0 = g * ppg / kTile, t1 = (min((g + 1) * ppg, n_pts) - 1) / kTile;
  for (int k = threadIdx.x; k < kPoseGrad; k += blockDim.x) {
    float s = 0.f;
    for (int t = t0; t <= t1; ++t) {
      const int slot = g - t * kTile / ppg;
      s += pose_part[(static_cast<size_t>(t) * n_slots + slot) * kPoseGrad + k];
    }
    const int j = k / 12, e = k - 12 * j;
    d_poses[static_cast<size_t>(g) * pose_ld + (e < 9 ? 9 * j + e : kJoints * 9 + 3 * j + e - 9)] =
        s;
  }
}

// d_dirs per ray: the ray's samples summed in order.
__global__ void ray_sum_kernel(const float* __restrict__ d_dirs_pt, int n_rays, int spr,
                               float* __restrict__ d_dirs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_rays * 3) return;
  const int r = t / 3, c = t - 3 * r;
  float s = 0.f;
  for (int k = 0; k < spr; ++k) s += d_dirs_pt[3 * (static_cast<size_t>(r) * spr + k) + c];
  d_dirs[t] = s;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

static size_t align256(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

static int n_tiles_of(int n_pts) { return (n_pts + kTile - 1) / kTile; }

static int splits_of(int n_pts) { return max(1, min(kMaxSplits, n_pts / 2048)); }

static int view_chunks(int vppg) { return (vppg + kVbRows - 1) / kVbRows; }

// Most pose groups of ppg points that one tile of kTile points can touch.
static int pose_slots(int ppg) { return min(kTile, (kTile - 1) / ppg + 2); }

// Build the weight-gradient products of one net (see GemmJob).
static int gemm_jobs(const Layout& L, const Workspace& S, const bf16* ep, const bf16* ev,
                     float* d_w, GemmJobs* J) {
  int n = 0, tiles = 0;
  const size_t P = S.p_pad;
  auto add = [&](const bf16* a, int lda, int ma, const bf16* b, int ldb, int nb, float* out,
                 int ldo, int m_lo, int m_hi) {
    if (n == kMaxJobs) return;
    GemmJob& j = J->job[n++];
    j = GemmJob{a, b, out, lda, ma, ldb, nb, ldo, m_lo, m_hi, (nb + kGT - 1) / kGT, tiles};
    tiles += ((ma + kGT - 1) / kGT) * j.tiles_n;
  };
  for (int i = 0; i < L.depth; ++i) {
    const bf16* gz = S.gz + i * P * kWidth;
    float* out = d_w + L.w_layer[i];
    const int ldo = L.layer_in_of(i);
    if (i == 0) {
      add(gz, kWidth, kWidth, ep, L.pc, L.pc, out, ldo, 0, kWidth);
    } else if (i - 1 == L.skip) {
      add(gz, kWidth, kWidth, ep, L.pc, L.pc, out, ldo, 0, kWidth);
      add(gz, kWidth, kWidth, S.hs + (i - 1) * P * kWidth, kWidth, kWidth, out + L.pc, ldo, 0,
          kWidth);
    } else {
      add(gz, kWidth, kWidth, S.hs + (i - 1) * P * kWidth, kWidth, kWidth, out, ldo, 0, kWidth);
    }
  }
  const bf16* h_last = S.hs + (L.depth - 1) * P * kWidth;
  add(S.gfeat, kWidth, kWidth, h_last, kWidth, kWidth, d_w + L.w_feat, kWidth, 0, kWidth);
  add(S.gzv, kViewWidth, kViewWidth, S.feat, kWidth, kWidth, d_w + L.w_view, kWidth + L.vcp, 0,
      kViewWidth);
  add(S.gzv, kViewWidth, kViewWidth, ev, L.vc, L.vc, d_w + L.w_view + kWidth, kWidth + L.vcp, 0,
      kViewWidth);
  // heads: row 0 of ghead^T h is the alpha head, rows 1..3 of ghead^T hv rgb
  add(S.ghead, kHeadLd, kHeadLd, h_last, kWidth, kWidth, d_w + L.w_alpha, kWidth, 0, 1);
  add(S.ghead, kHeadLd, kHeadLd, S.hv, kViewWidth, kViewWidth, d_w + L.w_rgb, kViewWidth, 1, 4);
  J->n_jobs = n;
  J->n_tiles = tiles;
  return n < kMaxJobs ? 0 : -1;
}

// Carve the workspace; returns its size in bytes (base may be null to size it).
// ppg > 0 (points per pose group) adds the input gradients' regions.
static size_t carve(const Layout& L, int n_pts, int n_vgroups, int vppg, int ppg,
                    unsigned char* base, Workspace* S) {
  const size_t P = static_cast<size_t>(n_tiles_of(n_pts)) * kTile;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    unsigned char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  S->p_pad = P;
  S->hs = reinterpret_cast<bf16*>(take(sizeof(bf16) * L.depth * P * kWidth));
  S->feat = reinterpret_cast<bf16*>(take(sizeof(bf16) * P * kWidth));
  S->hv = reinterpret_cast<bf16*>(take(sizeof(bf16) * P * kViewWidth));
  S->gz = reinterpret_cast<bf16*>(take(sizeof(bf16) * L.depth * P * kWidth));
  S->gfeat = reinterpret_cast<bf16*>(take(sizeof(bf16) * P * kWidth));
  S->gzv = reinterpret_cast<bf16*>(take(sizeof(bf16) * P * kViewWidth));
  S->ghead = reinterpret_cast<bf16*>(take(sizeof(bf16) * P * kHeadLd));
  S->gzv32 = reinterpret_cast<float*>(take(sizeof(float) * P * kViewWidth));
  S->bias_part =
      reinterpret_cast<float*>(take(sizeof(float) * n_tiles_of(n_pts) * n_bias(L)));
  // the gemm tiles: the jobs' count, sized with a null workspace
  GemmJobs J{};
  Workspace dummy = *S;
  gemm_jobs(L, dummy, nullptr, nullptr, nullptr, &J);
  S->gemm_part = reinterpret_cast<float*>(
      take(sizeof(float) * J.n_tiles * splits_of(n_pts) * kGT * kGT));
  S->vb_part = reinterpret_cast<float*>(
      take(sizeof(float) * n_vgroups * view_chunks(vppg) * kViewWidth));
  S->d_dirs_pt = nullptr;
  S->pose_part = nullptr;
  if (ppg > 0) {
    S->d_dirs_pt = reinterpret_cast<float*>(take(sizeof(float) * P * 3));
    S->pose_part = reinterpret_cast<float*>(
        take(sizeof(float) * n_tiles_of(n_pts) * pose_slots(ppg) * kPoseGrad));
  }
  return off;
}

static bool view_groups_ok(int n_pts, int n_vgroups, int vppg) {
  return n_vgroups >= 1 && vppg >= 1 && static_cast<long long>(n_vgroups) * vppg >= n_pts &&
         static_cast<long long>(n_vgroups - 1) * vppg < n_pts;
}

}  // namespace posegen

extern "C" {

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
  const size_t smem = smem_bytes(L, true);
  cudaError_t e = set_smem(field_stash_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  RowBias vb;
  vb.ld = n_vgroups > 1 ? kViewWidth : 0;
  vb.ppg = vppg;
  vb.n_pts = n_pts;
  field_stash_kernel<<<n_tiles_of(n_pts), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, dirs, n_pts, spr, poses, pose_ld, ppg, L, static_cast<const bf16*>(w), b, bview, vb,
      out, static_cast<bf16*>(e_pts), static_cast<bf16*>(e_view));
  return static_cast<int>(cudaGetLastError());
}

// Bytes of workspace posegen_field_bwd needs for these sizes (0: invalid);
// ppg > 0, the points per pose group, sizes it for the input gradients.
long long posegen_field_bwd_workspace(int n_pts, const int* layout, int n_layout, int n_vgroups,
                                      int vppg, int ppg) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || ppg < 0 ||
      !view_groups_ok(n_pts, n_vgroups, vppg)) {
    return 0;
  }
  Workspace S;
  return static_cast<long long>(carve(L, n_pts, n_vgroups, vppg, ppg, nullptr, &S));
}

// Weight-only backward of one net from the stash: g (n_pts, 4) f32 output
// cotangent, e_pts / e_view the forward's stashes, w / b / bview /
// n_vgroups / vppg as the forward took them. Writes d_w (n_w,) and d_b
// (n_b,) f32 in the packed layout (the view bias slot and the view head's
// pad columns are left as they are) and d_bview (n_vgroups, 128). The
// workspace holds posegen_field_bwd_workspace() bytes. With pts non-null
// (the forward's pts (n_pts, 3), dirs (n_pts / spr, 3), poses at pose_ld
// floats a row, ppg points per pose row) it also runs the input gradients
// and writes d_pts (n_pts, 3), d_dirs (n_pts / spr, 3) and the rot / trn
// slots of d_poses (n_pts / ppg rows of pose_ld; the other slots are left as
// they are); the weight gradients are the same as without. Deterministic:
// no atomics, every sum in a fixed order. Returns a cudaError_t code.
int posegen_field_bwd(int n_pts, const int* layout, int n_layout, const void* w, const float* b,
                      const float* bview, int n_vgroups, int vppg, const float* g,
                      const void* e_pts, const void* e_view, void* workspace,
                      long long ws_bytes, float* d_w, float* d_b, float* d_bview,
                      const float* pts, const float* dirs, int spr, const float* poses,
                      int pose_ld, int ppg, float* d_pts, float* d_dirs, float* d_poses,
                      void* stream) {
  using namespace posegen;
  Layout L;
  const bool inputs = pts != nullptr;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || !view_groups_ok(n_pts, n_vgroups, vppg)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (inputs && (dirs == nullptr || poses == nullptr || d_pts == nullptr || d_dirs == nullptr ||
                 d_poses == nullptr || spr <= 0 || n_pts % spr != 0 || ppg <= 0 ||
                 n_pts % ppg != 0 || pose_ld < kPoseFloats + L.nf_kp + L.nf_view)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Workspace S;
  const size_t need = carve(L, n_pts, n_vgroups, vppg, inputs ? ppg : 0,
                            static_cast<unsigned char*>(workspace), &S);
  if (workspace == nullptr || ws_bytes < static_cast<long long>(need)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* ep = static_cast<const bf16*>(e_pts);
  const auto* ev = static_cast<const bf16*>(e_view);
  const int n_tiles = n_tiles_of(n_pts);

  const size_t smem = bwd_smem_bytes(L);
  cudaError_t e = set_smem(field_bwd_tile_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  RowBias vb;
  vb.ld = n_vgroups > 1 ? kViewWidth : 0;
  vb.ppg = vppg;
  vb.n_pts = n_pts;
  field_bwd_tile_kernel<<<n_tiles, kThreads, smem, s>>>(n_pts, L, static_cast<const bf16*>(w), b,
                                                        bview, vb, g, ep, ev, S);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  GemmJobs J{};
  if (gemm_jobs(L, S, ep, ev, d_w, &J) != 0) return static_cast<int>(cudaErrorInvalidValue);
  J.part = S.gemm_part;
  J.splits = splits_of(n_pts);
  J.chunk = ((n_pts + J.splits - 1) / J.splits + kGK - 1) / kGK * kGK;
  J.n_pts = n_pts;
  wgrad_gemm_kernel<<<dim3(J.n_tiles, J.splits), kGThreads, 0, s>>>(J);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  wgrad_reduce_kernel<<<J.n_tiles, 256, 0, s>>>(J);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const int nb = n_bias(L);
  bias_reduce_kernel<<<(nb + 255) / 256, 256, 0, s>>>(S.bias_part, n_tiles, L, d_b);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int nck = view_chunks(vppg);
  vbias_part_kernel<<<dim3(n_vgroups, nck), kViewWidth, 0, s>>>(S.gzv32, n_pts, vppg, nck,
                                                                S.vb_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  vbias_sum_kernel<<<n_vgroups, kViewWidth, 0, s>>>(S.vb_part, nck, d_bview);
  if ((e = cudaGetLastError()) != cudaSuccess || !inputs) return static_cast<int>(e);

  // (c) the input gradients, from (a)'s cotangents
  const size_t smem_in = input_smem_bytes(L);
  if ((e = set_smem(field_bwd_input_kernel, smem_in)) != cudaSuccess) return static_cast<int>(e);
  const int n_slots = pose_slots(ppg);
  field_bwd_input_kernel<<<n_tiles, kThreads, smem_in, s>>>(
      n_pts, spr, pts, dirs, poses, pose_ld, ppg, n_slots, L, static_cast<const bf16*>(w), S,
      S.pose_part, d_pts, S.d_dirs_pt);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  pose_reduce_kernel<<<n_pts / ppg, 128, 0, s>>>(S.pose_part, n_pts, ppg, n_slots, d_poses,
                                                 pose_ld);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n_rays = n_pts / spr;
  ray_sum_kernel<<<(3 * n_rays + 255) / 256, 256, 0, s>>>(S.d_dirs_pt, n_rays, spr, d_dirs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
