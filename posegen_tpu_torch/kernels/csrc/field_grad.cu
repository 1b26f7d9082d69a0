// Training kernels of the fused field for Hopper (sm_90a), bound to Python
// through a plain C interface (ctypes).
//
// (The train step's forward, posegen_field_stash, replaces
// posegen_tpu/kernels/field_grad.py::_field_fwd_stash_kernel: it is the eval
// kernel's stash mode, in field.cu.)
//
//   posegen_field_bwd    replaces posegen_tpu/kernels/field_grad.py::
//                        _field_bwd_kernel: every weight and bias gradient
//                        of one net, and the view bias gradient per pose
//                        group (the chain rule to framecodes runs on the
//                        host); with the forward's inputs, also its
//                        input_grads branch (_encode_backward): d_pts,
//                        d_dirs per ray and d_rot / d_trn per pose group.
//
// Bound on an H100: operations. The backward is 5,167,104 FLOP per point
// (the JAX kernel's count), against 2,160 bytes of stash per point read
// back; at 989 TFLOP/s bf16 dense that is 5.22 ns per point against 0.64 ns
// of stash traffic at 3.35 TB/s. The two-pass backward below also moves its
// workspace, 10,416 bytes per point written by (a) and 11,920 (with the
// stash) read by (b):
// 3.1 ns and 3.6 ns per point at 3.35 TB/s. That is a floor of this design,
// not of the function: above (b)'s 1.74 ns share of the operations, below
// the 5.22 ns that bounds the whole backward.
//
// The TPU kernel sums every weight gradient into output blocks that stay
// resident across a grid that runs in order. Hopper blocks run concurrently
// in no order, and one net's gradients (~0.6 M floats) fit no block's shared
// memory, so the backward is split in two deterministic passes:
//   (a) field_bwd_sm90_kernel: one block per 128 points recomputes trunk
//       and heads from the stash and backprops the output cotangent through
//       heads and trunk, every product on wgmma with its weights streamed by
//       TMA (see the kernel's note). It writes each layer's output
//       activation and pre-activation cotangent to a bf16 workspace by TMA
//       store (the JAX kernel casts both operands of every weight-gradient
//       product to bf16, so nothing is lost), and the bias-gradient column
//       sums per 64 points in f32.
//   (b) wgrad_sm90_kernel: dW = G^T H over the point axis on wgmma, split in
//       a fixed number of point ranges whose partial products are summed in
//       a fixed order by wgrad_reduce_kernel; bias and view-bias sums
//       likewise. Two launches on the same inputs give bit-identical
//       gradients.
//   (c) input gradients only, two kernels. input_sm90_kernel: one block per
//       128 points forms the encodings' cotangents g_e_pts = gz0 W0 +
//       gz5 W5[:, :pc] and g_e_view = gzv Wv[:, 256:] from layer 0's, the
//       skip consumer's and the view layer's pre-activation cotangents in
//       (a)'s workspace, on wgmma with TMA-staged operands (bf16 operands,
//       f32 sums, as the JAX kernel's _mm_tn), into two f32 workspace
//       regions. input_chain_kernel: one block per 64 points reads them,
//       recomputes the encode from pts, dirs and the point's pose row in
//       f32, and runs the encode's chain rule per (point, joint). d_pts is
//       written per point; d_dirs per point, then ray_sum_kernel sums each
//       ray's samples in order; d_rot / d_trn as per-tile partials for each
//       pose group the tile touches, summed in tile order by
//       pose_reduce_kernel. No atomics: two launches agree bit for bit, and
//       passes (a) and (b) are the weights-only launch's own. Bound: 608,256
//       FLOP per point of products (2 (256 pc + 256 pc + 128 vc) at multires
//       7 / 4) against ~1.3 KB of workspace reads, so operations at ~0.6 ns
//       per point; the encode's chain rule adds ~150 transcendental and
//       ~3,000 FMA per point on the CUDA cores. The f32 regions between the
//       two kernels are this design's, not the function's: 4 (pc + vc)
//       bytes per point written and read again, 2.6 ns per point at 3.35
//       TB/s at multires 7 / 4, its floor.

#include "field.cuh"
#include "sm90.cuh"
#include "sm90_tile.cuh"

namespace posegen {

// ---------------------------------------------------------------------------
// Kernel 4 (a): per-tile recompute + backprop into the workspace
// ---------------------------------------------------------------------------

// Workspace regions; every per-point region has p_pad rows, whole tiles of
// pass (a) (kATile points).
struct Workspace {
  bf16* hs;          // (depth, p_pad, 256) trunk layer outputs (post-ReLU)
  bf16* feat;        // (p_pad, 256) feature head output
  bf16* hv;          // (p_pad, 128) view layer output (post-ReLU)
  bf16* gz;          // (depth, p_pad, 256) trunk pre-activation cotangents
  bf16* gfeat;       // (p_pad, 256) feature head cotangent
  bf16* gzv;         // (p_pad, 128) view layer pre-activation cotangent
  bf16* ghead;       // (p_pad, 16) [g_alpha | g_r g_g g_b | 0 ...]
  float* gzv32;      // (p_pad, 128) gzv in f32, for the view bias sums
  float* bias_part;  // (p_pad / 64, n_bias) bias column sums per 64 points
  float* gemm_part;  // (gemm tiles, splits, 128, 256) split partial products
  float* vb_part;    // (view groups, view chunks, 128)
  float* d_dirs_pt;  // (p_pad, 3) d_dirs per point (input gradients only)
  float* pose_part;  // (n_tiles, pose slots, 24 x 12) d_rot | d_trn per tile and group
  float* g_ep;       // (p_pad, pc) g_e_pts in f32 (input gradients only)
  float* g_ev;       // (p_pad, vc) g_e_view in f32 (input gradients only)
  size_t p_pad;
};

// Bias columns of bias_part: depth x 256 trunk | 256 feature | alpha | rgb x 3
__host__ __device__ inline int n_bias(const Layout& L) { return L.depth * kWidth + kWidth + 4; }

constexpr int kHeadLd = 16;
constexpr int kVbRows = 256;  // rows per view-bias chunk

// Pass (a) on Hopper. A block of kATile = 128 points runs two consumer
// warpgroups of 64 points each and one producer warp. The producer streams
// every product's weights, in 64-wide K chunks, through a TMA ring of three
// stages (a 256 x 64 slab per chunk: four 64 x 64 boxes), and the stash's
// e_pts / e_view chunks of the block's 128 points through a ring of their
// own for layer 0, the skip consumer and the view layer: the encodings
// never sit whole in shared memory. The producer's warpgroup gives its
// registers to the consumers (setmaxnreg: 40 against 232 a thread, of the
// 168 the launch allots). Each consumer warpgroup runs wgmma m64n256k16
// (m64n128k16 for the view layer) with A from the activation tile or the
// encoding slab and B from the weight slab: K-major for the forward's x W^T,
// the same boxes read MN-major (the transpose bit) for the backward's g W.
// The activation tile (128 x 256 bf16, 128-byte swizzled) is the next
// layer's A operand as it stands: a warpgroup reads and overwrites only its
// own 64 rows, after its wgmma wait and a warpgroup barrier. Each layer's
// output leaves the tile by TMA store into the row-major workspace; the
// forward's ReLU masks stay in shared memory as one bit per activation (4
// words a thread a layer, in the accumulator's own layout), and the
// backward reuses the tile for its cotangents. Bias column sums go to
// bias_part per 64 points, in a fixed order (a butterfly over the 8 lanes
// of each column, then the 4 warps in order). The layers' epilogues, when
// the tensor cores wait, set the kernel's pace: the feature layer runs in
// the trunk's loop and the backward's three kinds of layer in one loop, so
// that each epilogue's code exists once (the fully unrolled code of one
// more copy costs instruction fetches from L2 in every block).
//
// Shared memory (bytes, from a 1,024-aligned base): the tile 65,536 |
// weight ring 3 x 32,768 | encoding ring 2 x 16,384, where after the view
// layer each warpgroup keeps its column-sum scratch, its points' output
// cotangent and the rgb and alpha heads' weights in its own rows of stage
// 0 | ReLU masks depth x 4,096 | 10 mbarriers: 230,480 with the alignment
// slack at depth 8 (bwd_smem_bytes). Deeper nets, whose masks take more,
// run a two-stage weight ring.
//
// The recompute need not sum in the stash kernel's order, so its
// activations may differ from the forward's in the last bit of bf16 (the JAX
// kernel recomputes too). Rows past n_pts read zero encodings and a zero
// cotangent: their cotangents and sums are exactly 0.
constexpr uint32_t kMaskLayer = 4 * 256 * 4;             // 4 words x 256 consumer threads

__host__ __device__ inline size_t bwd_plan_bytes(const Layout& L, int w_stages) {
  return 1024 + kRingW + w_stages * kSlabW + kEStages * kSlabE +
         static_cast<size_t>(L.depth) * kMaskLayer + 2 * (w_stages + kEStages) * sizeof(uint64_t);
}

__host__ __device__ inline int bwd_w_stages(const Layout& L) {
  return bwd_plan_bytes(L, 3) <= kSmemLimit ? 3 : 2;
}

__host__ __device__ inline size_t bwd_smem_bytes(const Layout& L) {
  return bwd_plan_bytes(L, bwd_w_stages(L));
}

static int n_tiles_a(int n_pts) { return (n_pts + kATile - 1) / kATile; }

// Tensor maps of pass (a): the stashes in boxes of 128 points x 64
// columns; weights and workspace in boxes of 64 x 64.
struct BwdMaps {
  CUtensorMap ep, ev;
  CUtensorMap w[kMaxDepth];  // trunk layer i: its h columns (layer 0: all of them)
  CUtensorMap w_skip_e;      // the skip consumer's e_pts columns
  CUtensorMap w_feat, w_view_f, w_view_e;  // view layer: feature | e_view columns
  CUtensorMap hs, gz, feat, gfeat, hv, gzv;
};

// The producer: every chunk of the block's products, in the consumers' order.
__device__ void bwd_produce(const BwdMaps& M, const Layout& L, int p0, const Ring& R) {
  int it = 0, ie = 0;
  auto issue = [&](const CUtensorMap* wm, bool mn, int nbox, int kc, const CUtensorMap* em) {
    const int s = it % R.ws;
    sm90::mbar_wait(R.wempty(s), ((it / R.ws) & 1) ^ 1);
    sm90::mbar_expect_tx(R.wfull(s), nbox * sm90::kBoxBytes);
    for (int b = 0; b < nbox; ++b) {
      sm90::tma_load_2d(R.wslab(s) + b * sm90::kBoxBytes, wm, R.wfull(s), 64 * (mn ? b : kc),
                        64 * (mn ? kc : b));
    }
    ++it;
    if (em != nullptr) {
      const int se = ie % kEStages;
      sm90::mbar_wait(R.eempty(se), ((ie / kEStages) & 1) ^ 1);
      sm90::mbar_expect_tx(R.efull(se), kSlabE);
      sm90::tma_load_2d(R.eslab(se), em, R.efull(se), 64 * kc, p0);
      ++ie;
    }
  };
  const int nk_p = (L.pc + 63) / 64, nk_v = (L.vc + 63) / 64;
  for (int i = 0; i < L.depth; ++i) {
    if (i == 0 || i - 1 == L.skip) {
      for (int kc = 0; kc < nk_p; ++kc) issue(i == 0 ? &M.w[0] : &M.w_skip_e, false, 4, kc, &M.ep);
    }
    if (i > 0) {
      for (int kc = 0; kc < 4; ++kc) issue(&M.w[i], false, 4, kc, nullptr);
    }
  }
  for (int kc = 0; kc < 4; ++kc) issue(&M.w_feat, false, 4, kc, nullptr);
  for (int kc = 0; kc < 4; ++kc) issue(&M.w_view_f, false, 2, kc, nullptr);
  for (int kc = 0; kc < nk_v; ++kc) issue(&M.w_view_e, false, 2, kc, &M.ev);
  for (int kc = 0; kc < 2; ++kc) issue(&M.w_view_f, true, 4, kc, nullptr);
  for (int kc = 0; kc < 4; ++kc) issue(&M.w_feat, true, 4, kc, nullptr);
  for (int i = L.depth - 1; i >= 1; --i) {
    for (int kc = 0; kc < 4; ++kc) issue(&M.w[i], true, 4, kc, nullptr);
  }
}

// The warpgroup's rows of nblk tile blocks from blk0 to `map` at (0, row).
__device__ __forceinline__ void store_blocks(const Frag& f, uint32_t tile, const CUtensorMap* map,
                                             int blk0, int nblk, int row) {
  if (f.t != 0) return;
  for (int b = 0; b < nblk; ++b) {
    sm90::tma_store_2d(map, tile + (blk0 + b) * kBlockBytes + f.wg * kHalfBlock, 64 * b, row);
  }
  sm90::tma_store_commit();
}

// Column sums of the warpgroup's 64 rows, step 1: the 8 lanes of each
// column reduce-scatter (xor 16, 8, 4), each lane then holds 8 columns'
// 16-row sums, written to the warp's scratch row.
__device__ __forceinline__ void col_sums_part(const float (&v)[128], float* scratch,
                                              const Frag& f) {
  float s[64];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    s[2 * j] = v[4 * j] + v[4 * j + 2];
    s[2 * j + 1] = v[4 * j + 1] + v[4 * j + 3];
  }
  const bool b4 = f.lane & 16, b3 = f.lane & 8, b2 = f.lane & 4;
  float u[32], w[16], x[8];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    u[k] = (b4 ? s[k + 32] : s[k]) + __shfl_xor_sync(0xffffffffu, b4 ? s[k] : s[k + 32], 16);
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    w[k] = (b3 ? u[k + 16] : u[k]) + __shfl_xor_sync(0xffffffffu, b3 ? u[k] : u[k + 16], 8);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = (b2 ? w[k + 8] : w[k]) + __shfl_xor_sync(0xffffffffu, b2 ? w[k] : w[k + 8], 4);
  }
  float* sc = scratch + (f.t >> 5) * 256;
#pragma unroll
  for (int k = 0; k < 8; ++k) sc[32 * k + f.lane] = x[k];
}

// Step 2 (after a warpgroup barrier): the 4 warps' sums in order. Entry
// 32 k + l of a warp's row is column 8 (q / 2) + 2 (l % 4) + q % 2 with
// q = 8 (l / 4) + k.
__device__ __forceinline__ void col_sums_out(const float* scratch, float* out, const Frag& f) {
  for (int e = f.t; e < 256; e += 128) {
    const int k = e >> 5, l = e & 31, q = 8 * (l >> 2) + k;
    out[8 * (q >> 1) + 2 * (l & 3) + (q & 1)] =
        scratch[e] + scratch[256 + e] + scratch[512 + e] + scratch[768 + e];
  }
}

// A backward layer's output: bf16 into the tile, its column sums into
// `sums`, and the tile to `map` at row `row`.
__device__ __forceinline__ void bwd_out(const float (&v)[128], unsigned char* tile_p, uint32_t tile,
                                        float* scratch, float* sums, const CUtensorMap* map,
                                        int row, const Frag& f) {
  tile_ready(f);
  uint32_t unused[4] = {0u, 0u, 0u, 0u};
  put_tile<256>(v, tile_p, 0, f, unused);
  col_sums_part(v, scratch, f);
  tile_publish(f);
  store_blocks(f, tile, map, 0, 4, row);
  col_sums_out(scratch, sums, f);
}

__device__ __forceinline__ void apply_mask(float (&v)[128], const uint32_t* m_layer, int tid) {
  uint32_t m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = m_layer[k * 256 + tid];
#pragma unroll
  for (int i = 0; i < 128; ++i) {
    if (!((m[i >> 5] >> (i & 31)) & 1u)) v[i] = 0.f;
  }
}

__global__ void __launch_bounds__(kAThreads, 1)
    field_bwd_sm90_kernel(const __grid_constant__ BwdMaps M, int n_pts, const Layout L,
                          const bf16* __restrict__ W, const float* __restrict__ B,
                          const float* __restrict__ bview, RowBias vb,
                          const float* __restrict__ g, const Workspace S) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t tile = raw + pad;
  const int ws = bwd_w_stages(L);
  const uint32_t ring_e = kRingW + ws * kSlabW, mask_off = ring_e + kEStages * kSlabE;
  uint32_t* masks = reinterpret_cast<uint32_t*>(base + mask_off);
  const Ring R{tile + kRingW, tile + ring_e, tile + mask_off + L.depth * kMaskLayer, ws};
  if (threadIdx.x == 0) {
    for (int s = 0; s < ws; ++s) {
      sm90::mbar_init(R.wfull(s), 1);
      sm90::mbar_init(R.wempty(s), 2);
    }
    for (int s = 0; s < kEStages; ++s) {
      sm90::mbar_init(R.efull(s), 1);
      sm90::mbar_init(R.eempty(s), 2);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  const int p0 = blockIdx.x * kATile;
  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) bwd_produce(M, L, p0, R);
    return;
  }
  sm90::reg_alloc<232>();

  const Frag f;
  const int tid = threadIdx.x;
  // Once the view layer has read the last encoding chunk, the warpgroup's
  // own rows of encoding stage 0 hold its column-sum scratch (4 x 256
  // floats), its 64 points' output cotangent (64 x 4 floats) and the rgb and
  // alpha heads' weights (3 x 128 and 256 bf16).
  float* scratch = reinterpret_cast<float*>(base + ring_e + f.wg * kHalfBlock);
  float* s_g = scratch + 4 * 256;
  bf16* wr_s = reinterpret_cast<bf16*>(s_g + 4 * 64);
  bf16* wa_s = wr_s + 3 * kViewWidth;
  const int P = static_cast<int>(S.p_pad);
  const int hrow = p0 + 64 * f.wg;  // the warpgroup's first point
  float* sums = S.bias_part + static_cast<size_t>(2 * blockIdx.x + f.wg) * n_bias(L);
  const int nk_p = (L.pc + 63) / 64, nk_v = (L.vc + 63) / 64;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0, ie = 0;

  // ---- forward recompute: the trunk, then the feature head (i == depth,
  // no ReLU) ------------------------------------------------------------------
  for (int i = 0; i <= L.depth; ++i) {
    const bool trunk = i < L.depth;
    const bool cat = trunk && i > 0 && i - 1 == L.skip;
    if (i == 0 || cat) consume<256, 0>(acc, nk_p, true, 0, true, it, ie, R, f.wg);
    if (i > 0) consume<256, 0>(acc, 4, false, tile, !cat, it, ie, R, f.wg);
    const float* bias = B + (trunk ? L.b_layer[i] : L.b_feat);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = acc[4 * j + e] + __ldg(bias + f.col(j, e));
        acc[4 * j + e] = trunk ? fmaxf(x, 0.f) : x;
      }
    }
    tile_ready(f);
    uint32_t m[4] = {0u, 0u, 0u, 0u};
    put_tile<256>(acc, base, 0, f, m);
    if (trunk) {
#pragma unroll
      for (int k = 0; k < 4; ++k) masks[(4 * i + k) * 256 + tid] = m[k];
    }
    tile_publish(f);
    store_blocks(f, tile, trunk ? &M.hs : &M.feat, 0, 4, trunk ? i * P + hrow : hrow);
  }
  consume<128, 0>(acc, 4, false, tile, true, it, ie, R, f.wg);  // view layer: [feat | e_view]
  consume<128, 0>(acc, nk_v, true, 0, false, it, ie, R, f.wg);
  for (int e = f.t; e < 256; e += 128) {  // the output cotangent, zero past n_pts
    const size_t p = hrow + e / 4;
    s_g[e] = p < static_cast<size_t>(n_pts) ? g[4 * p + e % 4] : 0.f;
  }
  if (f.t < 48) {
    reinterpret_cast<uint4*>(wr_s)[f.t] = reinterpret_cast<const uint4*>(W + L.w_rgb)[f.t];
  } else if (f.t < 80) {
    reinterpret_cast<uint4*>(wa_s)[f.t - 48] = reinterpret_cast<const uint4*>(W + L.w_alpha)[f.t - 48];
  }

  // ---- heads: hv = relu(zv + the point's view bias) into tile blocks 0-1;
  // g_zv = g_rgb @ W_rgb (bf16 operands) where hv > 0, into blocks 2-3 ------
  {
    const float* brow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = min(p0 + f.r0 + 8 * h, n_pts - 1);
      brow[h] = bview + (vb.ld ? static_cast<size_t>(p / vb.ppg) * vb.ld : 0);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[4 * j + e] = fmaxf(acc[4 * j + e] + __ldg(brow[e >> 1] + f.col(j, e)), 0.f);
      }
    }
    tile_ready(f);
    uint32_t hm[4] = {0u, 0u, 0u, 0u};
    put_tile<128>(acc, base, 0, f, hm);
    float gq[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        gq[h][q] = __bfloat162float(__float2bfloat16(s_g[4 * (f.r0 + 8 * h - 64 * f.wg) + q]));
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = f.col(j, e), i = 4 * j + e;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) s += gq[e >> 1][q] * __bfloat162float(wr_s[q * kViewWidth + c]);
        acc[i] = (hm[i >> 5] >> (i & 31)) & 1u ? s : 0.f;
      }
    }
    float* __restrict__ gzv32 = S.gzv32 + static_cast<size_t>(p0 + f.r0) * kViewWidth;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(gzv32 + 8 * h * kViewWidth + f.col(j, 0)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    uint32_t unused[4] = {0u, 0u, 0u, 0u};
    put_tile<128>(acc, base, 2, f, unused);
    {  // ghead: a half row of 8 bf16 a thread, [g_alpha g_r g_g g_b 0 0 0 0 | 0 ...]
      const int r = f.t >> 1;
      const float* gr = s_g + 4 * r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if ((f.t & 1) == 0) {
        v.x = bf162_bits(__floats2bfloat162_rn(gr[3], gr[0]));
        v.y = bf162_bits(__floats2bfloat162_rn(gr[1], gr[2]));
      }
      reinterpret_cast<uint4*>(S.ghead + static_cast<size_t>(hrow + r) * kHeadLd)[f.t & 1] = v;
    }
    if (f.t < 4) {  // alpha, then r, g, b: bias sums in f32
      const int q = f.t == 0 ? 3 : f.t - 1;
      float s = 0.f;
      for (int r = 0; r < 64; ++r) s += s_g[4 * r + q];
      sums[L.depth * kWidth + kWidth + f.t] = s;
    }
    tile_publish(f);
    store_blocks(f, tile, &M.hv, 0, 2, hrow);
    store_blocks(f, tile, &M.gzv, 2, 2, hrow);
  }

  // ---- backward: k = 0 the feature head's cotangent g_feat = g_zv @
  // W_view[:, :256]; k = 1 the trunk output's, g_feat @ W_feat + g_alpha (x)
  // w_alpha; then down the trunk, layer i's input cotangent (the h part of
  // the skip consumer's [x_pts | h] input); each masked by its layer's ReLU
  for (int k = 0; k <= L.depth; ++k) {
    const int layer = L.depth - k;  // whose pre-activation cotangent k >= 1 gives
    consume<256, 1>(acc, k == 0 ? 2 : 4, false, k == 0 ? tile + 2 * kBlockBytes : tile, true, it,
                    ie, R, f.wg);
    if (k == 1) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[4 * j + e] +=
              __bfloat162float(__float2bfloat16(s_g[4 * (f.row(e) - 64 * f.wg) + 3])) *
              __bfloat162float(wa_s[f.col(j, e)]);
        }
      }
    }
    if (k >= 1) apply_mask(acc, masks + layer * 1024, tid);
    bwd_out(acc, base, tile, scratch, sums + (k == 0 ? L.depth : layer) * kWidth,
            k == 0 ? &M.gfeat : &M.gz, k == 0 ? hrow : layer * P + hrow, f);
  }
  if (f.t == 0) sm90::tma_store_wait_all();
}

// ---------------------------------------------------------------------------
// Kernel 4 (b): weight gradients dW = G^T H over the point axis
// ---------------------------------------------------------------------------

// Pass (b) on Hopper: a persistent GEMM over (output tile, point split) work
// items. An output tile is 128 rows (the products' outputs) x 256 columns
// (their inputs); each of two consumer warpgroups owns 64 rows and runs
// wgmma m64n256k16 with A = G^T from [64 points x 64 outputs] TMA boxes
// (MN-major A) and B = H from [64 points x 64 inputs] boxes (MN-major B),
// fed by a producer warp through a four-stage ring of 48 KB per stage. A
// split's partial tile goes to gemm_part; wgrad_reduce_kernel sums the
// splits in split order. Ragged widths (e_pts 432, e_view 648, the 16-wide
// ghead) and the last points read TMA's zero fill. Work items are numbered
// split-major, so the blocks that run together read the same point range:
// a job's G and H rows are reused from L2 across its tiles.
constexpr int kBM = 128, kBN = 256;  // output tile
constexpr int kBStages = 4;
constexpr uint32_t kStageA = 2 * sm90::kBoxBytes, kStageB = 4 * sm90::kBoxBytes;
constexpr int kMaxJobs = 24;
constexpr int kMaxSplits = 16;

// One product: rows [m_lo, m_hi) of G^T H land at out[(m - m_lo) * ldo + n];
// G has ma valid columns, H nb.
struct WgradJob {
  CUtensorMap a, b;  // G (n_pts x ma), H (n_pts x nb): boxes of 64 points x 64 columns
  float* out;
  int ldo, ma, nb, m_lo, m_hi, tiles_n, tile0;
};

struct WgradJobs {
  WgradJob job[kMaxJobs];
  float* part;
  int n_jobs, n_tiles, splits, chunk, n_pts;
};

__host__ __device__ inline size_t wgrad_smem_bytes() {
  return 1024 + kBStages * (kStageA + kStageB) + 2 * kBStages * sizeof(uint64_t);
}

__device__ __forceinline__ const WgradJob& find_job(const WgradJobs& J, int tile) {
  int j = 0;
  while (j + 1 < J.n_jobs && J.job[j + 1].tile0 <= tile) ++j;
  return J.job[j];
}

struct WgradItem {
  const WgradJob* jb;
  int tile, split, m0, n0, k_begin, k_end;
};

__device__ __forceinline__ WgradItem wgrad_item(const WgradJobs& J, int item) {
  WgradItem w;
  w.split = item / J.n_tiles;
  w.tile = item - w.split * J.n_tiles;
  w.jb = &find_job(J, w.tile);
  const int t = w.tile - w.jb->tile0;
  w.m0 = (t / w.jb->tiles_n) * kBM;
  w.n0 = (t % w.jb->tiles_n) * kBN;
  w.k_begin = w.split * J.chunk;
  w.k_end = min(J.n_pts, w.k_begin + J.chunk);
  return w;
}

__global__ void __launch_bounds__(kAThreads, 1) wgrad_sm90_kernel(const __grid_constant__ WgradJobs J) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t ring_a = (raw + 1023) & ~1023u;
  const uint32_t ring_b = ring_a + kBStages * kStageA;
  const uint32_t bars = ring_b + kBStages * kStageB;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kBStages + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 2);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  const int n_items = J.n_tiles * J.splits;

  if (threadIdx.x >= 256) {  // the producer
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const WgradItem w = wgrad_item(J, item);
      for (int k0 = w.k_begin; k0 < w.k_end; k0 += 64, ++it) {
        const int s = it % kBStages;
        sm90::mbar_wait(empty(s), ((it / kBStages) & 1) ^ 1);
        sm90::mbar_expect_tx(full(s), kStageA + kStageB);
        for (int b = 0; b < 2; ++b) {
          sm90::tma_load_2d(ring_a + s * kStageA + b * sm90::kBoxBytes, &w.jb->a, full(s),
                            w.m0 + 64 * b, k0);
        }
        for (int b = 0; b < 4; ++b) {
          sm90::tma_load_2d(ring_b + s * kStageB + b * sm90::kBoxBytes, &w.jb->b, full(s),
                            w.n0 + 64 * b, k0);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = 64 * wg + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
  int it = 0;
  float acc[128];
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const WgradItem w = wgrad_item(J, item);
    const bool active = w.m0 + 64 * wg < w.jb->ma;  // rows past ma stay zero
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int k0 = w.k_begin; k0 < w.k_end; k0 += 64, ++it) {
      const int s = it % kBStages;
      sm90::mbar_wait(full(s), (it / kBStages) & 1);
      if (active) {
        sm90::fence_acc<128>(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sm90::wgmma_m64n256k16<1, 1>(
              acc, sm90::desc_mn(ring_a + s * kStageA + wg * sm90::kBoxBytes, kk),
              sm90::desc_mn(ring_b + s * kStageB, kk), 1);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_acc<128>(acc);
      }
      if ((threadIdx.x & 127) == 0) sm90::mbar_arrive(empty(s));
    }
    float* part = J.part + (static_cast<size_t>(w.tile) * J.splits + w.split) * kBM * kBN;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(part + (r0 + 8 * h) * kBN + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Sum each tile's split partials in split order into the gradient buffer:
// block (tile, y) takes rows [y * kReduceRows, (y + 1) * kReduceRows).
constexpr int kReduceRows = 4;

__global__ void wgrad_reduce_kernel(const __grid_constant__ WgradJobs J) {
  const int tile = blockIdx.x;
  const WgradJob& jb = find_job(J, tile);
  const int t = tile - jb.tile0;
  const int m0 = (t / jb.tiles_n) * kBM, n0 = (t % jb.tiles_n) * kBN;
  const float* part = J.part + static_cast<size_t>(tile) * J.splits * kBM * kBN;
  const int e1 = (blockIdx.y + 1) * kReduceRows * kBN;
  for (int e = blockIdx.y * kReduceRows * kBN + threadIdx.x; e < e1; e += blockDim.x) {
    const int m = m0 + e / kBN, n = n0 + e % kBN;
    if (m < jb.m_lo || m >= jb.m_hi || n >= jb.nb) continue;
    float s = 0.f;
    for (int sp = 0; sp < J.splits; ++sp) s += part[static_cast<size_t>(sp) * kBM * kBN + e];
    jb.out[static_cast<size_t>(m - jb.m_lo) * jb.ldo + n] = s;
  }
}

// Bias gradients: the column sums per 64 points, summed in order.
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

// Pass (c), step 1 on Hopper: the encodings' cotangents g_e_pts = gz0 W0 +
// gz_skip W_skip[:, :pc] (p_pad x pc) and g_e_view = gzv Wv[:, 256:256 + vc]
// (p_pad x vc), f32, into the workspace. It is pass (a)'s backward product
// with another N: a block of kATile points runs two consumer warpgroups of
// 64 points each and one producer warp; the producer streams the block's
// rows of gz / gzv in 64-wide K chunks (two 64-row boxes of pass (a)'s
// workspace maps) through the encoding ring and, for each, a 64 x 256 slab
// of the weights (pass (a)'s w[0], w_skip_e and w_view_e boxes) through the
// weight ring; the consumers run wgmma m64n256k16 with A K-major from the
// encoding slab and B MN-major from the weight slab (consume<256, 1>), N in
// chunks of 256 columns. Weight boxes that start past pc (vc) are not
// loaded: their columns of the last chunk are not stored, and the box that
// straddles the edge reads TMA's zero fill. The f32 outputs are what bounds
// the kernel (4 (pc + vc) bytes a point against 2 (2 x 256 + 128) read): a
// warpgroup writes each 64 x 32 piece of its accumulators into one of its
// staging buffers (128-byte swizzled, so its 8 rows of a store land in 8
// bank groups) and one thread stores it by TMA, which writes whole lines
// and clips the columns past pc (vc), while the warpgroup goes on. The plan
// is the rings, the staging buffers and the barriers, the same at every
// layout (input_sm90_smem_bytes).
constexpr int kInWStages = 3;
constexpr int kInN = 256;             // output columns per accumulator chunk
constexpr int kOutBufs = 4;           // staging buffers per warpgroup
constexpr uint32_t kOutBuf = 64 * 128;  // 64 rows x 32 f32: one TMA box

__host__ __device__ inline size_t input_sm90_smem_bytes() {
  return 1024 + kInWStages * kSlabW + kEStages * kSlabE + 2 * kOutBufs * kOutBuf +
         2 * (kInWStages + kEStages) * sizeof(uint64_t);
}

// The skip consumer (trunk layer skip + 1), or -1 when the skip is the last layer.
__host__ __device__ inline int skip_consumer(const Layout& L) {
  return L.skip >= 0 && L.skip + 1 < L.depth ? L.skip + 1 : -1;
}

// input_sm90_kernel's tensor maps: pass (a)'s (w0 = its w[0]), and the two
// f32 regions in boxes of 64 points x 32 columns.
struct InputMaps {
  CUtensorMap w0, w_skip_e, w_view_e, gz, gzv, gep, gev;
};

__device__ void input_produce(const InputMaps& M, const Layout& L, int p0, int P, const Ring& R) {
  int it = 0, ie = 0;
  auto issue = [&](const CUtensorMap* wm, int n0, int width, int kc, const CUtensorMap* am,
                   int row) {
    const int s = it % R.ws, se = ie % kEStages;
    const int nbox = min(4, (width - n0 + 63) / 64);
    sm90::mbar_wait(R.wempty(s), ((it / R.ws) & 1) ^ 1);
    sm90::mbar_expect_tx(R.wfull(s), nbox * sm90::kBoxBytes);
    for (int b = 0; b < nbox; ++b) {
      sm90::tma_load_2d(R.wslab(s) + b * sm90::kBoxBytes, wm, R.wfull(s), n0 + 64 * b, 64 * kc);
    }
    sm90::mbar_wait(R.eempty(se), ((ie / kEStages) & 1) ^ 1);
    sm90::mbar_expect_tx(R.efull(se), kSlabE);
    for (int h = 0; h < 2; ++h) {
      sm90::tma_load_2d(R.eslab(se) + h * kHalfBlock, am, R.efull(se), 64 * kc, row + 64 * h);
    }
    ++it;
    ++ie;
  };
  const int skip_layer = skip_consumer(L);
  for (int n0 = 0; n0 < L.pc; n0 += kInN) {
    for (int kc = 0; kc < 4; ++kc) issue(&M.w0, n0, L.pc, kc, &M.gz, p0);
    if (skip_layer >= 0) {
      for (int kc = 0; kc < 4; ++kc) issue(&M.w_skip_e, n0, L.pc, kc, &M.gz, skip_layer * P + p0);
    }
  }
  for (int n0 = 0; n0 < L.vc; n0 += kInN) {
    for (int kc = 0; kc < 2; ++kc) issue(&M.w_view_e, n0, L.vc, kc, &M.gzv, p0);
  }
}

// The warpgroup's 64 rows of an accumulator chunk to `map` at (n0, row),
// 32 columns a box through the staging buffers at `stage` (`nb` counts the
// warpgroup's boxes); boxes that start past `width` are not stored.
__device__ __forceinline__ void store_chunk(const float (&acc)[128], unsigned char* stage,
                                            uint32_t stage_s, const CUtensorMap* map, int n0,
                                            int width, int row, int& nb, const Frag& f) {
  const int m = f.lane & 3;
#pragma unroll
  for (int q = 0; q < kInN / 32; ++q) {
    if (n0 + 32 * q < width) {
      const int b = nb++ % kOutBufs;
      if (f.t == 0) sm90::tma_store_wait_read<kOutBufs - 1>();  // buffer b's last store read it
      sm90::bar_sync(1 + f.wg, 128);
      unsigned char* buf = stage + b * kOutBuf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = f.r0 - 64 * f.wg + 8 * h, i = 4 * (4 * q + jj) + 2 * h;
          *reinterpret_cast<float2*>(buf + r * 128 + (((2 * jj + (m >> 1)) ^ (r & 7)) << 4) +
                                     8 * (m & 1)) = make_float2(acc[i], acc[i + 1]);
        }
      }
      sm90::fence_async_shared();
      sm90::bar_sync(1 + f.wg, 128);
      if (f.t == 0) {
        sm90::tma_store_2d(map, stage_s + b * kOutBuf, n0 + 32 * q, row);
        sm90::tma_store_commit();
      }
    }
  }
}

__global__ void __launch_bounds__(kAThreads, 1)
    input_sm90_kernel(const __grid_constant__ InputMaps M, const Layout L, int P) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  const uint32_t base = raw + pad;
  const uint32_t ring_e = base + kInWStages * kSlabW, stage = ring_e + kEStages * kSlabE;
  const Ring R{base, ring_e, stage + 2 * kOutBufs * kOutBuf, kInWStages};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kInWStages; ++s) {
      sm90::mbar_init(R.wfull(s), 1);
      sm90::mbar_init(R.wempty(s), 2);
    }
    for (int s = 0; s < kEStages; ++s) {
      sm90::mbar_init(R.efull(s), 1);
      sm90::mbar_init(R.eempty(s), 2);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  const int p0 = blockIdx.x * kATile;
  if (threadIdx.x >= 256) {
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 256) input_produce(M, L, p0, P, R);
    return;
  }
  sm90::reg_alloc<232>();
  const Frag f;
  const uint32_t my_stage = stage + f.wg * kOutBufs * kOutBuf;
  unsigned char* my_stage_p = smem_raw + (my_stage - raw);
  const int row = p0 + 64 * f.wg;
  const bool skip = skip_consumer(L) >= 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0, ie = 0, nb = 0;
  for (int n0 = 0; n0 < L.pc; n0 += kInN) {
    consume<256, 1>(acc, 4, true, 0, true, it, ie, R, f.wg);
    if (skip) consume<256, 1>(acc, 4, true, 0, false, it, ie, R, f.wg);
    store_chunk(acc, my_stage_p, my_stage, &M.gep, n0, L.pc, row, nb, f);
  }
  for (int n0 = 0; n0 < L.vc; n0 += kInN) {
    consume<256, 1>(acc, 2, true, 0, true, it, ie, R, f.wg);
    store_chunk(acc, my_stage_p, my_stage, &M.gev, n0, L.vc, row, nb, f);
  }
  if (f.t == 0) sm90::tma_store_wait_all();
}

constexpr int kPoseGrad = kJoints * 12;  // per group: d_rot (24 x 9) | d_trn (24 x 3), (j, e)
constexpr int kState = 6;                // floats per (point, joint) of the chain rule

// Pass (c), step 2: the chain rule's shared memory, the per-(point, joint)
// state and the points' pts and dirs, 38,400 bytes at every layout.
__host__ __device__ inline size_t input_chain_smem_bytes() {
  return sizeof(float) * (kTile * kJoints * kState + kTile * 6);
}

// Pass (c)'s plan: the larger of its two kernels'.
__host__ __device__ inline size_t input_smem_bytes() {
  const size_t a = input_sm90_smem_bytes(), b = input_chain_smem_bytes();
  return a > b ? a : b;
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

// Pass (c), step 2: one block per kTile points reads each point's rows of
// g_e_pts (G) and g_e_view (H) from the workspace, recomputes the encode
// from pts, dirs and the point's pose row in f32, and runs the encode's
// chain rule per (point, joint) on the CUDA cores. Its reads of G and H wait
// on device memory, so four blocks share an SM (64 registers a thread,
// 38,400 bytes of shared memory a block) to keep more of them in flight.
__global__ void __launch_bounds__(kThreads, 4)
    input_chain_kernel(int n_pts, int spr, const float* __restrict__ pts,
                       const float* __restrict__ dirs, const float* __restrict__ poses,
                       int pose_ld, int ppg, int n_slots, const Layout L, const Workspace S,
                       float* __restrict__ pose_part, float* __restrict__ d_pts,
                       float* __restrict__ d_dirs_pt) {
  __shared__ float state[kTile * kJoints * kState];  // (kTile, 24, kState)
  __shared__ float s_x[kTile * 3];                   // (kTile, 3) pts
  __shared__ float s_d[kTile * 3];                   // (kTile, 3) dirs

  const int p0 = blockIdx.x * kTile;
  const int kc = kJoints * (1 + 2 * L.nf_kp);

  for (int t = threadIdx.x; t < kTile * 3; t += kThreads) {
    const int r = t / 3, c = t - 3 * r;
    const int gp = min(p0 + r, n_pts - 1);
    s_x[t] = pts[3 * gp + c];
    s_d[t] = dirs[3 * (gp / spr) + c];
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
    const float* G = S.g_ep + static_cast<size_t>(p0 + p) * L.pc;
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
    const float* H = S.g_ev + static_cast<size_t>(p0 + p) * L.vc;
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

// Points per split, whole 64-point chunks (mirrored by field_grad.py wgrad_split_plan).
static int chunk_of(int n_pts) {
  const int splits = splits_of(n_pts);
  return ((n_pts + splits - 1) / splits + 63) / 64 * 64;
}

static int view_chunks(int vppg) { return (vppg + kVbRows - 1) / kVbRows; }

// Most pose groups of ppg points that one tile of kTile points can touch.
static int pose_slots(int ppg) { return min(kTile, (kTile - 1) / ppg + 2); }

// The weight-gradient products of one net (see WgradJob); with maps, their
// tensor maps over n_pts rows too. 0, or -1 when a job or a map fails.
static int gemm_jobs(const Layout& L, const Workspace& S, int n_pts, const bf16* ep,
                     const bf16* ev, float* d_w, WgradJobs* J, bool maps) {
  int n = 0, tiles = 0;
  bool ok = true;
  const size_t P = S.p_pad;
  auto add = [&](const bf16* a, int lda, int ma, const bf16* b, int ldb, int nb, float* out,
                 int ldo, int m_lo, int m_hi) {
    if (n == kMaxJobs) {
      ok = false;
      return;
    }
    WgradJob& j = J->job[n++];
    j.out = out;
    j.ldo = ldo;
    j.ma = ma;
    j.nb = nb;
    j.m_lo = m_lo;
    j.m_hi = m_hi;
    j.tiles_n = (nb + kBN - 1) / kBN;
    j.tile0 = tiles;
    tiles += ((ma + kBM - 1) / kBM) * j.tiles_n;
    if (maps) {
      ok = ok && sm90::make_map(&j.a, a, ma, n_pts, lda, 64) &&
           sm90::make_map(&j.b, b, nb, n_pts, ldb, 64);
    }
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
  return ok ? 0 : -1;
}

// Pass (a)'s tensor maps; false when the encoder refuses one.
static bool bwd_maps(const Layout& L, int n_pts, const bf16* W, const bf16* ep, const bf16* ev,
                     const Workspace& S, BwdMaps* M) {
  using sm90::make_map;
  const size_t P = S.p_pad;
  bool ok = make_map(&M->ep, ep, L.pc, n_pts, L.pc, kATile) &&
            make_map(&M->ev, ev, L.vc, n_pts, L.vc, kATile);
  for (int i = 0; i < L.depth && ok; ++i) {
    const bf16* w = W + L.w_layer[i];
    const int ld = L.layer_in_of(i);
    if (i == 0) {
      ok = make_map(&M->w[0], w, L.pc, kWidth, ld, 64);
    } else if (i - 1 == L.skip) {
      ok = make_map(&M->w_skip_e, w, L.pc, kWidth, ld, 64) &&
           make_map(&M->w[i], w + L.pc, kWidth, kWidth, ld, 64);
    } else {
      ok = make_map(&M->w[i], w, kWidth, kWidth, ld, 64);
    }
  }
  const int ldv = kWidth + L.vcp;
  return ok && make_map(&M->w_feat, W + L.w_feat, kWidth, kWidth, kWidth, 64) &&
         make_map(&M->w_view_f, W + L.w_view, kWidth, kViewWidth, ldv, 64) &&
         make_map(&M->w_view_e, W + L.w_view + kWidth, L.vc, kViewWidth, ldv, 64) &&
         make_map(&M->hs, S.hs, kWidth, L.depth * P, kWidth, 64) &&
         make_map(&M->gz, S.gz, kWidth, L.depth * P, kWidth, 64) &&
         make_map(&M->feat, S.feat, kWidth, P, kWidth, 64) &&
         make_map(&M->gfeat, S.gfeat, kWidth, P, kWidth, 64) &&
         make_map(&M->hv, S.hv, kViewWidth, P, kViewWidth, 64) &&
         make_map(&M->gzv, S.gzv, kViewWidth, P, kViewWidth, 64);
}

// Carve the workspace; returns its size in bytes (base may be null to size
// it). ppg > 0 (points per pose group) adds the input gradients' regions.
// offsets, if given, receives each region's byte offset in carve order
// (kRegions of them; -1 for the input gradients' without them).
constexpr int kRegions = 15;

static size_t carve(const Layout& L, int n_pts, int n_vgroups, int vppg, int ppg,
                    unsigned char* base, Workspace* S, long long* offsets = nullptr) {
  const size_t P = static_cast<size_t>(n_tiles_a(n_pts)) * kATile;
  size_t off = 0;
  int k = 0;
  if (offsets != nullptr) {
    for (int i = 0; i < kRegions; ++i) offsets[i] = -1;
  }
  auto take = [&](size_t bytes) {
    if (offsets != nullptr) offsets[k++] = static_cast<long long>(off);
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
  S->bias_part = reinterpret_cast<float*>(take(sizeof(float) * (P / 64) * n_bias(L)));
  // the gemm tiles: the jobs' count, sized without maps
  WgradJobs J{};
  gemm_jobs(L, *S, n_pts, nullptr, nullptr, nullptr, &J, false);
  S->gemm_part = reinterpret_cast<float*>(
      take(sizeof(float) * J.n_tiles * splits_of(n_pts) * kBM * kBN));
  S->vb_part = reinterpret_cast<float*>(
      take(sizeof(float) * n_vgroups * view_chunks(vppg) * kViewWidth));
  S->d_dirs_pt = nullptr;
  S->pose_part = nullptr;
  S->g_ep = nullptr;
  S->g_ev = nullptr;
  if (ppg > 0) {
    S->d_dirs_pt = reinterpret_cast<float*>(take(sizeof(float) * P * 3));
    S->pose_part = reinterpret_cast<float*>(
        take(sizeof(float) * n_tiles_of(n_pts) * pose_slots(ppg) * kPoseGrad));
    S->g_ep = reinterpret_cast<float*>(take(sizeof(float) * P * L.pc));
    S->g_ev = reinterpret_cast<float*>(take(sizeof(float) * P * L.vc));
  }
  return off;
}

}  // namespace posegen

extern "C" {

// Bytes of workspace posegen_field_bwd needs for these sizes (0: invalid);
// ppg > 0, the points per pose group, sizes it for the input gradients.
// regions, if not null, receives its layout (16 values): regions[0] =
// p_pad (rows of every per-point region), regions[1..15] = byte offsets of
// hs, feat, hv, gz, gfeat, gzv, ghead, gzv32, bias_part, gemm_part,
// vb_part, d_dirs_pt, pose_part, g_ep and g_ev (see Workspace; -1 for the
// last four without input gradients).
long long posegen_field_bwd_workspace(int n_pts, const int* layout, int n_layout, int n_vgroups,
                                      int vppg, int ppg, long long* regions) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 || ppg < 0 ||
      !view_groups_ok(n_pts, n_vgroups, vppg)) {
    return 0;
  }
  Workspace S;
  long long offsets[kRegions];
  const size_t bytes = carve(L, n_pts, n_vgroups, vppg, ppg, nullptr, &S, offsets);
  if (regions != nullptr) {
    regions[0] = static_cast<long long>(S.p_pad);
    for (int k = 0; k < kRegions; ++k) regions[1 + k] = offsets[k];
  }
  return static_cast<long long>(bytes);
}

// Pass (b)'s split of n_pts points: returns the number of splits and
// writes the points per split to *chunk (split s sums points [s chunk,
// min(n_pts, (s + 1) chunk))); 0 when n_pts <= 0.
int posegen_field_bwd_splits(int n_pts, int* chunk) {
  using namespace posegen;
  if (n_pts <= 0 || chunk == nullptr) return 0;
  *chunk = chunk_of(n_pts);
  return splits_of(n_pts);
}

// Bytes of dynamic shared memory the backward's pass (a) takes for this
// layout (0: invalid layout).
long long posegen_field_bwd_smem(const int* layout, int n_layout) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L)) return 0;
  return static_cast<long long>(bwd_smem_bytes(L));
}

// Bytes of shared memory the backward's input-gradient pass (c) takes for
// this layout, the larger of its two kernels' plans, the same at every
// layout (0: invalid layout).
long long posegen_field_bwd_input_smem(const int* layout, int n_layout) {
  using namespace posegen;
  Layout L;
  if (!read_layout(layout, n_layout, &L)) return 0;
  return static_cast<long long>(input_smem_bytes());
}

// Weight-only backward of one net from the stash: g (n_pts, 4) f32 output
// cotangent, e_pts / e_view the forward's stashes, w / b / bview /
// n_vgroups / vppg as the forward took them. Writes d_w (n_w,) and d_b
// (n_b,) f32 in the packed layout (the view bias slot and the view head's
// pad columns are left as they are) and d_bview (n_vgroups, 128). The
// workspace holds posegen_field_bwd_workspace() bytes; pass (a)'s regions
// are left in it for the caller to read. With pts non-null
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
  if (!read_layout(layout, n_layout, &L) || n_pts <= 0 ||
      !view_groups_ok(n_pts, n_vgroups, vppg)) {
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
  const auto* W = static_cast<const bf16*>(w);
  const auto* ep = static_cast<const bf16*>(e_pts);
  const auto* ev = static_cast<const bf16*>(e_view);
  cudaError_t e;
  BwdMaps M{};  // pass (a)'s tensor maps; pass (c) reads its operands through some of them
  if (!bwd_maps(L, n_pts, W, ep, ev, S, &M)) return static_cast<int>(cudaErrorInvalidValue);

  {  // (a)
    const size_t smem = bwd_smem_bytes(L);
    if ((e = set_smem(field_bwd_sm90_kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    RowBias vb;
    vb.ld = n_vgroups > 1 ? kViewWidth : 0;
    vb.ppg = vppg;
    field_bwd_sm90_kernel<<<n_tiles_a(n_pts), kAThreads, smem, s>>>(M, n_pts, L, W, b, bview, vb,
                                                                     g, S);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }

  {  // (b)
    WgradJobs J{};
    if (gemm_jobs(L, S, n_pts, ep, ev, d_w, &J, true) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    J.part = S.gemm_part;
    J.splits = splits_of(n_pts);
    J.chunk = chunk_of(n_pts);
    J.n_pts = n_pts;
    const size_t smem = wgrad_smem_bytes();
    if ((e = set_smem(wgrad_sm90_kernel, smem)) != cudaSuccess) return static_cast<int>(e);
    int dev = 0, n_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return static_cast<int>(e);
    }
    const int n_items = J.n_tiles * J.splits;
    wgrad_sm90_kernel<<<min(n_items, n_sm), kAThreads, smem, s>>>(J);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    wgrad_reduce_kernel<<<dim3(J.n_tiles, kBM / kReduceRows), 256, 0, s>>>(J);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }

  const int nb = n_bias(L);
  bias_reduce_kernel<<<(nb + 255) / 256, 256, 0, s>>>(S.bias_part, static_cast<int>(S.p_pad / 64),
                                                      L, d_b);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int nck = view_chunks(vppg);
  vbias_part_kernel<<<dim3(n_vgroups, nck), kViewWidth, 0, s>>>(S.gzv32, n_pts, vppg, nck,
                                                                S.vb_part);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  vbias_sum_kernel<<<n_vgroups, kViewWidth, 0, s>>>(S.vb_part, nck, d_bview);
  if ((e = cudaGetLastError()) != cudaSuccess || !inputs) return static_cast<int>(e);

  // (c) the input gradients, from (a)'s cotangents: the encodings'
  // cotangents on the tensor cores, then the chain rule
  InputMaps IM{M.w[0], M.w_skip_e, M.w_view_e, M.gz, M.gzv, {}, {}};
  if (!sm90::make_map_f32(&IM.gep, S.g_ep, L.pc, S.p_pad, L.pc, 64) ||
      !sm90::make_map_f32(&IM.gev, S.g_ev, L.vc, S.p_pad, L.vc, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem_in = input_sm90_smem_bytes();
  if ((e = set_smem(input_sm90_kernel, smem_in)) != cudaSuccess) return static_cast<int>(e);
  input_sm90_kernel<<<n_tiles_a(n_pts), kAThreads, smem_in, s>>>(IM, L,
                                                                  static_cast<int>(S.p_pad));
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n_slots = pose_slots(ppg);
  input_chain_kernel<<<n_tiles_of(n_pts), kThreads, 0, s>>>(
      n_pts, spr, pts, dirs, poses, pose_ld, ppg, n_slots, L, S, S.pose_part, d_pts,
      S.d_dirs_pt);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  pose_reduce_kernel<<<n_pts / ppg, 128, 0, s>>>(S.pose_part, n_pts, ppg, n_slots, d_poses,
                                                 pose_ld);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const int n_rays = n_pts / spr;
  ray_sum_kernel<<<(3 * n_rays + 255) / 256, 256, 0, s>>>(S.d_dirs_pt, n_rays, spr, d_dirs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
