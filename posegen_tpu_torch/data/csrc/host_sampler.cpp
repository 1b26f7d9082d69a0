// Native host-side ray sampler for the data loader.
//
// The per-image pixel sampling + ray construction loop (reference
// BaseH5Dataset.sample_pixels / get_rays, core/dataset.py:277-434) is the
// data pipeline's hot path: for every training batch it scans sampling
// masks, draws pixels, gathers RGB/mask values and builds ray directions.
// The Python/numpy version costs several ms per batch on one host core;
// this C++ version does the scan/draw/gather in one pass, exposed through
// a plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Build: posegen_tpu_torch/data/native.py compiles it with g++ at first use
// into build/posegen_tpu_torch/, named by a hash of this source.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// xoshiro256** — small, fast, seedable PRNG (public-domain algorithm)
struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion
    uint64_t x = seed;
    for (int i = 0; i < 4; ++i) {
      x += 0x9e3779b97f4a7c15ULL;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  inline uint64_t next() {
    const uint64_t result = rotl(s[1] * 5, 7) * 9;
    const uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  inline uint64_t below(uint64_t n) { return next() % n; }
};

}  // namespace

extern "C" {

// Count valid (> 0) pixels in a mask and optionally collect their flat
// indices. Returns the count; indices written only when out != nullptr.
int64_t pg_scan_mask(const uint8_t* mask, int64_t n_pixels, int64_t* out) {
  int64_t cnt = 0;
  for (int64_t i = 0; i < n_pixels; ++i) {
    if (mask[i] > 0) {
      if (out) out[cnt] = i;
      ++cnt;
    }
  }
  return cnt;
}

// Draw n_rays flat pixel indices from the valid set of `mask`
// ((H*W,) uint8), with replacement iff fewer valid pixels than requested.
// Scratch must hold n_pixels int64. Returns number of valid pixels found.
int64_t pg_sample_pixels(const uint8_t* mask, int64_t n_pixels,
                         int64_t n_rays, uint64_t seed,
                         int64_t* scratch, int64_t* out_idx) {
  int64_t n_valid = pg_scan_mask(mask, n_pixels, scratch);
  Rng rng(seed);
  if (n_valid == 0) {
    for (int64_t i = 0; i < n_rays; ++i)
      out_idx[i] = (int64_t)rng.below((uint64_t)n_pixels);
    return 0;
  }
  if (n_valid >= n_rays) {
    // partial Fisher-Yates: sample without replacement
    for (int64_t i = 0; i < n_rays; ++i) {
      int64_t j = i + (int64_t)rng.below((uint64_t)(n_valid - i));
      int64_t tmp = scratch[i];
      scratch[i] = scratch[j];
      scratch[j] = tmp;
      out_idx[i] = scratch[i];
    }
  } else {
    for (int64_t i = 0; i < n_rays; ++i)
      out_idx[i] = scratch[rng.below((uint64_t)n_valid)];
  }
  return n_valid;
}

// Gather sampled pixels into ray/target buffers in one pass.
//   img   (H*W, 3) uint8, mask (H*W,) uint8, bkgd (H*W, 3) uint8 or null
//   pix_dirs (H*W, 3) f32 camera-frame directions (pre-focal)
//   c2w   (12,) f32 row-major top-3x4 of the camera-to-world matrix
// Outputs (n, 3)/(n, 1) float32: rays_o, rays_d, target, fg, bg.
void pg_gather_rays(const int64_t* idx, int64_t n,
                    const uint8_t* img, const uint8_t* mask,
                    const uint8_t* bkgd,
                    const float* pix_dirs, const float* c2w,
                    float fx, float fy,
                    float* rays_o, float* rays_d,
                    float* target, float* fg, float* bg) {
  const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
  const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
  const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
  const float inv255 = 1.0f / 255.0f;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = idx[i];
    const float dx = pix_dirs[p * 3 + 0] / fx;
    const float dy = pix_dirs[p * 3 + 1] / fy;
    const float dz = pix_dirs[p * 3 + 2];
    rays_d[i * 3 + 0] = r00 * dx + r01 * dy + r02 * dz;
    rays_d[i * 3 + 1] = r10 * dx + r11 * dy + r12 * dz;
    rays_d[i * 3 + 2] = r20 * dx + r21 * dy + r22 * dz;
    rays_o[i * 3 + 0] = tx;
    rays_o[i * 3 + 1] = ty;
    rays_o[i * 3 + 2] = tz;
    target[i * 3 + 0] = img[p * 3 + 0] * inv255;
    target[i * 3 + 1] = img[p * 3 + 1] * inv255;
    target[i * 3 + 2] = img[p * 3 + 2] * inv255;
    fg[i] = mask[p] > 0 ? 1.0f : 0.0f;
    if (bkgd) {
      bg[i * 3 + 0] = bkgd[p * 3 + 0] * inv255;
      bg[i * 3 + 1] = bkgd[p * 3 + 1] * inv255;
      bg[i * 3 + 2] = bkgd[p * 3 + 2] * inv255;
    } else {
      bg[i * 3 + 0] = bg[i * 3 + 1] = bg[i * 3 + 2] = 0.0f;
    }
  }
}

// Assemble a WHOLE training batch in one call: for each of n_images images
// (mmapped pointers, no H5 copies), draw n_rays pixels without replacement
// from its sampling mask (or a precomputed valid-index list) and gather
// rays/targets into the flat (n_images*n_rays, ...) batch buffers.
//
// Replaces 64 x ~10 Python/ctypes round-trips per batch with one; combined
// with mmapped H5 arrays this removes the per-batch full-image reads that
// capped the loader (reference DataLoader did the same work in 16 worker
// processes, core/load_data.py:78).
//
//   img_addr / mask_addr / bkgd_addr: per-image base pointers (0 = absent)
//   valid_addr / valid_cnt: per-image int32 valid-pixel lists (0 = scan
//                           the mask here instead; scratch: n_pixels i64)
//   c2ws (n_images, 12) row-major top-3x4; fx/fy per image
//   out_*: flat batch buffers; out_idx: sampled flat pixel indices
void pg_assemble_batch(
    int64_t n_images, int64_t n_rays, int64_t n_pixels,
    const uint64_t* img_addr, const uint64_t* mask_addr,
    const uint64_t* smask_addr, const uint64_t* bkgd_addr,
    const uint64_t* valid_addr, const int64_t* valid_cnt,
    const float* pix_dirs, const float* c2ws,
    const float* fx, const float* fy,
    uint64_t seed, int64_t* scratch,
    float* rays_o, float* rays_d, float* target, float* fg, float* bg,
    int64_t* out_idx) {
  Rng rng(seed);
  for (int64_t im = 0; im < n_images; ++im) {
    const uint8_t* img = reinterpret_cast<const uint8_t*>(img_addr[im]);
    const uint8_t* mask = reinterpret_cast<const uint8_t*>(mask_addr[im]);
    const uint8_t* bkgd =
        bkgd_addr ? reinterpret_cast<const uint8_t*>(bkgd_addr[im]) : nullptr;
    int64_t* idx = out_idx + im * n_rays;

    const int32_t* valid32 =
        valid_addr ? reinterpret_cast<const int32_t*>(valid_addr[im]) : nullptr;
    if (valid32) {
      // read-only precomputed list: Floyd's sampling without replacement
      const int64_t nv = valid_cnt[im];
      if (nv <= 0) {
        for (int64_t i = 0; i < n_rays; ++i)
          idx[i] = (int64_t)rng.below((uint64_t)n_pixels);
      } else if (nv == n_rays) {
        // exactly enough valid pixels: emit each once (the numpy slow path
        // draws without replacement when valid.size >= n_rays)
        for (int64_t i = 0; i < n_rays; ++i) idx[i] = valid32[i];
      } else if (nv < n_rays) {
        for (int64_t i = 0; i < n_rays; ++i)
          idx[i] = valid32[rng.below((uint64_t)nv)];
      } else {
        for (int64_t i = 0; i < n_rays; ++i) {
          const int64_t lim = nv - n_rays + i + 1;
          int64_t t = (int64_t)rng.below((uint64_t)lim);
          bool seen = false;
          for (int64_t k = 0; k < i; ++k)
            if (idx[k] == valid32[t]) { seen = true; break; }
          idx[i] = seen ? valid32[lim - 1] : valid32[t];
        }
      }
    } else {
      // scan the sampling mask here (shares pg_sample_pixels's path);
      // 64 x 512^2 scans are ~10 ms/batch — still far under step time
      const uint8_t* smask = reinterpret_cast<const uint8_t*>(smask_addr[im]);
      pg_sample_pixels(smask, n_pixels, n_rays, rng.next(), scratch, idx);
    }
    const float* c2w = c2ws + im * 12;
    const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
    const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
    const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
    const float ifx = 1.0f / fx[im], ify = 1.0f / fy[im];
    const float inv255 = 1.0f / 255.0f;
    const int64_t o = im * n_rays;
    for (int64_t i = 0; i < n_rays; ++i) {
      const int64_t p = idx[i];
      const float dx = pix_dirs[p * 3 + 0] * ifx;
      const float dy = pix_dirs[p * 3 + 1] * ify;
      const float dz = pix_dirs[p * 3 + 2];
      rays_d[(o + i) * 3 + 0] = r00 * dx + r01 * dy + r02 * dz;
      rays_d[(o + i) * 3 + 1] = r10 * dx + r11 * dy + r12 * dz;
      rays_d[(o + i) * 3 + 2] = r20 * dx + r21 * dy + r22 * dz;
      rays_o[(o + i) * 3 + 0] = tx;
      rays_o[(o + i) * 3 + 1] = ty;
      rays_o[(o + i) * 3 + 2] = tz;
      target[(o + i) * 3 + 0] = img[p * 3 + 0] * inv255;
      target[(o + i) * 3 + 1] = img[p * 3 + 1] * inv255;
      target[(o + i) * 3 + 2] = img[p * 3 + 2] * inv255;
      fg[o + i] = mask[p] > 0 ? 1.0f : 0.0f;
      if (bkgd) {
        bg[(o + i) * 3 + 0] = bkgd[p * 3 + 0] * inv255;
        bg[(o + i) * 3 + 1] = bkgd[p * 3 + 1] * inv255;
        bg[(o + i) * 3 + 2] = bkgd[p * 3 + 2] * inv255;
      } else {
        bg[(o + i) * 3 + 0] = bg[(o + i) * 3 + 1] = bg[(o + i) * 3 + 2] = 0.0f;
      }
    }
  }
}

}  // extern "C"
