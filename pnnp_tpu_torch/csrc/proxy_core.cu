// The proxy NLL's Gaussian-convolved bin law and its knot gradient for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package evaluates its log_prob_conv_gaussian
// as plain jnp, and the port's plain version (pnnp_tpu_torch/models/proxy.py,
// QuantileHead._core_conv) evaluates the law at every (value, knot) pair of
// an [n, m, d+1] grid in some twenty elementwise passes, each writing and
// reading a tensor of the grid's size, in chunks that the backward computes
// again. At the recipe shape (one 512^2 packed frame, d = 1024) that grid is
// 1.07e9 elements, and the step was bound by the device memory traffic of
// intermediates it never needs to keep.
//
// The law, for value x with smoothing s and knots v_0 <= ... <= v_d:
//   inv = 1 / (s sqrt2), r_k = (v_k - x) inv, e_k = erfc(|r_k|)
//   bin k (knots k, k+1), width w = v_{k+1} - v_k, h = w / s:
//     wide (h >= NARROW_BIN): the tail-side mass 2 (Phi(z_{k+1}) - Phi(z_k))
//       = e_k - e_{k+1} (r_k >= 0), e_{k+1} - e_k (r_{k+1} <= 0), else
//       2 - e_k - e_{k+1}; density mass2 / (2 max(w, 1e-8));
//     narrow: the midpoint series exp(-m2) inv / sqrt(pi) (1 + (2 m2 - 1) h^2 / 24)
//       with m2 = ((r_k + r_{k+1}) / 2)^2;
//   core = sum over bins / d.
// The same f32 arithmetic as _core_conv, term for term, with precise erfcf
// and expf (no fast math); r is formed as (v - x) inv, one rounding fewer
// than _core_conv's -x inv + v inv.
//
// Reach. Most terms are exact zeros: a bin whose two knots both lie at
// r >= REACH, or both at r <= -REACH, adds +0.0 or -0.0 in every branch, to
// the core and to both knots' gradients. Proof, REACH = 10.5: erfc(10.5) =
// 7.0e-50 and exp(-10.5^2) = 1.3e-48, far below half the least f32
// subnormal (2^-150 = 7.0e-46), so erfcf(|r|) = 0 and expf(-r^2) = 0 for
// |r| >= REACH (tests/test_torch_cuda_proxy_kernel.py holds this on the
// card, from REACH to 1e30). Wide bin: e_k = e_{k+1} = 0, so mass2 = +-0;
// in the backward also x_k = expf(-r_k^2) = 0, so ga = gb = +-0. Narrow
// bin: |mid| >= REACH (0.5 (ra + rb) rounds monotonically), expf(-m2) = 0,
// so the density and both gradients are +-0 (for |r| < 1.8e19, where m2
// stays finite). A sum that starts at +0.0 is never -0.0, and adding +-0.0
// to it changes no bit, so leaving such terms out changes nothing.
//
// The values come sorted. Where s is one value per example (the pixel
// head), the launcher sorts each example's values (torch.sort, stable) and
// hands the kernels the sorted values and their places (perm): a block of
// neighbouring values then has few bins within reach, and a bin few values.
// Where s varies per value (the row head: 2,048 values, which the launcher
// already splits over bins) nothing is sorted and every pair is walked.
//
// Bound: arithmetic, nothing else. Forward 31 operations a (value, knot)
// pair by the benchmark's count (portbench/counts.py), one erfc and one exp,
// over the pairs walked: at the recipe shape the full grid is 1.07e9 pairs,
// 0.5 ms at 67 TFLOP/s and 0.5 ms of erfc and exp calls at the card's
// special-function rate (16 a clock per SM), of which the windows below walk
// about a third to a half; the backward about twice that. Inputs and outputs
// are a few MB.
//
// * proxy_core_fwd_kernel, value-major: a block covers 512 values of one
//   example (4 a thread, coalesced) and stages the example's knots in tiles
//   of KNOT_TILE bins plus one halo knot in shared memory, each knot with its
//   bin's constants: 1 / (2 max(w, 1e-8)), and where s is one value per
//   example (the pixel head) h^2 / 24 and two flags, the bin narrow and the
//   knot needing erfc (one of its two bins wide). Each warp walks the knots
//   in order, computes r and erfc once per knot and carries them into the
//   next bin, so a knot's erfc is computed once, not twice, and a knot
//   between two narrow bins needs none. The flags are the bin's, so a warp
//   never diverges on them. Where s varies per value (the row head), the
//   narrow test is made per pair. Each value's sum is taken in f32 in
//   groups of FOLD bins, the groups added in f32 (split accumulators: no
//   sum runs over more than d / FOLD + FOLD terms); only the core reaches
//   memory, at the value's own place. Where the values are too few to fill
//   the card (the row head's 2,048 are 4 blocks), the bins are split over
//   blocks too, and proxy_core_sum_kernel adds the splits' sums in order.
//   Window (one s per example): the block takes its values' least and
//   largest (a NaN value widens them to +-inf), marks each bin of its split
//   whose two knots are not both beyond REACH on one side of both (r is
//   monotone in x, so then of every value between them), and walks only from
//   its first such bin to its last. Each value's core is bit for bit the
//   full walk's, whatever the other values of its block: before the first
//   walked bin the full walk's sums hold +0.0 (its terms there are +-0.0 and
//   a sum that starts at +0.0 is never -0.0), as the window's start; the
//   FOLD groups stay keyed by bin index, so each walked term meets the same
//   sums in the same order; the first walked knot's r and erfc are computed
//   as the full walk computes them; after the last walked bin the full walk
//   folds tot + acc at a group's end and adds only +-0.0, which the window's
//   final tot + acc equals. So the window needs no widening to FOLD
//   boundaries. The scan costs 2 r a bin per block, next to 512 a bin for
//   the walk.
//
// * proxy_core_bwd_kernel, knot-major: given g = dL/dcore [n, m], the knot
//   gradient. A warp owns WARP_BINS = 31 consecutive bins: lane l computes r,
//   erfc(|r|) and exp(-r^2) of knot k0 + l for each value, lane 31 those of
//   the halo knot, and lane l takes knot k0 + l + 1's by warp shuffle. A
//   block (4 warps) owns 124 bins and one split of the values; the values'
//   x, g (and, per value, inv) pass through shared memory CHUNK at a time.
//   Each lane sums its bin's share of dL/dv_k and dL/dv_{k+1} over the
//   chunk in f32 and adds the chunk sums in double. Where s is one value per
//   example, the warp computes erfc and exp(-r^2) only if one of its bins
//   is wide and the midpoint series only for its narrow bins. Lanes diverge
//   where a warp holds both kinds. No gradient for x or s: no caller
//   differentiates them (the launcher routes such a call to the plain path).
//   Run (one s per example): the values come sorted, so those within REACH
//   of a warp's 32 knots (of their least and largest) are one contiguous
//   run, found by two binary searches over the split's values; the warp
//   walks only that run, the block stages only the union of its warps' runs,
//   and g is read through perm. A split outside every run still writes its
//   (zero) partials.
//
// Determinism: no atomics in the law. The backward writes one partial per
// (split, bin) and side; proxy_core_grad_kernel sums them over the splits in
// a fixed order in double (GRAD_WARPS warps a knot, each over every
// GRAD_WARPS-th split, then the warps' sums in order), so the gradient is
// bit-identical from launch to launch (its f32 sums run over the values in
// sorted order). Each block adds
// the pairs it walked to `walked` (one integer atomicAdd, where the
// launcher passes a counter: only while tracing, or into a CUDA graph).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float RSQ2 = 0.707106781186547524f;       // 1 / sqrt2
constexpr float SQ2 = 1.41421356237309505f;         // sqrt2
constexpr float RSQPI = 0.564189583547756287f;      // 1 / sqrt(pi)
constexpr float TWO_RSQPI = 1.12837916709551257f;   // 2 / sqrt(pi): -d erfc(r) / dr at 0
constexpr float NARROW_BIN = 0.05f;                 // models/proxy.py NARROW_BIN
constexpr float WIDTH_FLOOR = 1e-8f;
constexpr float REACH = 10.5f;  // |r| past which every term is exactly 0 (header)

constexpr int FWD_THREADS = 128;
constexpr int FWD_VALUES = 4;                            // values a thread
constexpr int FWD_BLOCK_VALUES = FWD_THREADS * FWD_VALUES;
constexpr int FWD_WARPS = FWD_THREADS / 32;
constexpr int KNOT_TILE = 1024;                          // bins staged at once
constexpr int FOLD = 32;                                 // bins a group of the f32 sum
constexpr int BWD_WARPS = 4;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int WARP_BINS = 31;                            // lane 31 is the halo knot
constexpr int BLOCK_BINS = WARP_BINS * BWD_WARPS;
constexpr int CHUNK = BWD_THREADS;                       // values staged at once
constexpr int FINAL_THREADS = 256;
constexpr int GRAD_WARPS = 16;                           // warps a knot's final sum
constexpr unsigned FULL = 0xffffffffu;

constexpr int BIN_NARROW = 1;  // flags of a staged knot (its bin, itself)
constexpr int KNOT_ERFC = 2;

__device__ __forceinline__ float inv_of(float s) { return (1.0f / s) * RSQ2; }

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Where knot v lies for every value between lo and hi (r is monotone in x):
// 1 at r >= REACH of both, -1 at r <= -REACH of both, else 0. A bin adds
// exactly 0 for all of them where its two knots lie on one side (header).
__device__ __forceinline__ int knot_side(float v, float lo, float hi, float inv) {
  const float a = (v - lo) * inv, b = (v - hi) * inv;
  if (a >= REACH && b >= REACH) return 1;
  return (a <= -REACH && b <= -REACH) ? -1 : 0;
}

// The least of a and the largest of b over the block's NW warps, in every
// thread; red holds 2 NW of T.
template <int NW, typename T>
__device__ __forceinline__ void block_min_max(T& a, T& b, T* red) {
  for (int o = 16; o; o >>= 1) {
    a = min(a, __shfl_xor_sync(FULL, a, o));
    b = max(b, __shfl_xor_sync(FULL, b, o));
  }
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[w] = a;
    red[NW + w] = b;
  }
  __syncthreads();
  a = red[0];
  b = red[NW];
  for (int i = 1; i < NW; ++i) {
    a = min(a, red[i]);
    b = max(b, red[NW + i]);
  }
  __syncthreads();  // red may be written again
}

// h^2 / 24 of a bin, h clamped at NARROW_BIN as _core_conv clamps it.
__device__ __forceinline__ float hs2_of(float h) {
  const float hc = fminf(h, NARROW_BIN);
  return hc * hc / 24.0f;
}

// 2 (Phi(z_b) - Phi(z_a)) from the smaller tails.
__device__ __forceinline__ float mass2_of(float ra, float rb, float ea, float eb) {
  const float diff = ea - eb;
  return ra >= 0.0f ? diff : (rb <= 0.0f ? -diff : 2.0f - ea - eb);
}

// A narrow bin's density: the midpoint series; c = inv / sqrt(pi).
__device__ __forceinline__ float narrow_dens(float ra, float rb, float c, float hs2) {
  const float mid = 0.5f * (ra + rb);
  const float m2 = mid * mid;
  return expf(-m2) * c * (1.0f + (2.0f * m2 - 1.0f) * hs2);
}

// d dens / d v_a and d dens / d v_b of a wide bin: xa = exp(-ra^2), cw =
// 1 / (2 max(w, 1e-8)), iw = 1 / max(w, 1e-8) where w >= 1e-8, else 0.
__device__ __forceinline__ void wide_grad(float ra, float rb, float ea, float eb, float xa,
                                          float xb, float cw, float iw, float inv, float& ga,
                                          float& gb) {
  const float dw = -(mass2_of(ra, rb, ea, eb) * cw) * iw;   // d dens / d w
  ga = -TWO_RSQPI * xa * cw * inv - dw;
  gb = TWO_RSQPI * xb * cw * inv + dw;
}

// The same for a narrow bin: hcoef = d(h^2 / 24)/dh * dh/dw = (h / 12) sqrt2 inv.
__device__ __forceinline__ void narrow_grad(float ra, float rb, float c, float hs2,
                                            float hcoef, float inv, float& ga, float& gb) {
  const float mid = 0.5f * (ra + rb);
  const float m2 = mid * mid;
  const float ec = expf(-m2) * c;
  const float poly = 1.0f + (2.0f * m2 - 1.0f) * hs2;
  const float dm = ec * (2.0f * hs2 - poly) * mid * inv;     // through r_a and r_b
  const float dw = ec * (2.0f * m2 - 1.0f) * hcoef;          // through w
  ga = dm - dw;
  gb = dm + dw;
}

// Whether bin b of an example (knots kn) is narrow at sqrt2 inv = sq2inv; a
// bin outside [0, d) counts as narrow (it needs no erfc).
__device__ __forceinline__ bool bin_narrow(const float* kn, int b, int d, float sq2inv) {
  if (b < 0 || b >= d) return true;
  return (kn[b + 1] - kn[b]) * sq2inv < NARROW_BIN;
}

// ---- forward -----------------------------------------------------------------

// Knot t0 + i of tile [t0, t0 + nb] as a float4: the knot, its bin's 1 / (2
// max(w, 1e-8)), and h^2 / 24 with the flags (one s per example) or the
// width (per value).
template <bool PV>
__device__ void stage_tile(float4* tile, const float* kn, int t0, int nb, int d,
                           float sq2inv) {
  for (int i = threadIdx.x; i <= nb; i += blockDim.x) {
    const int k = t0 + i;
    float4 rec = make_float4(kn[k], 0.0f, 0.0f, 0.0f);
    int flags = 0;
    if (k < d) {
      const float w = kn[k + 1] - rec.x;
      rec.y = 1.0f / (2.0f * fmaxf(w, WIDTH_FLOOR));
      if (PV) {
        rec.z = w;
      } else {
        const float h = w * sq2inv;
        rec.z = hs2_of(h);
        if (h < NARROW_BIN) flags |= BIN_NARROW;
      }
    }
    if (!PV && !(bin_narrow(kn, k - 1, d, sq2inv) && bin_narrow(kn, k, d, sq2inv)))
      flags |= KNOT_ERFC;
    rec.w = __int_as_float(flags);
    tile[i] = rec;
  }
}

template <bool PV>
__global__ void __launch_bounds__(FWD_THREADS)
proxy_core_fwd_kernel(const float* __restrict__ knots, const float* __restrict__ x,
                      const long long* __restrict__ perm, const float* __restrict__ s, int m,
                      int d, int split_bins, float* __restrict__ partials,
                      float* __restrict__ core, unsigned long long* __restrict__ walked) {
  __shared__ float4 tile[KNOT_TILE + 1];
  __shared__ float xred[2 * FWD_WARPS];
  __shared__ int bred[2 * FWD_WARPS];
  const int ex = blockIdx.z, ks = blockIdx.y, splits = gridDim.y;
  const float* kn = knots + (size_t)ex * (d + 1);
  const size_t row = (size_t)ex * m;
  const int v0 = blockIdx.x * FWD_BLOCK_VALUES + threadIdx.x;
  const int b0 = ks * split_bins, b1 = min(d, b0 + split_bins);  // this block's bins

  float xv[FWD_VALUES], inv[FWD_VALUES], c[FWD_VALUES], sq2inv[FWD_VALUES];
  float rp[FWD_VALUES], ep[FWD_VALUES], acc[FWD_VALUES], tot[FWD_VALUES];
  const float inv_ex = PV ? 0.0f : inv_of(s[ex]);
#pragma unroll
  for (int j = 0; j < FWD_VALUES; ++j) {
    const int v = v0 + j * FWD_THREADS;
    const bool in = v < m;
    xv[j] = in ? x[row + v] : 0.0f;
    inv[j] = PV ? inv_of(in ? s[row + v] : 1.0f) : inv_ex;
    c[j] = inv[j] * RSQPI;
    sq2inv[j] = SQ2 * inv[j];
    acc[j] = tot[j] = 0.0f;
  }

  // the bins this block walks, [w0, w1): every bin of its split where s
  // varies per value, else its window (header)
  int w0 = b0, w1 = b1;
  if (!PV) {
    float lo = inf_f(), hi = -inf_f();
#pragma unroll
    for (int j = 0; j < FWD_VALUES; ++j) {
      if (v0 + j * FWD_THREADS >= m) continue;
      const bool nan = xv[j] != xv[j];
      lo = nan ? -inf_f() : fminf(lo, xv[j]);
      hi = nan ? inf_f() : fmaxf(hi, xv[j]);
    }
    block_min_max<FWD_WARPS>(lo, hi, xred);
    int first = d, last = -1;  // the block's bins that may add a nonzero term
    for (int k = b0 + threadIdx.x; k < b1; k += FWD_THREADS) {
      const int sa = knot_side(kn[k], lo, hi, inv_ex);
      if (sa == 0 || sa != knot_side(kn[k + 1], lo, hi, inv_ex)) {
        first = min(first, k);
        last = k;
      }
    }
    block_min_max<FWD_WARPS>(first, last, bred);
    w0 = last < first ? b0 : first;  // no such bin: every term is 0
    w1 = last + 1 > w0 ? last + 1 : w0;
  }
  if (walked != nullptr && threadIdx.x == 0)
    atomicAdd(walked, (unsigned long long)min(FWD_BLOCK_VALUES, m - (int)blockIdx.x *
                                                                   FWD_BLOCK_VALUES) *
                          (unsigned long long)(w1 - w0));

  for (int t0 = w0; t0 < w1; t0 += KNOT_TILE) {
    const int nb = min(KNOT_TILE, w1 - t0);
    __syncthreads();  // the last tile's reads are done
    stage_tile<PV>(tile, kn, t0, nb, d, sq2inv[0]);
    __syncthreads();
    // each tile walks its knots 0..nb (knot 0 is the last tile's halo):
    // r and erfc once a knot, carried into the bin that ends at the next
    float4 prev = tile[0];
#pragma unroll
    for (int j = 0; j < FWD_VALUES; ++j) {
      rp[j] = (prev.x - xv[j]) * inv[j];
      ep[j] = (PV || (__float_as_int(prev.w) & KNOT_ERFC)) ? erfcf(fabsf(rp[j])) : 0.0f;
    }
    for (int i = 1; i <= nb; ++i) {
      const float4 cur = tile[i];
      const int flags = __float_as_int(cur.w);
      const int pflags = __float_as_int(prev.w);
#pragma unroll
      for (int j = 0; j < FWD_VALUES; ++j) {
        const float r = (cur.x - xv[j]) * inv[j];
        const float e = (PV || (flags & KNOT_ERFC)) ? erfcf(fabsf(r)) : 0.0f;
        float dens;
        if (PV) {
          const float h = prev.z * sq2inv[j];
          dens = h < NARROW_BIN ? narrow_dens(rp[j], r, c[j], hs2_of(h))
                                : mass2_of(rp[j], r, ep[j], e) * prev.y;
        } else if (pflags & BIN_NARROW) {
          dens = narrow_dens(rp[j], r, c[j], prev.z);
        } else {
          dens = mass2_of(rp[j], r, ep[j], e) * prev.y;
        }
        acc[j] += dens;
        rp[j] = r;
        ep[j] = e;
      }
      // groups of FOLD bins of the split, by bin index
      if ((t0 + i - b0) % FOLD == 0) {
#pragma unroll
        for (int j = 0; j < FWD_VALUES; ++j) {
          tot[j] += acc[j];
          acc[j] = 0.0f;
        }
      }
      prev = cur;
    }
  }
#pragma unroll
  for (int j = 0; j < FWD_VALUES; ++j) {
    const int v = v0 + j * FWD_THREADS;
    if (v >= m) continue;
    const size_t at = perm != nullptr ? (size_t)perm[row + v] : (size_t)v;  // its place
    if (splits == 1)
      core[row + at] = (tot[j] + acc[j]) / (float)d;
    else
      partials[((size_t)ex * splits + ks) * m + at] = tot[j] + acc[j];
  }
}

// core = (the splits' sums, in order) / d, where the bins were split.
__global__ void __launch_bounds__(FINAL_THREADS)
proxy_core_sum_kernel(const float* __restrict__ partials, int splits, int m, int d,
                      float* __restrict__ core) {
  const int ex = blockIdx.y;
  const int v = blockIdx.x * FINAL_THREADS + threadIdx.x;
  if (v >= m) return;
  const float* p = partials + (size_t)ex * splits * m + v;
  float t = 0.0f;
  for (int ks = 0; ks < splits; ++ks) t += p[(size_t)ks * m];
  core[(size_t)ex * m + v] = t / (float)d;
}

// ---- backward ----------------------------------------------------------------

template <bool PV>
__global__ void __launch_bounds__(BWD_THREADS)
proxy_core_bwd_kernel(const float* __restrict__ knots, const float* __restrict__ x,
                      const long long* __restrict__ perm, const float* __restrict__ s,
                      const float* __restrict__ g, int m, int d, int split_values,
                      double* __restrict__ partials, unsigned long long* __restrict__ walked) {
  __shared__ float4 vals[CHUNK];
  __shared__ int runs[2 * BWD_WARPS];
  __shared__ unsigned long long pairs[BWD_WARPS];
  const int ex = blockIdx.z, split = blockIdx.y, splits = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * BLOCK_BINS + warp * WARP_BINS + lane;  // this lane's knot
  const bool owns = lane < WARP_BINS && k < d;                     // and bin k
  const float* kn = knots + (size_t)ex * (d + 1);
  const size_t row = (size_t)ex * m;
  const float kj = kn[min(k, d)];
  const float kn1 = owns ? kn[k + 1] : kj;
  const float w = kn1 - kj;
  const float cw = 1.0f / (2.0f * fmaxf(w, WIDTH_FLOOR));
  const float iw = w >= WIDTH_FLOOR ? 1.0f / fmaxf(w, WIDTH_FLOOR) : 0.0f;

  // one s per example: the bin's constants and the warp's branches, once
  float inv = 0.0f, c = 0.0f, hs2 = 0.0f, hcoef = 0.0f;
  bool wide = false;
  if (!PV) {
    inv = inv_of(s[ex]);
    c = inv * RSQPI;
    const float sq2inv = SQ2 * inv;
    const float h = w * sq2inv;
    hs2 = hs2_of(h);
    hcoef = (h / 12.0f) * sq2inv;
    wide = owns && !(h < NARROW_BIN);
  }
  const bool any_wide = PV || __any_sync(FULL, wide);
  const int owned = __popc(__ballot_sync(FULL, owns));
  const bool warp_owns = owned > 0;  // the last block's last warps own none

  const int v_begin = split * split_values;
  const int v_end = min(m, v_begin + split_values);
  // this warp's values, [rb, re): the whole split where s varies per value,
  // else the run of sorted values within REACH of its knots (header)
  int rb = v_begin, re = v_end;
  if (!PV && warp_owns) {
    float kmin = kj, kmax = kj;
    for (int o = 16; o; o >>= 1) {
      kmin = fminf(kmin, __shfl_xor_sync(FULL, kmin, o));
      kmax = fmaxf(kmax, __shfl_xor_sync(FULL, kmax, o));
    }
    if (!__any_sync(FULL, kj != kj) && inv > 0.0f) {
      const float* xr = x + row;
      // the values below reach of every knot come first (a NaN value last)
      int a = v_begin, b = v_end;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if ((kmin - xr[mid]) * inv >= REACH) a = mid + 1; else b = mid;
      }
      rb = a;
      // then those past reach of every knot, where the split ends in one
      if ((kmax - xr[v_end - 1]) * inv <= -REACH) {
        b = v_end;
        while (a < b) {
          const int mid = (a + b) >> 1;
          if ((kmax - xr[mid]) * inv <= -REACH) b = mid; else a = mid + 1;
        }
        re = a;
      }
    }
  }
  if (lane == 0) {
    runs[warp] = warp_owns ? rb : v_end;
    runs[BWD_WARPS + warp] = warp_owns ? re : v_begin;
    pairs[warp] = (unsigned long long)owned * (unsigned long long)(re - rb);
  }
  __syncthreads();
  int blo = v_end, bhi = v_begin;  // the values the block stages
  unsigned long long block_pairs = 0;
  for (int i = 0; i < BWD_WARPS; ++i) {
    blo = min(blo, runs[i]);
    bhi = max(bhi, runs[BWD_WARPS + i]);
    block_pairs += pairs[i];
  }
  if (walked != nullptr && threadIdx.x == 0) atomicAdd(walked, block_pairs);

  double da = 0.0, db = 0.0;
  for (int c0 = blo; c0 < bhi; c0 += CHUNK) {
    const int nv = min(CHUNK, bhi - c0);
    __syncthreads();  // the last chunk's reads are done
    if (threadIdx.x < nv) {
      const size_t v = row + c0 + threadIdx.x;
      const size_t at = perm != nullptr ? row + (size_t)perm[v] : v;  // its place
      vals[threadIdx.x] = make_float4(x[v], g[at], PV ? inv_of(s[v]) : 0.0f, 0.0f);
    }
    __syncthreads();
    const int i0 = max(0, rb - c0), i1 = min(nv, re - c0);
    if (!warp_owns || i0 >= i1) continue;
    float fa = 0.0f, fb = 0.0f;
#pragma unroll 2
    for (int i = i0; i < i1; ++i) {
      const float4 v = vals[i];
      if (PV) {
        inv = v.z;
        c = inv * RSQPI;
      }
      const float r = (kj - v.x) * inv;
      float e = 0.0f, xr = 0.0f, en = 0.0f, xn = 0.0f;
      if (any_wide) {
        xr = expf(-r * r);
        e = erfcf(fabsf(r));
      }
      const float rn = __shfl_down_sync(FULL, r, 1);
      if (any_wide) {
        en = __shfl_down_sync(FULL, e, 1);
        xn = __shfl_down_sync(FULL, xr, 1);
      }
      float ga = 0.0f, gb = 0.0f;
      if (PV) {
        if (owns) {
          const float sq2inv = SQ2 * inv;
          const float h = w * sq2inv;
          if (h < NARROW_BIN)
            narrow_grad(r, rn, c, hs2_of(h), (h / 12.0f) * sq2inv, inv, ga, gb);
          else
            wide_grad(r, rn, e, en, xr, xn, cw, iw, inv, ga, gb);
        }
      } else if (wide) {
        wide_grad(r, rn, e, en, xr, xn, cw, iw, inv, ga, gb);
      } else if (owns) {
        narrow_grad(r, rn, c, hs2, hcoef, inv, ga, gb);
      }
      fa = fmaf(v.y, ga, fa);
      fb = fmaf(v.y, gb, fb);
    }
    da += (double)fa;
    db += (double)fb;
  }
  if (owns) {
    // [n][side][split][bin]: side 0 the bin's lower knot, 1 its upper
    const size_t at = ((size_t)ex * 2 * splits + split) * d + k;
    partials[at] = da;
    partials[at + (size_t)splits * d] = db;
  }
}

// dL/dv_k = (sum over splits of side 0 at bin k and side 1 at bin k - 1) / d,
// in double, in a fixed order: a block takes 32 knots, a lane each; warp w
// sums splits w, w + GRAD_WARPS, ... in order, and lane k of warp 0 adds the
// warps' sums in warp order. (One thread a knot walking every split kept too
// few loads in flight: 0.13-0.16 ms at the recipe's 911 splits.)
__global__ void __launch_bounds__(32 * GRAD_WARPS)
proxy_core_grad_kernel(const double* __restrict__ partials, int splits, int d,
                       float* __restrict__ grad) {
  __shared__ double part[GRAD_WARPS][32];
  const int ex = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x * 32 + lane;
  const double* lo = partials + (size_t)ex * 2 * splits * d;
  const double* hi = lo + (size_t)splits * d;
  double t = 0.0;
  if (k <= d) {
    for (int sp = warp; sp < splits; sp += GRAD_WARPS) {
      if (k < d) t += lo[(size_t)sp * d + k];
      if (k > 0) t += hi[(size_t)sp * d + k - 1];
    }
  }
  part[warp][lane] = t;
  __syncthreads();
  if (warp != 0 || k > d) return;
  double sum = 0.0;
  for (int w = 0; w < GRAD_WARPS; ++w) sum += part[w][lane];
  grad[(size_t)ex * (d + 1) + k] = (float)(sum / d);
}

}  // namespace

extern "C" {

// core[n, m] of knots [n, d+1], x [n, m] and s ([n] if s_per_value == 0,
// else [n, m]), all f32 contiguous, on `stream`. perm (int64 [n, m], or
// null) gives each value's place in core: x is then each example's values
// in sorted order. The bins are cut into `splits` of `split_bins` (the last
// may be shorter); with more than one, `partials` holds n * splits * m
// floats. Adds the pairs walked to *walked unless it is null. Returns
// cudaGetLastError().
int pnnp_proxy_core_fwd(const float* knots, const float* x, const long long* perm,
                        const float* s, int n, int m, int d, int s_per_value, int splits,
                        int split_bins, float* partials, float* core,
                        unsigned long long* walked, void* stream) {
  const dim3 grid((m + FWD_BLOCK_VALUES - 1) / FWD_BLOCK_VALUES, splits, n);
  cudaStream_t st = (cudaStream_t)stream;
  if (s_per_value)
    proxy_core_fwd_kernel<true><<<grid, FWD_THREADS, 0, st>>>(knots, x, perm, s, m, d,
                                                              split_bins, partials, core,
                                                              walked);
  else
    proxy_core_fwd_kernel<false><<<grid, FWD_THREADS, 0, st>>>(knots, x, perm, s, m, d,
                                                               split_bins, partials, core,
                                                               walked);
  if (splits > 1) {
    const dim3 fgrid((m + FINAL_THREADS - 1) / FINAL_THREADS, n);
    proxy_core_sum_kernel<<<fgrid, FINAL_THREADS, 0, st>>>(partials, splits, m, d, core);
  }
  return (int)cudaGetLastError();
}

// grad[n, d+1] = dL/dknots from g = dL/dcore [n, m], on `stream`; x and perm
// as for pnnp_proxy_core_fwd (g is read at each value's place), x sorted
// where s_per_value == 0. The values of each example are cut into `splits`
// of `split_values` (the last may be shorter); `partials` holds n * 2 *
// splits * d doubles. Adds the pairs walked to *walked unless it is null.
// Returns cudaGetLastError() after both launches.
int pnnp_proxy_core_bwd(const float* knots, const float* x, const long long* perm,
                        const float* s, const float* g, int n, int m, int d, int s_per_value,
                        int splits, int split_values, double* partials, float* grad,
                        unsigned long long* walked, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((d + BLOCK_BINS - 1) / BLOCK_BINS, splits, n);
  if (s_per_value)
    proxy_core_bwd_kernel<true><<<grid, BWD_THREADS, 0, st>>>(knots, x, perm, s, g, m, d,
                                                              split_values, partials, walked);
  else
    proxy_core_bwd_kernel<false><<<grid, BWD_THREADS, 0, st>>>(knots, x, perm, s, g, m, d,
                                                               split_values, partials, walked);
  const dim3 fgrid((d + 1 + 31) / 32, n);
  proxy_core_grad_kernel<<<fgrid, 32 * GRAD_WARPS, 0, st>>>(partials, splits, d, grad);
  return (int)cudaGetLastError();
}

}  // extern "C"
