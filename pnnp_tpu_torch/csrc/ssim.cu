// SSIM reduction for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel pnnp_tpu/kernels/ssim.py::_kernel (launched
// by _ssim_call). It computes the same function, not the same blocks: the sum
// of the skimage-compatible SSIM map (uniform 7x7 window, N/(N-1) covariance,
// c1 = (0.01 R)^2, c2 = (0.03 R)^2) over every valid window of a pair of
// channel-interleaved frames x, y: f32, contiguous [H, L] with L = W*C. Lane l
// holds pixel column l / C, channel l % C, so a horizontal step is a stride of
// C lanes and windows never mix channels. Valid outputs are rows r < H-6 and
// lanes l < (W-6)*C; the caller divides by C*(H-6)*(W-6) for the mean.
//
// Bound: the kernel is memory-bound. Reading x and y once is
// 2 * 1424 * 8512 * 4 B ~ 97 MB for a Sony frame, about 29 us at the H100
// SXM's 3.35 TB/s, against roughly 1 GFLOP of fp32 work (about 15 us at
// 67 TFLOP/s); 291 MB, about 87 us, for rgb_quality's sRGB Sony frame
// [2848, 4256, 3] (about 50 us of fp32 work). Both routes read each input
// byte from device memory about once: a warp streams rows through a ring in
// shared memory and keeps the window sums in registers.
//
// * hopper (ssim_strip_kernel, C == 4 with 16-byte aligned rows: the eval
//   path's full frames): one pixel is one float4. A warp walks a strip of
//   output rows over a chunk of 128 pixels; each lane owns P = 4 consecutive
//   pixels (16 lanes). Rows come in by 16-byte cp.async copies, coalesced
//   (each instruction of the warp reads 512 contiguous bytes), two rows ahead
//   into a per-warp ring of 9 rows in shared memory, swizzled so that the
//   copies in and each lane's reads of its own pixels are free of bank
//   conflicts. Four running 7-row sums per lane (x, y, x^2 + y^2, xy) live in
//   registers; the ring gives back the row that leaves the window, and the
//   sums are seeded afresh from it every 8 output rows, so rounding does not
//   grow with the strip. The 7-tap horizontal sums take the 6 pixels to the
//   right from the next two lanes by __shfl_down_sync of partial sums (4
//   shuffles per running sum for 4 windows); lanes 30 and 31 are halo only, so a warp
//   outputs 120 of its 128 pixels. The grid fills the card in one wave (3
//   blocks of 2 warps per SM, limited by the rings), and even strips walk
//   down, odd strips up, so that two strips read their shared 6 halo rows at
//   about the same time and the second read comes from L2.
//
// * generic (ssim_generic_kernel<C>, any 1 <= C <= 16: rgb_quality's sRGB
//   frames at C = 3, and the C = 4 frames hopper does not take): the same
//   design as a template on C (struct Gen), the host switching over C so that
//   the channel loops unroll. A lane owns P consecutive pixels of C channels,
//   P = 4 up to C = 4, 2 up to C = 8, 1 above, so that its P*C <= 16 floats of
//   each running sum stay in registers. A window reaches D = ceil(6 / P)
//   lanes to the right; the last D lanes of a warp are halo only, and a warp
//   outputs OUT <= (32 - D) P of its 32 P pixels (120 at C <= 4), OUT chosen
//   so that every warp column starts on a 16-byte boundary. Rows come in by
//   cp.async two rows ahead into a 9-row ring per warp: 16-byte copies
//   (cp.async.cg) when the row length and the data are 16-byte aligned, as
//   the sRGB frames are, else 4-byte copies (cp.async.ca: odd W*C, unaligned
//   views), zero past the right edge by the copy's source size. A lane reads
//   its own P*C floats as float4 where P*C % 4 == 0 (XOR-swizzled where
//   their stride in float4 is even), else as float2 or float: every stride is
//   then odd and the reads are free of bank conflicts. Four running sums,
//   reseeded every 8 rows, as hopper. Horizontal sums: per-channel suffix
//   sums of the lane's own pixels plus the prefix sums of the next D lanes by
//   __shfl_down_sync (4 shuffles per running sum and channel at P = 4 and 2,
//   6 at P = 1). The 1/n and N/(N-1) factors are folded into constants, the
//   division is rcp.approx (b1 b2 >= c1 c2 > 0), invalid windows are masked
//   by a multiply. Blocks of 2 warps, as many per SM as the rings allow (4 at
//   C = 3, at most 8), the strip height the shortest (not under 16 rows) that
//   keeps every warp resident in one wave; strips alternate direction.
//
// Determinism: no float atomics. Each block reduces in a fixed order (warp
// shuffles, then warps in order) and a second one-block pass sums the
// partials in a fixed order in double, so the metric is bit-identical from
// run to run.

#include <cuda_runtime.h>

#include <array>
#include <mutex>
#include <utility>

namespace {

constexpr int WIN = 7;
constexpr int FINAL_THREADS = 1024;
constexpr int MAX_C = 16;

__global__ void __launch_bounds__(FINAL_THREADS)
ssim_final_kernel(const double* __restrict__ partials, int n, double* __restrict__ out) {
  __shared__ double buf[FINAL_THREADS];
  double t = 0.0;
  for (int i = threadIdx.x; i < n; i += FINAL_THREADS) t += partials[i];
  buf[threadIdx.x] = t;
  __syncthreads();
  for (int s = FINAL_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = buf[0];
}

// ---- hopper route --------------------------------------------------------

constexpr int HC = 4;                     // channels: one pixel is one float4
constexpr int P = 4;                      // pixels per thread
constexpr int CHUNK = 32 * P;             // pixels a warp loads per row
constexpr int WARP_OUT = CHUNK - 2 * P;   // pixels it outputs (lanes 30, 31 are halo)
constexpr int AHEAD = 2;                  // rows in flight
constexpr int SLOTS = WIN + AHEAD;        // ring rows: the window and the rows in flight
constexpr int RESEED = 8;                 // output rows between fresh sums
constexpr int MIN_STRIP = 16;             // shortest strip of output rows
constexpr int S_WARPS = 2;                // warps per block
constexpr int S_THREADS = 32 * S_WARPS;
constexpr int STRIP_BLOCKS_PER_SM = 3;    // as many as the rings' shared memory allows
constexpr int WARP_SLOTS = 132 * STRIP_BLOCKS_PER_SM * S_WARPS;  // H100 SXM: 132 SMs
constexpr int NM = 4;                     // running sums: x, y, x^2 + y^2, xy

static_assert(P == 4 && WARP_OUT + WIN - 1 <= CHUNK,
              "the horizontal pass takes its 6-pixel halo from the next two lanes");

constexpr size_t ring_bytes() { return sizeof(float4) * SLOTS * 2 * CHUNK * S_WARPS; }

struct Strips {
  int rows, n_strips, n_cols;  // output rows per strip, strips, warp columns
};

// A route's grid is a pure function of the frame: the strip height is the
// shortest (not under MIN_STRIP) that keeps every warp resident in one wave.
Strips plan_strips(int Hv, int Wv, int warp_out, int warp_slots) {
  const int n_cols = (Wv + warp_out - 1) / warp_out;
  const int want = warp_slots / n_cols > 1 ? warp_slots / n_cols : 1;
  int rows = (Hv + want - 1) / want;
  if (rows < MIN_STRIP) rows = MIN_STRIP;
  return {rows, (Hv + rows - 1) / rows, n_cols};
}

Strips strips(int H, int L) {
  return plan_strips(H - (WIN - 1), L / HC - (WIN - 1), WARP_OUT, WARP_SLOTS);
}

// Blocks of S_WARPS warps, one warp per strip and warp column, one partial each.
int strip_blocks(const Strips& s) { return (s.n_strips * s.n_cols + S_WARPS - 1) / S_WARPS; }

// A warp's ring holds rows of its chunk, [slot][x|y][CHUNK] float4, pixel p
// at swz(p). The copies in (8 lanes on 8 consecutive pixels) and each lane's
// reads of its own pixels (8 lanes at a stride of P) then both touch 8
// distinct 16-byte bank groups: no bank conflicts.
__device__ __forceinline__ int swz(int p) { return p ^ ((p >> 3) & 7); }

// This thread's P consecutive pixels of one row: pixels lane * P + j.
struct Row {
  float x[P][HC], y[P][HC];
};

// Start copying one row of the warp's chunk (row offset `off` plus the
// chunk's first pixel `col0`, in float4) into ring slot `slot`: 16-byte
// cp.async copies, pixel lane + 32 i, so that each instruction of the warp
// reads 512 contiguous bytes. Zero past the frame's right edge (those pixels
// only feed masked windows). One commit group per row.
__device__ __forceinline__ void fetch_row(float4* ring, int slot, const float4* __restrict__ x,
                                          const float4* __restrict__ y, size_t off, int col0,
                                          int W, int lane) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = lane + 32 * i;
    const bool in = col0 + p < W;
    const size_t g = in ? off + col0 + p : 0;
    const unsigned dx = (unsigned)__cvta_generic_to_shared(ring + (2 * slot) * CHUNK + swz(p));
    const unsigned dy = (unsigned)__cvta_generic_to_shared(ring + (2 * slot + 1) * CHUNK + swz(p));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dx), "l"(x + g),
                 "r"(in ? 16 : 0));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dy), "l"(y + g),
                 "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ring_get(const float4* ring, int slot, Row& r, int lane) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int q = swz(lane * P + j);
    const float4 a = ring[(2 * slot) * CHUNK + q], b = ring[(2 * slot + 1) * CHUNK + q];
    r.x[j][0] = a.x; r.x[j][1] = a.y; r.x[j][2] = a.z; r.x[j][3] = a.w;
    r.y[j][0] = b.x; r.y[j][1] = b.y; r.y[j][2] = b.z; r.y[j][3] = b.w;
  }
}

// s[m][j][c] += moments of r. The SSIM map needs x^2 and y^2 only as their
// sum (in the variance term vx + vy), so four running sums do.
__device__ __forceinline__ void add_moments(float (&s)[NM][P][HC], const Row& r) {
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int c = 0; c < HC; ++c) {
      const float a = r.x[j][c], b = r.y[j][c];
      s[0][j][c] += a;
      s[1][j][c] += b;
      s[2][j][c] = fmaf(b, b, fmaf(a, a, s[2][j][c]));
      s[3][j][c] = fmaf(a, b, s[3][j][c]);
    }
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// The SSIM map of this row's windows over this thread's pixels (mask 1 or 0
// drops the invalid ones), from the vertical sums s.
__device__ __forceinline__ float ssim_row(const float (&s)[NM][P][HC], const float (&mask)[P],
                                          float c1, float c2) {
  // On the raw window sums Sx, Sy, Sq = Sxx + Syy, Sxy, with the 1/n and
  // N/(N-1) factors folded into constants (A = Sx Sy, Q = Sx^2 + Sy^2):
  //   a1 = 2 ux uy + c1      = 2 A / n^2 + c1
  //   b1 = ux^2 + uy^2 + c1  = Q / n^2 + c1
  //   a2 = 2 vxy + c2        = 2 cn (Sxy / n - A / n^2) + c2
  //   b2 = vx + vy + c2      = cn (Sq / n - Q / n^2) + c2
  // b1 b2 >= c1 c2 > 0, so an approximate reciprocal is safe.
  const float n = (float)(WIN * WIN), cn = n / (n - 1.f);
  const float k_a1 = 2.f / (n * n), k_b1 = 1.f / (n * n);
  const float k_a2 = 2.f * cn / n, k_a2q = -2.f * cn / (n * n);
  const float k_b2 = cn / n, k_b2q = -cn / (n * n);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    // Horizontal 7-tap sums: output pixel j of this lane covers its own
    // pixels j..3 (suffix sums), all 4 of the next lane, and pixels 0..j-2 of
    // the lane after (prefix sums), read by shuffles.
    float h[NM][P];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const float v0 = s[m][0][c], v1 = s[m][1][c], v2 = s[m][2][c], v3 = s[m][3][c];
      const float pre1 = v0 + v1, pre2 = pre1 + v2, tot = pre2 + v3;
      const float suf2 = v2 + v3, suf1 = v1 + suf2;
      const float n_pre2 = __shfl_down_sync(0xffffffffu, pre2, 1);
      const float n_tot = __shfl_down_sync(0xffffffffu, tot, 1);
      const float nn_pre0 = __shfl_down_sync(0xffffffffu, v0, 2);
      const float nn_pre1 = __shfl_down_sync(0xffffffffu, pre1, 2);
      h[m][0] = tot + n_pre2;
      h[m][1] = suf1 + n_tot;
      h[m][2] = (suf2 + n_tot) + nn_pre0;
      h[m][3] = (v3 + n_tot) + nn_pre1;
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float sx = h[0][j], sy = h[1][j], sq = h[2][j], sxy = h[3][j];
      const float A = sx * sy, Q = fmaf(sx, sx, sy * sy);
      const float a1 = fmaf(A, k_a1, c1), b1 = fmaf(Q, k_b1, c1);
      const float a2 = fmaf(sxy, k_a2, fmaf(A, k_a2q, c2));
      const float b2 = fmaf(sq, k_b2, fmaf(Q, k_b2q, c2));
      acc = fmaf((a1 * a2) * rcp_approx(b1 * b2), mask[j], acc);
    }
  }
  return acc;
}

// One warp walks one strip of one warp column, S_WARPS warps per block in
// grid order; one partial per block.
__global__ void __launch_bounds__(S_THREADS, STRIP_BLOCKS_PER_SM)
ssim_strip_kernel(const float4* __restrict__ x, const float4* __restrict__ y,
                  int W, int Hv, int Wv, Strips st, float c1, float c2,
                  double* __restrict__ partials) {
  extern __shared__ float4 rings[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4* ring = rings + warp * SLOTS * 2 * CHUNK;
  const int g = blockIdx.x * S_WARPS + warp;
  double acc = 0.0;
  if (g < st.n_strips * st.n_cols) {  // uniform across the warp
    const int strip = g / st.n_cols, col = g - strip * st.n_cols;
    const int o0 = strip * st.rows;
    const int n_in = min(st.rows, Hv - o0) + (WIN - 1);  // input rows o0 .. o0+n_in-1
    // Even strips walk down, odd strips up: neighbours meet at their shared
    // halo rows at about the same time, so the second read comes from L2.
    const bool up = strip & 1;
    const int r0 = up ? o0 + n_in - 1 : o0, dr = up ? -1 : 1;
    const int col0 = col * WARP_OUT;
    float mask[P];
#pragma unroll
    for (int j = 0; j < P; ++j)
      mask[j] = lane < 32 - 2 && col0 + lane * P + j < Wv ? 1.f : 0.f;
    float s[NM][P][HC];
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int j = 0; j < P; ++j)
#pragma unroll
        for (int c = 0; c < HC; ++c) s[m][j][c] = 0.f;

    // Step k takes input row k of the strip (ring slot k % SLOTS) into the
    // window; rows k+1 and k+2 are in flight meanwhile.
    fetch_row(ring, 0, x, y, (size_t)r0 * W, col0, W, lane);
    fetch_row(ring, 1, x, y, (size_t)(r0 + dr) * W, col0, W, lane);
    for (int k = 0; k < n_in; ++k) {
      if (k + 1 < n_in)
        asm volatile("cp.async.wait_group 1;\n" ::);
      else
        asm volatile("cp.async.wait_group 0;\n" ::);
      __syncwarp();  // row k is in, from every lane's copies
      const bool seed = k >= WIN - 1 && (k - (WIN - 1)) % RESEED == 0;
      const bool slide = k >= WIN && !seed;
      Row cur, old;
      if (slide) {  // add row k, drop row k-7
        ring_get(ring, k % SLOTS, cur, lane);
        ring_get(ring, (k - WIN) % SLOTS, old, lane);
      }
      if (seed) {  // fresh sums over rows k-6..k, oldest first
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int j = 0; j < P; ++j)
#pragma unroll
            for (int c = 0; c < HC; ++c) s[m][j][c] = 0.f;
#pragma unroll 1
        for (int t = k - (WIN - 1); t <= k; ++t) {
          Row r;
          ring_get(ring, t % SLOTS, r, lane);
          add_moments(s, r);
        }
      }
      __syncwarp();  // every lane has read row k-7 before its slot is refilled
      if (k + AHEAD < n_in)
        fetch_row(ring, (k + AHEAD) % SLOTS, x, y, (size_t)(r0 + (k + AHEAD) * dr) * W, col0,
                  W, lane);
      if (slide) {
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
          for (int c = 0; c < HC; ++c) {
            const float a = cur.x[j][c], b = cur.y[j][c];
            const float p = old.x[j][c], q = old.y[j][c];
            s[0][j][c] = (s[0][j][c] + a) - p;
            s[1][j][c] = (s[1][j][c] + b) - q;
            s[2][j][c] = fmaf(-q, q, fmaf(-p, p, fmaf(b, b, fmaf(a, a, s[2][j][c]))));
            s[3][j][c] = fmaf(-p, q, fmaf(a, b, s[3][j][c]));
          }
      }
      if (k >= WIN - 1) acc += (double)ssim_row(s, mask, c1, c2);
    }
  }

  // Block reduction in a fixed order: warp shuffles, then warps in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ double warp_sums[S_WARPS];
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int wi = 0; wi < S_WARPS; ++wi) t += warp_sums[wi];
    partials[blockIdx.x] = t;
  }
}

// ---- generic route -------------------------------------------------------

constexpr int SMS = 132;                  // H100 SXM
constexpr int SMEM_PER_SM = 233472;       // 228 KB of shared memory per SM
constexpr int SMEM_RESERVED = 1024;       // the runtime's share of each block
constexpr int G_MAX_BLOCKS_PER_SM = 8;

// The generic route's shape for C channels, all at compile time.
template <int C>
struct Gen {
  static constexpr int P = C <= 4 ? 4 : C <= 8 ? 2 : 1;  // pixels per lane
  static constexpr int PC = P * C;                        // floats per lane, row and array
  static constexpr int D = (P + WIN - 2) / P;             // lanes a window reaches: ceil(6 / P)
  static constexpr int CF = 32 * PC;                      // floats per warp, row and array
  // Output pixels per warp: at most (32 - D) P, a multiple of ALIGN so that
  // each warp column's first float is 16-byte aligned in a 16-byte aligned row.
  static constexpr int ALIGN = C % 4 == 0 ? 1 : C % 2 == 0 ? 2 : 4;
  static constexpr int OUT = (32 - D) * P / ALIGN * ALIGN;
  static constexpr int V = PC % 4 == 0 ? 4 : PC % 2 == 0 ? 2 : 1;  // floats per shared read
  static constexpr bool SWZ = V == 4 && (PC / 4) % 2 == 0;
  static constexpr int AHEAD = 2;                         // rows in flight
  static constexpr int SLOTS = WIN + AHEAD;               // ring rows
  static constexpr int SMEM = (int)sizeof(float) * SLOTS * 2 * CF * S_WARPS;  // per block
  static constexpr int FIT =
      SMEM_PER_SM / (SMEM + SMEM_RESERVED + (int)sizeof(double) * S_WARPS);
  static constexpr int BLOCKS_PER_SM = FIT < G_MAX_BLOCKS_PER_SM ? FIT : G_MAX_BLOCKS_PER_SM;
  static constexpr int WARP_SLOTS = SMS * BLOCKS_PER_SM * S_WARPS;

  static_assert(PC <= 16 && OUT + WIN - 1 <= 32 * P && OUT * C % 4 == 0, "lane shape");

  // Ring position of float4 v of a row: an XOR within each aligned group of
  // 8 when the lanes' float4 stride is even (2 or 4), else none.
  static __device__ __forceinline__ int swz(int v) { return SWZ ? v ^ ((v >> 3) & 7) : v; }
};

// Start copying one row of the warp's chunk (row offset `off` plus the
// chunk's first float, `left` floats to the row's end) into ring slot `slot`.
// 16-byte copies: float4 lane + 32 i, each instruction of the warp on 512
// contiguous bytes; else 4-byte copies, float lane + 32 i. Zero past the
// row's end (those pixels only feed masked windows).
template <int C>
__device__ __forceinline__ void gen_fetch(float* ring, int slot, const float* __restrict__ x,
                                          const float* __restrict__ y, size_t off, int left,
                                          bool vec16, int lane) {
  using G = Gen<C>;
  float* dx = ring + (2 * slot) * G::CF;
  float* dy = dx + G::CF;
  if (vec16) {
    constexpr int NV = G::CF / 4;
#pragma unroll
    for (int i = 0; i < (NV + 31) / 32; ++i) {
      const int v = lane + 32 * i;
      if (NV % 32 == 0 || v < NV) {
        const bool in = 4 * v < left;
        const size_t g = in ? off + 4 * v : 0;
        const unsigned sx = (unsigned)__cvta_generic_to_shared(dx + 4 * G::swz(v));
        const unsigned sy = (unsigned)__cvta_generic_to_shared(dy + 4 * G::swz(v));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sx), "l"(x + g),
                     "r"(in ? 16 : 0));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sy), "l"(y + g),
                     "r"(in ? 16 : 0));
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < G::PC; ++i) {
      const int f = lane + 32 * i;
      const bool in = f < left;
      const size_t g = in ? off + f : 0;
      const int q = 4 * G::swz(f >> 2) + (f & 3);
      const unsigned sx = (unsigned)__cvta_generic_to_shared(dx + q);
      const unsigned sy = (unsigned)__cvta_generic_to_shared(dy + q);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sx), "l"(x + g),
                   "r"(in ? 4 : 0));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sy), "l"(y + g),
                   "r"(in ? 4 : 0));
    }
  }
}

// This lane's P pixels of one row, pixel j channel c at [j * C + c].
template <int C>
struct GRow {
  float x[Gen<C>::PC], y[Gen<C>::PC];
};

template <int C>
__device__ __forceinline__ void gen_get(const float* ring, int slot, GRow<C>& r, int lane) {
  using G = Gen<C>;
  const float* sx = ring + (2 * slot) * G::CF;
  const float* sy = sx + G::CF;
  if constexpr (G::V == 4) {
#pragma unroll
    for (int t = 0; t < G::PC / 4; ++t) {
      const int q = 4 * G::swz(lane * (G::PC / 4) + t);
      const float4 a = *reinterpret_cast<const float4*>(sx + q);
      const float4 b = *reinterpret_cast<const float4*>(sy + q);
      r.x[4 * t] = a.x; r.x[4 * t + 1] = a.y; r.x[4 * t + 2] = a.z; r.x[4 * t + 3] = a.w;
      r.y[4 * t] = b.x; r.y[4 * t + 1] = b.y; r.y[4 * t + 2] = b.z; r.y[4 * t + 3] = b.w;
    }
  } else if constexpr (G::V == 2) {
#pragma unroll
    for (int t = 0; t < G::PC / 2; ++t) {
      const int q = 2 * (lane * (G::PC / 2) + t);
      const float2 a = *reinterpret_cast<const float2*>(sx + q);
      const float2 b = *reinterpret_cast<const float2*>(sy + q);
      r.x[2 * t] = a.x; r.x[2 * t + 1] = a.y;
      r.y[2 * t] = b.x; r.y[2 * t + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < G::PC; ++t) {
      r.x[t] = sx[lane * G::PC + t];
      r.y[t] = sy[lane * G::PC + t];
    }
  }
}

// Whether the horizontal pass needs prefix sum i of lane + d (P pixels a
// lane): some output pixel j's window j .. j+6 ends at pixel i of that lane
// (or covers it whole, i = P-1).
template <int P>
__host__ __device__ constexpr bool gen_needs(int d, int i) {
  for (int j = 0; j < P; ++j) {
    const int e = j + WIN - 1 - d * P;
    if (e >= 0 && (e < P - 1 ? e : P - 1) == i) return true;
  }
  return false;
}

// The SSIM map of this row's windows over this lane's pixels (mask 1 or 0
// drops the invalid ones), from the vertical sums s; the formula is
// ssim_row's.
template <int C>
__device__ __forceinline__ float gen_row(const float (&s)[NM][Gen<C>::PC],
                                         const float (&mask)[Gen<C>::P], float c1, float c2) {
  using G = Gen<C>;
  constexpr int P = G::P, D = G::D;
  const float n = (float)(WIN * WIN), cn = n / (n - 1.f);
  const float k_a1 = 2.f / (n * n), k_b1 = 1.f / (n * n);
  const float k_a2 = 2.f * cn / n, k_a2q = -2.f * cn / (n * n);
  const float k_b2 = cn / n, k_b2q = -cn / (n * n);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // Output pixel j of this lane covers its own pixels j .. P-1 (suffix
    // sums) and, for d = 1 .. D, pixels 0 .. j+6-dP of lane + d (that lane's
    // prefix sums, by shuffles; the whole lane where j+6-dP >= P-1).
    float h[NM][P];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float pre[P], suf[P];
      pre[0] = s[m][c];
#pragma unroll
      for (int j = 1; j < P; ++j) pre[j] = pre[j - 1] + s[m][j * C + c];
      suf[P - 1] = s[m][(P - 1) * C + c];
#pragma unroll
      for (int j = P - 2; j >= 0; --j) suf[j] = s[m][j * C + c] + suf[j + 1];
      float nb[D + 1][P];
#pragma unroll
      for (int d = 1; d <= D; ++d)
#pragma unroll
        for (int i = 0; i < P; ++i)
          nb[d][i] = gen_needs<P>(d, i) ? __shfl_down_sync(0xffffffffu, pre[i], d) : 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float t = suf[j];
#pragma unroll
        for (int d = 1; d <= D; ++d) {
          const int e = j + WIN - 1 - d * P;
          if (e >= 0) t += nb[d][e < P - 1 ? e : P - 1];
        }
        h[m][j] = t;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float sx = h[0][j], sy = h[1][j], sq = h[2][j], sxy = h[3][j];
      const float A = sx * sy, Q = fmaf(sx, sx, sy * sy);
      const float a1 = fmaf(A, k_a1, c1), b1 = fmaf(Q, k_b1, c1);
      const float a2 = fmaf(sxy, k_a2, fmaf(A, k_a2q, c2));
      const float b2 = fmaf(sq, k_b2, fmaf(Q, k_b2q, c2));
      acc = fmaf((a1 * a2) * rcp_approx(b1 * b2), mask[j], acc);
    }
  }
  return acc;
}

// One warp walks one strip of one warp column, S_WARPS warps per block in
// grid order; one partial per block. `vec16`: 16-byte copies (L % 4 == 0 and
// x, y 16-byte aligned), uniform over the grid.
template <int C>
__global__ void __launch_bounds__(S_THREADS, Gen<C>::BLOCKS_PER_SM)
ssim_generic_kernel(const float* __restrict__ x, const float* __restrict__ y, int L, int Hv,
                    int Wv, Strips st, bool vec16, float c1, float c2,
                    double* __restrict__ partials) {
  using G = Gen<C>;
  constexpr int P = G::P, PC = G::PC, SLOTS = G::SLOTS, AHEAD = G::AHEAD;
  extern __shared__ float4 rings[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* ring = reinterpret_cast<float*>(rings) + warp * SLOTS * 2 * G::CF;
  const int g = blockIdx.x * S_WARPS + warp;
  double acc = 0.0;
  if (g < st.n_strips * st.n_cols) {  // uniform across the warp
    const int strip = g / st.n_cols, col = g - strip * st.n_cols;
    const int o0 = strip * st.rows;
    const int n_in = min(st.rows, Hv - o0) + (WIN - 1);  // input rows o0 .. o0+n_in-1
    // Even strips walk down, odd strips up, as in ssim_strip_kernel.
    const bool up = strip & 1;
    const int r0 = up ? o0 + n_in - 1 : o0, dr = up ? -1 : 1;
    const int col0 = col * G::OUT;
    const size_t f0 = (size_t)col0 * C;
    const int left = L - (int)f0;
    float mask[P];
#pragma unroll
    for (int j = 0; j < P; ++j)
      mask[j] = lane * P + j < G::OUT && col0 + lane * P + j < Wv ? 1.f : 0.f;
    float s[NM][PC];
#pragma unroll
    for (int m = 0; m < NM; ++m)
#pragma unroll
      for (int e = 0; e < PC; ++e) s[m][e] = 0.f;

    // Step k takes input row k of the strip (ring slot k % SLOTS) into the
    // window; rows k+1 .. k+AHEAD are in flight meanwhile. Every step commits
    // one copy group (empty past the strip's end), so "all but the newest
    // AHEAD-1 groups done" always means "row k is in".
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) {
      gen_fetch<C>(ring, a, x, y, (size_t)(r0 + a * dr) * L + f0, left, vec16, lane);
      asm volatile("cp.async.commit_group;\n" ::);
    }
    for (int k = 0; k < n_in; ++k) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1));
      __syncwarp();  // row k is in, from every lane's copies
      const bool seed = k >= WIN - 1 && (k - (WIN - 1)) % RESEED == 0;
      const bool slide = k >= WIN && !seed;
      GRow<C> cur, old;
      if (slide) {  // add row k, drop row k-7
        gen_get<C>(ring, k % SLOTS, cur, lane);
        gen_get<C>(ring, (k - WIN) % SLOTS, old, lane);
      }
      if (seed) {  // fresh sums over rows k-6..k, oldest first
#pragma unroll
        for (int m = 0; m < NM; ++m)
#pragma unroll
          for (int e = 0; e < PC; ++e) s[m][e] = 0.f;
#pragma unroll 1
        for (int t = k - (WIN - 1); t <= k; ++t) {
          GRow<C> r;
          gen_get<C>(ring, t % SLOTS, r, lane);
#pragma unroll
          for (int e = 0; e < PC; ++e) {
            const float a = r.x[e], b = r.y[e];
            s[0][e] += a;
            s[1][e] += b;
            s[2][e] = fmaf(b, b, fmaf(a, a, s[2][e]));
            s[3][e] = fmaf(a, b, s[3][e]);
          }
        }
      }
      __syncwarp();  // every lane has read row k-7 before its slot is refilled
      if (k + AHEAD < n_in)
        gen_fetch<C>(ring, (k + AHEAD) % SLOTS, x, y, (size_t)(r0 + (k + AHEAD) * dr) * L + f0,
                     left, vec16, lane);
      asm volatile("cp.async.commit_group;\n" ::);
      if (slide) {
#pragma unroll
        for (int e = 0; e < PC; ++e) {
          const float a = cur.x[e], b = cur.y[e];
          const float p = old.x[e], q = old.y[e];
          s[0][e] = (s[0][e] + a) - p;
          s[1][e] = (s[1][e] + b) - q;
          s[2][e] = fmaf(-q, q, fmaf(-p, p, fmaf(b, b, fmaf(a, a, s[2][e]))));
          s[3][e] = fmaf(-p, q, fmaf(a, b, s[3][e]));
        }
      }
      if (k >= WIN - 1) acc += (double)gen_row<C>(s, mask, c1, c2);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
  }

  // Block reduction in a fixed order: warp shuffles, then warps in order.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ double warp_sums[S_WARPS];
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int wi = 0; wi < S_WARPS; ++wi) t += warp_sums[wi];
    partials[blockIdx.x] = t;
  }
}

// ---- host side -------------------------------------------------------------

enum Route { GENERIC = 0, HOPPER = 1 };
constexpr int MAX_DEVICES = 64;
std::mutex attr_mutex;
bool attr_set[MAX_C + 1][MAX_DEVICES];  // [0] hopper, [C] generic at C

// Raise a kernel's dynamic shared-memory limit once per device and process
// (cudaFuncSetAttribute acts on the current device), not on every launch.
cudaError_t allow_smem(int kernel, const void* fn, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(attr_mutex);
  if (dev < MAX_DEVICES && attr_set[kernel][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) attr_set[kernel][dev] = true;
  return err;
}

bool hopper_takes(const float* x, const float* y, int L, int C) {
  return C == HC && L % HC == 0 && (reinterpret_cast<size_t>(x) % 16) == 0 &&
         (reinterpret_cast<size_t>(y) % 16) == 0;
}

template <int C>
Strips gen_strips(int H, int L) {
  return plan_strips(H - (WIN - 1), L / C - (WIN - 1), Gen<C>::OUT, Gen<C>::WARP_SLOTS);
}

template <int C>
int gen_partials(int H, int L) { return strip_blocks(gen_strips<C>(H, L)); }

template <int C>
int gen_launch(const float* x, const float* y, int H, int L, float c1, float c2,
               double* partials, cudaStream_t s) {
  const cudaError_t err =
      allow_smem(C, (const void*)ssim_generic_kernel<C>, Gen<C>::SMEM);
  if (err != cudaSuccess) return -(int)err;
  const Strips st = gen_strips<C>(H, L);
  const int n = strip_blocks(st);
  const bool vec16 = L % 4 == 0 && (reinterpret_cast<size_t>(x) % 16) == 0 &&
                     (reinterpret_cast<size_t>(y) % 16) == 0;
  ssim_generic_kernel<C><<<n, S_THREADS, Gen<C>::SMEM, s>>>(
      x, y, L, H - (WIN - 1), L / C - (WIN - 1), st, vec16, c1, c2, partials);
  return n;
}

// Blocks of a kernel that the runtime keeps resident on one SM of the
// current device, at `smem` dynamic bytes; -1 on an error.
int resident_blocks(int kernel, const void* fn, size_t smem) {
  int n = 0;
  if (allow_smem(kernel, fn, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, S_THREADS, smem) != cudaSuccess)
    return -1;
  return n;
}

template <int C>
int gen_occupancy() {
  return resident_blocks(C, (const void*)ssim_generic_kernel<C>, Gen<C>::SMEM);
}

// The generic route's entries, indexed by C - 1: the host's switch over C.
struct GenEntry {
  int (*partials)(int, int);
  int (*launch)(const float*, const float*, int, int, float, float, double*, cudaStream_t);
  int (*occupancy)();
};

template <int... Cs>
constexpr std::array<GenEntry, MAX_C> gen_table(std::integer_sequence<int, Cs...>) {
  return {{GenEntry{gen_partials<Cs + 1>, gen_launch<Cs + 1>, gen_occupancy<Cs + 1>}...}};
}

constexpr std::array<GenEntry, MAX_C> GEN = gen_table(std::make_integer_sequence<int, MAX_C>{});

}  // namespace

extern "C" {

// Number of per-block partials pnnp_ssim_sum writes for an [H, L] frame on
// `route` (0 generic, 1 hopper); 0 for a C the route does not take.
int pnnp_ssim_num_partials(int H, int L, int C, int route) {
  if (route == HOPPER) return strip_blocks(strips(H, L));
  if (route == GENERIC && 1 <= C && C <= MAX_C) return GEN[C - 1].partials(H, L);
  return 0;
}

// Output rows per strip of the hopper route for an [H, L] frame, C = 4.
int pnnp_ssim_strip_rows(int H, int L) { return strips(H, L).rows; }

// Blocks of a route's kernel at C that the runtime keeps resident on one SM
// of the current device (the grid plans for 3 hopper blocks and
// Gen<C>::BLOCKS_PER_SM generic ones); -1 on an error or a C out of range.
int pnnp_ssim_blocks_per_sm(int C, int route) {
  if (route == GENERIC && 1 <= C && C <= MAX_C) return GEN[C - 1].occupancy();
  if (route == HOPPER) return resident_blocks(0, (const void*)ssim_strip_kernel, ring_bytes());
  return -1;
}

// Sum of the SSIM map over all valid windows into out[0] (double), on
// `stream`, by `route` (0 generic, 1 hopper). `partials` holds
// pnnp_ssim_num_partials(H, L, C, route) doubles. The caller guarantees
// H >= 7, L % C == 0, L / C >= 7, 1 <= C <= 16; the hopper route also needs
// C == 4 and 16-byte aligned x and y (else cudaErrorInvalidValue). Returns
// cudaGetLastError() after both launches (0 on success).
int pnnp_ssim_sum(const float* x, const float* y, int H, int L, int C,
                  float c1, float c2, int route, double* partials, double* out,
                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int n_partials = 0;
  if (route == HOPPER) {
    if (!hopper_takes(x, y, L, C)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(0, (const void*)ssim_strip_kernel, ring_bytes());
    if (err != cudaSuccess) return (int)err;
    const Strips st = strips(H, L);
    n_partials = strip_blocks(st);
    ssim_strip_kernel<<<n_partials, S_THREADS, ring_bytes(), s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
        L / HC, H - (WIN - 1), L / HC - (WIN - 1), st, c1, c2, partials);
  } else if (route == GENERIC && 1 <= C && C <= MAX_C) {
    n_partials = GEN[C - 1].launch(x, y, H, L, c1, c2, partials, s);
    if (n_partials < 0) return -n_partials;  // the shared-memory attribute's error
  } else {
    return (int)cudaErrorInvalidValue;
  }
  ssim_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
