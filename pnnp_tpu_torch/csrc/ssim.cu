// Tiled-reduction SSIM for Hopper (sm_90a), plain C interface for ctypes.
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
// 67 TFLOP/s).
//
// Two routes compute the same function:
//
// * generic (ssim_tile_kernel, any 1 <= C <= 16): each block stages one
//   (TH+6) x (TL+6C) halo tile of x and y in shared memory with coalesced
//   loads, forms the five moments and their vertical 7-row sums there, takes
//   the 7-tap horizontal sums from shared memory, and writes one partial per
//   block. Its floor is shared-memory traffic (~200 B per window) and its
//   load and compute phases do not overlap.
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
// Determinism: no float atomics. Each block reduces in a fixed order (warp
// shuffles, then warps in order) and a second one-block pass sums the
// partials in a fixed order in double, so the metric is bit-identical from
// run to run.

#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int WIN = 7;

// ---- generic route ---------------------------------------------------------

constexpr int TH = 16;                      // output rows per block
constexpr int TL = 128;                     // output lanes per block
constexpr int THREADS = 256;
constexpr int ROW_SPLIT = THREADS / TL;     // row halves per lane column
constexpr int ROWS_PER_THREAD = TH / ROW_SPLIT;
constexpr int FINAL_THREADS = 1024;
constexpr int MAX_C = 16;

static_assert(THREADS % TL == 0 && TH % ROW_SPLIT == 0, "tile shape");

__host__ __device__ inline int tile_cols(int C) { return TL + (WIN - 1) * C; }

inline size_t smem_bytes(int C) {
  const size_t cols = tile_cols(C);
  // x and y halo tiles + five planes of vertical sums
  return sizeof(float) * (2 * (TH + WIN - 1) * cols + 5 * TH * cols);
}

__global__ void __launch_bounds__(THREADS)
ssim_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int H, int L, int C, int Hv, int Lv, float c1, float c2,
                 double* __restrict__ partials) {
  extern __shared__ float smem[];
  const int cols = tile_cols(C);
  const int rows = TH + WIN - 1;
  float* sx = smem;                 // [rows][cols]
  float* sy = sx + rows * cols;     // [rows][cols]
  float* sv = sy + rows * cols;     // [5][TH][cols]
  const int plane = TH * cols;

  const int r0 = blockIdx.y * TH;
  const int l0 = blockIdx.x * TL;
  const int tid = threadIdx.x;

  // 1. Stage the halo tile: consecutive threads read consecutive lanes of a
  //    row. Past the frame edge the tile is zero; those cells only feed
  //    outputs that the mask below drops.
  for (int e = tid; e < rows * cols; e += THREADS) {
    const int i = e / cols, j = e - i * cols;
    const int r = r0 + i, l = l0 + j;
    const bool in = (r < H) && (l < L);
    const size_t off = (size_t)r * L + l;
    sx[e] = in ? x[off] : 0.f;
    sy[e] = in ? y[off] : 0.f;
  }
  __syncthreads();

  // 2. Vertical pass: for each lane column, a sliding 7-row sum of the five
  //    moments x, y, x^2, y^2, xy. Each column's TH output rows are split
  //    into ROW_SPLIT runs so that all threads have work.
  for (int w = tid; w < ROW_SPLIT * cols; w += THREADS) {
    const int half = w / cols, j = w - half * cols;
    const int i0 = half * ROWS_PER_THREAD;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
#pragma unroll
    for (int k = 0; k < WIN; ++k) {
      const float a = sx[(i0 + k) * cols + j], b = sy[(i0 + k) * cols + j];
      s0 += a; s1 += b; s2 += a * a; s3 += b * b; s4 += a * b;
    }
    for (int i = i0; i < i0 + ROWS_PER_THREAD; ++i) {
      if (i > i0) {  // slide: add row i+6, drop row i-1
        const float a = sx[(i + WIN - 1) * cols + j];
        const float b = sy[(i + WIN - 1) * cols + j];
        const float p = sx[(i - 1) * cols + j], q = sy[(i - 1) * cols + j];
        s0 += a - p; s1 += b - q;
        s2 += a * a - p * p; s3 += b * b - q * q; s4 += a * b - p * q;
      }
      const int o = i * cols + j;
      sv[o] = s0; sv[plane + o] = s1; sv[2 * plane + o] = s2;
      sv[3 * plane + o] = s3; sv[4 * plane + o] = s4;
    }
  }
  __syncthreads();

  // 3. Horizontal 7-tap sums at a stride of C lanes, the SSIM map in
  //    registers, masked to valid windows, summed per thread.
  const float n = (float)(WIN * WIN);
  const float cov_norm = n / (n - 1.f);
  const int j = tid % TL;
  const int i0 = (tid / TL) * ROWS_PER_THREAD;
  float acc = 0.f;
  if (l0 + j < Lv) {
    for (int i = i0; i < i0 + ROWS_PER_THREAD && r0 + i < Hv; ++i) {
      float h[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        const float* row = sv + m * plane + i * cols + j;
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < WIN; ++k) t += row[k * C];
        h[m] = t;
      }
      const float ux = h[0] / n, uy = h[1] / n;
      const float uxx = h[2] / n, uyy = h[3] / n, uxy = h[4] / n;
      const float vx = cov_norm * (uxx - ux * ux);
      const float vy = cov_norm * (uyy - uy * uy);
      const float vxy = cov_norm * (uxy - ux * uy);
      const float a1 = 2.f * ux * uy + c1, a2 = 2.f * vxy + c2;
      const float b1 = ux * ux + uy * uy + c1, b2 = vx + vy + c2;
      acc += (a1 * a2) / (b1 * b2);
    }
  }

  // 4. Block reduction in a fixed order: warp shuffles, then warps in order.
  double v = (double)acc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __shared__ double warp_sums[THREADS / 32];
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int wi = 0; wi < THREADS / 32; ++wi) t += warp_sums[wi];
    partials[blockIdx.y * gridDim.x + blockIdx.x] = t;
  }
}

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

dim3 tile_grid(int H, int L, int C) {
  const int Hv = H - (WIN - 1), Lv = (L / C - (WIN - 1)) * C;
  return dim3((Lv + TL - 1) / TL, (Hv + TH - 1) / TH);
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

// The grid is a pure function of the frame: the strip height is the
// shortest (not under MIN_STRIP) that keeps every warp resident in one wave.
Strips strips(int H, int L) {
  const int Hv = H - (WIN - 1), Wv = L / HC - (WIN - 1);
  const int n_cols = (Wv + WARP_OUT - 1) / WARP_OUT;
  const int want = WARP_SLOTS / n_cols > 1 ? WARP_SLOTS / n_cols : 1;
  int rows = (Hv + want - 1) / want;
  if (rows < MIN_STRIP) rows = MIN_STRIP;
  return {rows, (Hv + rows - 1) / rows, n_cols};
}

int strip_blocks(int H, int L) {
  const Strips s = strips(H, L);
  return (s.n_strips * s.n_cols + S_WARPS - 1) / S_WARPS;
}

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

// ---- host side -------------------------------------------------------------

enum Route { GENERIC = 0, HOPPER = 1 };
constexpr int MAX_DEVICES = 64;
std::mutex attr_mutex;
bool attr_set[2][MAX_DEVICES];

// Raise a kernel's dynamic shared-memory limit once per device and process
// (cudaFuncSetAttribute acts on the current device), not on every launch.
cudaError_t allow_smem(int route, const void* fn, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(attr_mutex);
  if (dev < MAX_DEVICES && attr_set[route][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) attr_set[route][dev] = true;
  return err;
}

bool hopper_takes(const float* x, const float* y, int L, int C) {
  return C == HC && L % HC == 0 && (reinterpret_cast<size_t>(x) % 16) == 0 &&
         (reinterpret_cast<size_t>(y) % 16) == 0;
}

}  // namespace

extern "C" {

// Number of per-block partials pnnp_ssim_sum writes for an [H, L] frame on
// `route` (0 generic, 1 hopper).
int pnnp_ssim_num_partials(int H, int L, int C, int route) {
  if (route == HOPPER) return strip_blocks(H, L);
  const dim3 g = tile_grid(H, L, C);
  return (int)(g.x * g.y);
}

// Output rows per strip of the hopper route for an [H, L] frame, C = 4.
int pnnp_ssim_strip_rows(int H, int L) { return strips(H, L).rows; }

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
  const int Hv = H - (WIN - 1);
  int n_partials = 0;
  cudaError_t err;
  if (route == HOPPER) {
    if (!hopper_takes(x, y, L, C)) return (int)cudaErrorInvalidValue;
    err = allow_smem(HOPPER, (const void*)ssim_strip_kernel, ring_bytes());
    if (err != cudaSuccess) return (int)err;
    const Strips st = strips(H, L);
    n_partials = strip_blocks(H, L);
    ssim_strip_kernel<<<n_partials, S_THREADS, ring_bytes(), s>>>(
        reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(y),
        L / HC, Hv, L / HC - (WIN - 1), st, c1, c2, partials);
  } else if (route == GENERIC) {
    err = allow_smem(GENERIC, (const void*)ssim_tile_kernel, smem_bytes(MAX_C));
    if (err != cudaSuccess) return (int)err;
    const dim3 grid = tile_grid(H, L, C);
    const int Lv = (L / C - (WIN - 1)) * C;
    ssim_tile_kernel<<<grid, THREADS, smem_bytes(C), s>>>(x, y, H, L, C, Hv, Lv, c1,
                                                          c2, partials);
    n_partials = (int)(grid.x * grid.y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  ssim_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
