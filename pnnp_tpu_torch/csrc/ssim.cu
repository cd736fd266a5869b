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
// 67 TFLOP/s). The tiling keeps every intermediate out of device memory:
// each block stages one (TH+6) x (TL+6C) halo tile of x and y in shared
// memory with coalesced loads, forms the five moments and their vertical
// 7-row sums there, takes the 7-tap horizontal sums from shared memory, and
// writes one partial per block. Device traffic is the two inputs plus the
// halo re-read ((TH+6)/TH rows, mostly served by L2) and 8 bytes per block.
//
// Determinism: no float atomics. Each block reduces in a fixed order (warp
// shuffles, then warps in order) and a second one-block pass sums the
// partials in a fixed order in double, so the metric is bit-identical from
// run to run.

#include <cuda_runtime.h>

namespace {

constexpr int WIN = 7;
constexpr int TH = 16;                      // output rows per block
constexpr int TL = 128;                     // output lanes per block
constexpr int THREADS = 256;
constexpr int ROW_SPLIT = THREADS / TL;     // row halves per lane column
constexpr int ROWS_PER_THREAD = TH / ROW_SPLIT;
constexpr int FINAL_THREADS = 1024;

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

}  // namespace

extern "C" {

// Number of per-block partials pnnp_ssim_sum writes for an [H, L] frame.
int pnnp_ssim_num_partials(int H, int L, int C) {
  const dim3 g = tile_grid(H, L, C);
  return (int)(g.x * g.y);
}

// Sum of the SSIM map over all valid windows into out[0] (double), on
// `stream`. `partials` holds pnnp_ssim_num_partials(H, L, C) doubles. The
// caller guarantees H >= 7, L % C == 0, L / C >= 7, 1 <= C <= 16. Returns
// cudaGetLastError() after both launches (0 on success).
int pnnp_ssim_sum(const float* x, const float* y, int H, int L, int C,
                  float c1, float c2, double* partials, double* out,
                  void* stream) {
  const dim3 grid = tile_grid(H, L, C);
  const size_t smem = smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      ssim_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const int Hv = H - (WIN - 1), Lv = (L / C - (WIN - 1)) * C;
  ssim_tile_kernel<<<grid, THREADS, smem, s>>>(x, y, H, L, C, Hv, Lv, c1, c2,
                                               partials);
  ssim_final_kernel<<<1, FINAL_THREADS, 0, s>>>(partials, (int)(grid.x * grid.y), out);
  return (int)cudaGetLastError();
}

}  // extern "C"
