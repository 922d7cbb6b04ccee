// K1: batched (feature, bin) histogram of w*y plus the stopping-rule scalars.
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_scan.py::edge_scan
// (body _edge_scan_kernel), which the JAX scanner launches once per worker
// under vmap. Here the worker axis is a grid axis: one launch per round
// scans the current chunk of all W workers.
//
//   hist[w, j, b] = sum_i wy[w, i] * [xb[w, i, j] == b]
//   scal[0, w] = sum_i |w[w, i]|,  scal[1, w] = sum_i w^2,  scal[2, w] = sum_i wy
//
// What bounds it on an H100: bytes. Each xb element (4 B) feeds B predicated
// adds, so at B = 8 the kernel does 2 operations per byte read, far below the
// card's ~20 fp32 operations per byte of HBM bandwidth. The work is reading
// xb once, coalesced.
//
// Design:
//   * grid (row tiles, W); a block of 256 threads is laid out (features x
//     row groups), so the 32 lanes of a warp read 32 neighbouring xb[i, j]
//     of one row: one 128-byte transaction per warp per row;
//   * each thread keeps its B bin sums in registers and adds wy with a
//     predicated add per bin (the one-hot idea of the TPU kernel, without a
//     matrix unit); bins outside [0, B) add nothing;
//   * no float atomics anywhere: the row groups are summed in a fixed order
//     through shared memory, the tile's partial goes to scratch, and a second
//     launch sums the tiles in a fixed order. The result is bitwise the same
//     on every launch with the same inputs, which the engine's
//     "sparse == dense" bit-exactness check on the card relies on.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int BP>
__global__ void edge_scan_tiles(const int* __restrict__ xb, const float* __restrict__ wy,
                                const float* __restrict__ w, int n, int d, int B, int tile_n,
                                float* __restrict__ part_hist, float* __restrict__ part_scal) {
  extern __shared__ float smem[];
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int wk = blockIdx.y;
  const int row0 = tile * tile_n;
  const int row1 = min(row0 + tile_n, n);
  const int* xbw = xb + (size_t)wk * n * d;
  const float* wyw = wy + (size_t)wk * n;
  const float* ww = w + (size_t)wk * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nx = blockDim.x, ny = blockDim.y;
  const int tid = ty * nx + tx;

  for (int j0 = 0; j0 < d; j0 += nx) {
    const int j = j0 + tx;
    float acc[BP];
#pragma unroll
    for (int b = 0; b < BP; ++b) acc[b] = 0.f;
    if (j < d) {
      for (int i = row0 + ty; i < row1; i += ny) {
        const int bin = xbw[(size_t)i * d + j];
        const float v = wyw[i];
#pragma unroll
        for (int b = 0; b < BP; ++b) acc[b] += (bin == b) ? v : 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < BP; ++b) smem[tid * BP + b] = acc[b];
    __syncthreads();
    if (ty == 0 && j < d) {
      float* out = part_hist + (((size_t)wk * tiles + tile) * d + j) * B;
      for (int b = 0; b < B; ++b) {
        float s = 0.f;
        for (int k = 0; k < ny; ++k) s += smem[(k * nx + tx) * BP + b];
        out[b] = s;
      }
    }
    __syncthreads();
  }

  // stopping-rule scalars: one row per thread, then a fixed-shape tree
  float sw = 0.f, sv = 0.f, st = 0.f;
  for (int i = row0 + tid; i < row1; i += kThreads) {
    const float wi = ww[i];
    sw += fabsf(wi);
    sv += __fmul_rn(wi, wi);
    st += wyw[i];
  }
  float* s0 = smem;
  float* s1 = smem + kThreads;
  float* s2 = smem + 2 * kThreads;
  s0[tid] = sw;
  s1[tid] = sv;
  s2[tid] = st;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      s0[tid] += s0[tid + s];
      s1[tid] += s1[tid + s];
      s2[tid] += s2[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    float* out = part_scal + ((size_t)wk * tiles + tile) * 3;
    out[0] = s0[0];
    out[1] = s1[0];
    out[2] = s2[0];
  }
}

__global__ void edge_scan_finish(const float* __restrict__ part_hist,
                                 const float* __restrict__ part_scal, int tiles, int cells,
                                 int W, float* __restrict__ hist, float* __restrict__ scal) {
  const int wk = blockIdx.x;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const float* p = part_hist + (size_t)wk * tiles * cells + c;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += p[(size_t)t * cells];
    hist[(size_t)wk * cells + c] = s;
  }
  if (threadIdx.x < 3) {
    const float* p = part_scal + (size_t)wk * tiles * 3 + threadIdx.x;
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += p[(size_t)t * 3];
    scal[(size_t)threadIdx.x * W + wk] = s;
  }
}

template <int BP>
cudaError_t launch_tiles(dim3 grid, dim3 block, cudaStream_t stream, const int* xb,
                         const float* wy, const float* w, int n, int d, int B, int tile_n,
                         float* part_hist, float* part_scal) {
  size_t words = (size_t)kThreads * BP;
  if (words < 3 * (size_t)kThreads) words = 3 * (size_t)kThreads;
  edge_scan_tiles<BP><<<grid, block, words * sizeof(float), stream>>>(
      xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  return cudaGetLastError();
}

}  // namespace

// xb (W, n, d) int32, wy/w (W, n) f32 -> hist (W, d, B) f32, scal (3, W) f32.
// Scratch: part_hist (W, tiles, d, B), part_scal (W, tiles, 3) with
// tiles = max(1, ceil(n / tile_n)). Requires 1 <= B <= 32, W >= 1.
extern "C" int edge_scan_launch(const int* xb, const float* wy, const float* w,
                                float* part_hist, float* part_scal, float* hist, float* scal,
                                int W, int n, int d, int B, int tile_n, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int tiles = n > 0 ? (n + tile_n - 1) / tile_n : 1;
  int nx = 32;
  while (nx < d && nx < kThreads) nx *= 2;
  dim3 block(nx, kThreads / nx);
  dim3 grid(tiles, W);
  cudaError_t err;
  if (B <= 2) {
    err = launch_tiles<2>(grid, block, stream, xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  } else if (B <= 4) {
    err = launch_tiles<4>(grid, block, stream, xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  } else if (B <= 8) {
    err = launch_tiles<8>(grid, block, stream, xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  } else if (B <= 16) {
    err = launch_tiles<16>(grid, block, stream, xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  } else {
    err = launch_tiles<32>(grid, block, stream, xb, wy, w, n, d, B, tile_n, part_hist, part_scal);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_scan_finish<<<W, kThreads, 0, stream>>>(part_hist, part_scal, tiles, d * B, W, hist, scal);
  return static_cast<int>(cudaGetLastError());
}
