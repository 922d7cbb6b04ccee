// K4: fused incremental margin + weight refresh over a model slice.
//
// Replaces the Pallas TPU kernel src/repro/kernels/weight_update.py::weight_update
// (body _weight_update_kernel), reached through ops.weight_update with the
// (A, c) that kernels/weight_update.py::scatter_model_slice builds:
//
//   delta_i  = 2 * sum_{j, t} [xb[i, j] > t] * A[j, t] - c
//   margin'_i = margin_l_i + delta_i
//   w_i      = exp(clip(-y_i * (margin'_i - margin_s_i), -30, 30))
//
// What bounds it on an H100: bytes. Each row reads d int32 bins (256 B at
// d = 64) and 12 B of floats and writes 8 B; the arithmetic is d table
// lookups and adds per row, far below the card's operations per byte.
//
// Design (the TPU kernel's one-hot matmul is not carried over):
//   * the coefficient table is staged in shared memory as per-feature prefix
//     sums S[j][b] = sum_{t < b} A[j, t], b in [0, B): a row's delta is then
//     2 * sum_j S[j][clamp(xb[i, j], 0, B-1)] - c, one lookup per feature.
//     The clamp gives the reference's semantics for bins outside [0, B):
//     xb >= B-1 turns every cut on, xb <= 0 none;
//   * S and the row sums are kept in double, so the kernel's result differs
//     from the float32 reference only by the reference's own rounding;
//   * a block of tile_rows threads stages tile_rows rows of xb in shared
//     memory with coalesced 16-byte loads (when d % 4 == 0 and xb is 16-byte
//     aligned), at an odd row stride so that one-thread-per-row reads hit 32
//     different banks;
//   * one thread sums one row and applies the weight epilogue. No atomics
//     at all: two launches on the same inputs give the same bits;
//   * c is read through a device pointer: nothing syncs the host.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__global__ void weight_update_kernel(const int* __restrict__ xb, const float* __restrict__ y,
                                     const float* __restrict__ ml, const float* __restrict__ ms,
                                     const float* __restrict__ a, const float* __restrict__ c,
                                     int n, int d, int B, int stride, int vec,
                                     float* __restrict__ m_out, float* __restrict__ w_out) {
  extern __shared__ double smem[];
  double* S = smem;                                        // (d, B) prefix sums
  int* tile = reinterpret_cast<int*>(smem + (size_t)d * B);  // (blockDim.x, stride) bins
  const int tid = threadIdx.x;
  const int cuts = B - 1;

  for (int j = tid; j < d; j += blockDim.x) {
    double acc = 0.0;
    S[(size_t)j * B] = 0.0;
    for (int t = 0; t < cuts; ++t) {
      acc += (double)a[(size_t)j * cuts + t];
      S[(size_t)j * B + t + 1] = acc;
    }
  }

  const long long row0 = (long long)blockIdx.x * blockDim.x;
  const int rows = (int)min((long long)blockDim.x, (long long)n - row0);
  const long long count = (long long)rows * d;
  const int* src = xb + row0 * d;
  if (vec) {
    // d % 4 == 0, so a 16-byte group never straddles two rows
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (long long q = tid; q < count / 4; q += blockDim.x) {
      const int4 v = src4[q];
      const long long e = q * 4;
      int* dst = tile + (e / d) * stride + (e % d);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (long long e = tid; e < count; e += blockDim.x) {
      tile[(e / d) * stride + (e % d)] = src[e];
    }
  }
  __syncthreads();

  if (tid < rows) {
    const int* row = tile + (size_t)tid * stride;
    double acc = 0.0;
    for (int j = 0; j < d; ++j) {
      int b = row[j];
      b = b < 0 ? 0 : (b > cuts ? cuts : b);
      acc += S[(size_t)j * B + b];
    }
    const long long i = row0 + tid;
    const float delta = (float)(2.0 * acc - (double)c[0]);
    const float m = ml[i] + delta;
    float logw = -y[i] * (m - ms[i]);
    // clamp by comparison, as the reference does: a NaN stays NaN
    logw = logw < -30.f ? -30.f : (logw > 30.f ? 30.f : logw);
    m_out[i] = m;
    w_out[i] = expf(logw);
  }
}

}  // namespace

// xb (n, d) int32, y/ml/ms (n,) f32, a (d, B-1) f32, c () f32 -> m_out, w_out (n,) f32.
// One block of tile_rows threads per tile_rows rows. Shared memory per block:
// d * B doubles + tile_rows * (d | 1) ints, which the caller keeps within the
// card's per-block limit. Requires n >= 1, B >= 1.
extern "C" int weight_update_launch(const int* xb, const float* y, const float* ml, const float* ms,
                                    const float* a, const float* c, float* m_out, float* w_out,
                                    int n, int d, int B, int tile_rows, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int stride = d | 1;  // odd: row t of the tile starts in bank (t * stride) % 32
  const size_t smem = (size_t)d * B * sizeof(double) + (size_t)tile_rows * stride * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        weight_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (d % 4 == 0) && ((reinterpret_cast<uintptr_t>(xb) & 15) == 0);
  const int blocks = (int)(((long long)n + tile_rows - 1) / tile_rows);
  weight_update_kernel<<<blocks, tile_rows, smem, stream>>>(xb, y, ml, ms, a, c, n, d, B, stride,
                                                                 vec, m_out, w_out);
  return static_cast<int>(cudaGetLastError());
}
