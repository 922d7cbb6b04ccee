// K3: sparse-control candidate ingest into the bounded pending queues.
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_step.py::queue_ingest
// (body _queue_ingest_kernel), reached from the engine's
// _queue_push_candidates when control_plane="sparse" and inflight_capacity > 0.
//
// Per row, the C queue entries and the m candidates are merged and the C
// smallest under the total order (cert, src, due, column) are kept, in that
// order: worst-certificate-first eviction, with resident entries beating
// identical fresh candidates (the stable lexsort of kernels/ref.py). The
// queue is not assumed sorted: K2 turns delivered entries into +inf in
// place, and the order among +inf entries (by src, due, column) decides the
// output too.
//
// What bounds it on an H100: bytes at large W (16 B per entry in, 16 B per
// kept entry out); at the main path's W = 10, the launch. The (C+m)^2
// compares per row run from shared memory and must stay short.
//
// Design (rank-select, the TPU kernel's own idea, without a sort):
//   * each entry is packed into one 128-bit key staged in shared memory:
//     an order-preserving uint32 of cert (-0.0 folded to +0.0, which the
//     reference treats as equal), src ^ 0x80000000, due ^ 0x80000000 and the
//     column. Unsigned order of the key is the total order above, so "entry
//     j precedes entry k" is the borrow of one branch-free 128-bit subtract
//     (measured faster than two 64-bit compares at W = 4096);
//   * every entry has its own thread (row_threads = C+m, at most 1024;
//     beyond that a thread takes every 1024th entry; rows are packed into a
//     block without padding to a warp), which counts the keys below its own.
//     With the column in the key the ranks are a permutation of 0..C+m-1, so
//     every output column below C is written exactly once: bit-identical to
//     kernels/ref.py::queue_ingest_ref;
//   * rows per block are chosen by the wrapper (kernels/ops.py) so that
//     W = 10 runs one row per block and W = 4096 fills the card.
// NaN certificates are outside the contract (the reference's sort puts them
// last; here a NaN's key sorts by its sign bit).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned int cert_key(float c) {
  unsigned int u = __float_as_uint(c);
  if (u == 0x80000000u) u = 0u;  // -0.0 ranks as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// 1 if key b < key a as 128-bit unsigned numbers (x the high half): the
// borrow out of b - a, four instructions where two 64-bit compares take nine
__device__ __forceinline__ int precedes(const ulonglong2& b, const ulonglong2& a) {
  unsigned int borrow;
  asm("{\n\t.reg .u64 t;\n\t"
      "sub.cc.u64 t, %1, %3;\n\t"
      "subc.cc.u64 t, %2, %4;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "l"(b.y), "l"(b.x), "l"(a.y), "l"(a.x));
  return -(int)borrow;
}

__global__ void queue_ingest_kernel(const float* __restrict__ q_cert, const int* __restrict__ q_due,
                                    const int* __restrict__ q_src, const int* __restrict__ q_slot,
                                    const float* __restrict__ c_cert, const int* __restrict__ c_due,
                                    const int* __restrict__ c_src, const int* __restrict__ c_slot,
                                    float* __restrict__ o_cert, int* __restrict__ o_due,
                                    int* __restrict__ o_src, int* __restrict__ o_slot, int W, int C,
                                    int m, int rows_per_block, int row_threads) {
  extern __shared__ ulonglong2 keys[];
  const int n = C + m;
  const int r = threadIdx.x / row_threads;
  const int t = threadIdx.x - r * row_threads;
  const int row = blockIdx.x * rows_per_block + r;
  const bool live = row < W;
  ulonglong2* key = keys + (size_t)r * n;
  const size_t qb = (size_t)row * C;
  const size_t cb = (size_t)row * m;
  if (live) {
    for (int k = t; k < n; k += row_threads) {
      const bool q = k < C;
      const float c = q ? q_cert[qb + k] : c_cert[cb + k - C];
      const int due = q ? q_due[qb + k] : c_due[cb + k - C];
      const int src = q ? q_src[qb + k] : c_src[cb + k - C];
      ulonglong2 e;
      e.x = ((unsigned long long)cert_key(c) << 32) | (unsigned int)(src ^ 0x80000000);
      e.y = ((unsigned long long)(unsigned int)(due ^ 0x80000000) << 32) | (unsigned int)k;
      key[k] = e;
    }
  }
  __syncthreads();
  if (!live) return;
  for (int k = t; k < n; k += row_threads) {
    const ulonglong2 a = key[k];
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j) rank += precedes(key[j], a);
    if (rank < C) {
      const size_t o = qb + rank;
      if (k < C) {
        o_cert[o] = q_cert[qb + k];
        o_due[o] = q_due[qb + k];
        o_src[o] = q_src[qb + k];
        o_slot[o] = q_slot[qb + k];
      } else {
        o_cert[o] = c_cert[cb + k - C];
        o_due[o] = c_due[cb + k - C];
        o_src[o] = c_src[cb + k - C];
        o_slot[o] = c_slot[cb + k - C];
      }
    }
  }
}

}  // namespace

// (W, C) queue and (W, m) candidate leaves in, four (W, C) outputs.
// Block: rows_per_block rows of row_threads threads (at most 1024 in all)
// and rows_per_block * (C + m) * 16 bytes of shared memory, at most 232 448
// (the caller checks).
extern "C" int queue_ingest_launch(const float* q_cert, const int* q_due, const int* q_src,
                                   const int* q_slot, const float* c_cert, const int* c_due,
                                   const int* c_src, const int* c_slot, float* o_cert, int* o_due,
                                   int* o_src, int* o_slot, int W, int C, int m,
                                   int rows_per_block, int row_threads, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (W + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)rows_per_block * (C + m) * sizeof(ulonglong2);
  if (smem > 48 * 1024) {  // above 48 KB a block must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        queue_ingest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  queue_ingest_kernel<<<blocks, rows_per_block * row_threads, smem, stream>>>(
      q_cert, q_due, q_src, q_slot, c_cert, c_due, c_src, c_slot, o_cert, o_due, o_src, o_slot, W,
      C, m, rows_per_block, row_threads);
  return static_cast<int>(cudaGetLastError());
}
