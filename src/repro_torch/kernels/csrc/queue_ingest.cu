// K3: sparse-control candidate ingest into the bounded pending queues.
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_step.py::queue_ingest
// (body _queue_ingest_kernel), reached from the engine's
// _queue_push_candidates when control_plane="sparse" and inflight_capacity > 0.
//
// Per row, the C queue entries and the m candidates are merged and the C
// smallest under the total order (cert, src, due, column) are kept, in that
// order: worst-certificate-first eviction, with resident entries beating
// identical fresh candidates (the stable lexsort of kernels/ref.py).
//
// What bounds it on an H100: bytes at large W (16 B per entry in and out);
// the (C+m)^2 compares per row run from shared memory. At the main path's
// W = 10 the launch latency is the bound.
//
// Design: one warp per row, the row's C+m entries staged in shared memory.
// Each lane takes entries k = lane, lane+32, ... and counts the entries that
// precede k under the total order; that rank is the output column. With the
// column as the last key the order is total, so the ranks are a permutation
// of 0..C+m-1 and every output column below C is written exactly once: the
// kernel is bit-identical to kernels/ref.py::queue_ingest_ref without a sort.
#include <cuda_runtime.h>

namespace {

struct Entry {
  float cert;
  int due;
  int src;
  int slot;
};

__device__ __forceinline__ bool precedes(const Entry& b, int jb, const Entry& a, int ja) {
  if (b.cert != a.cert) return b.cert < a.cert;
  if (b.src != a.src) return b.src < a.src;
  if (b.due != a.due) return b.due < a.due;
  return jb < ja;
}

__global__ void queue_ingest_kernel(const float* __restrict__ q_cert, const int* __restrict__ q_due,
                                    const int* __restrict__ q_src, const int* __restrict__ q_slot,
                                    const float* __restrict__ c_cert, const int* __restrict__ c_due,
                                    const int* __restrict__ c_src, const int* __restrict__ c_slot,
                                    float* __restrict__ o_cert, int* __restrict__ o_due,
                                    int* __restrict__ o_src, int* __restrict__ o_slot, int W, int C,
                                    int m, int rows_per_block) {
  extern __shared__ Entry ent[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * rows_per_block + warp;
  if (row >= W) return;  // whole warps exit together; no block-wide barrier below
  const int n = C + m;
  Entry* e = ent + (size_t)warp * n;
  const size_t qb = (size_t)row * C;
  const size_t cb = (size_t)row * m;
  for (int k = lane; k < n; k += 32) {
    Entry x;
    if (k < C) {
      x.cert = q_cert[qb + k];
      x.due = q_due[qb + k];
      x.src = q_src[qb + k];
      x.slot = q_slot[qb + k];
    } else {
      x.cert = c_cert[cb + k - C];
      x.due = c_due[cb + k - C];
      x.src = c_src[cb + k - C];
      x.slot = c_slot[cb + k - C];
    }
    e[k] = x;
  }
  __syncwarp();
  for (int k = lane; k < n; k += 32) {
    const Entry a = e[k];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += precedes(e[j], j, a, k) ? 1 : 0;
    if (rank < C) {
      o_cert[qb + rank] = a.cert;
      o_due[qb + rank] = a.due;
      o_src[qb + rank] = a.src;
      o_slot[qb + rank] = a.slot;
    }
  }
}

}  // namespace

// (W, C) queue and (W, m) candidate leaves in, four (W, C) outputs.
// rows_per_block * (C + m) * 16 bytes of shared memory must fit in 48 KB
// (the caller checks).
extern "C" int queue_ingest_launch(const float* q_cert, const int* q_due, const int* q_src,
                                   const int* q_slot, const float* c_cert, const int* c_due,
                                   const int* c_src, const int* c_slot, float* o_cert, int* o_due,
                                   int* o_src, int* o_slot, int W, int C, int m,
                                   int rows_per_block, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (W + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)rows_per_block * (C + m) * sizeof(Entry);
  queue_ingest_kernel<<<blocks, rows_per_block * 32, smem, stream>>>(
      q_cert, q_due, q_src, q_slot, c_cert, c_due, c_src, c_slot, o_cert, o_due, o_src, o_slot, W,
      C, m, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
