// K2: the engine's fused sparse round step (delivery argmin, eps-gated
// accept, arrival clearing, laggard credit).
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_step.py::round_step
// (body _round_step_kernel), reached through ops.round_deliver from
// TMSNEngine._deliver_sparse when inflight_capacity > 0.
//
// Per destination row of the (W, C) pending queue:
//   arr      = (due == r) & isfinite(cert)
//   best     = min over arr & alive of cert; ties to the lowest src, then slot
//   take     = isfinite(best) & (best < certs0 - eps)
//   n_arr    = count of arr;  cert' = arr ? +inf : cert
//   credit2  = credit + speed;  active = alive & (credit2 >= 1 - 1e-6)
//   credit'  = active ? credit2 - 1 : credit2
//
// What bounds it on an H100: bytes (16 B read and 4 B written per queue
// entry, a handful of compares each). At the main path's W = 10 the whole
// queue is 10 KB and the launch latency is the bound.
//
// Design: one warp per destination row, lanes strided over C, and three
// warp-shuffle minima in turn (cert, then src among the hits, then slot
// among those). min is exact and independent of order, so the kernel is
// bit-identical to kernels/ref.py::round_step_ref. eps arrives as a float
// and certs0 - eps is formed in float32, and the credit threshold is the
// float32 constant 0.999999f, the float32 rounding of 1.0 - 1e-6 that the
// reference compares against.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float warp_min_f(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void round_step_kernel(const float* __restrict__ q_cert, const int* __restrict__ q_due,
                                  const int* __restrict__ q_src, const int* __restrict__ q_slot,
                                  const float* __restrict__ certs0, const bool* __restrict__ alive,
                                  const float* __restrict__ credit, const float* __restrict__ speed,
                                  int r, float eps, float* __restrict__ q_cert_out,
                                  float* __restrict__ best_cert, int* __restrict__ best_src,
                                  int* __restrict__ best_slot, bool* __restrict__ take,
                                  int* __restrict__ n_arr, float* __restrict__ credit_out,
                                  bool* __restrict__ active, int W, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= W) return;  // whole warps exit together
  const size_t base = (size_t)row * C;
  const bool live = alive[row];
  const float inf = __int_as_float(0x7f800000);

  float m = inf;
  int count = 0;
  for (int c = lane; c < C; c += 32) {
    const float qc = q_cert[base + c];
    const bool arr = (q_due[base + c] == r) && isfinite(qc);
    q_cert_out[base + c] = arr ? inf : qc;
    count += arr ? 1 : 0;
    const float v = (arr && live) ? qc : inf;
    m = v < m ? v : m;
  }
  const float bc = warp_min_f(m);
  const int arrivals = warp_sum_i(count);
  const bool finite = isfinite(bc);

  int s = INT_MAX;
  if (finite) {
    for (int c = lane; c < C; c += 32) {
      const float qc = q_cert[base + c];
      const bool hit = live && q_due[base + c] == r && isfinite(qc) && qc == bc;
      if (hit) s = min(s, q_src[base + c]);
    }
  }
  const int bs = warp_min_i(s);

  int l = INT_MAX;
  if (finite) {
    for (int c = lane; c < C; c += 32) {
      const float qc = q_cert[base + c];
      const bool sel = live && q_due[base + c] == r && isfinite(qc) && qc == bc &&
                       q_src[base + c] == bs;
      if (sel) l = min(l, q_slot[base + c]);
    }
  }
  const int bl = warp_min_i(l);

  if (lane == 0) {
    best_cert[row] = bc;
    best_src[row] = finite ? bs : 0;
    best_slot[row] = finite ? bl : 0;
    const float gate = certs0[row] - eps;
    take[row] = finite && (bc < gate);
    n_arr[row] = arrivals;
    const float credit2 = credit[row] + speed[row];
    const bool act = live && (credit2 >= 0.999999f);
    credit_out[row] = act ? credit2 - 1.0f : credit2;
    active[row] = act;
  }
}

}  // namespace

// (W, C) queue leaves and (W,) vectors in; outputs allocated by the caller.
extern "C" int round_step_launch(const float* q_cert, const int* q_due, const int* q_src,
                                 const int* q_slot, const float* certs0, const bool* alive,
                                 const float* credit, const float* speed, int r, float eps,
                                 float* q_cert_out, float* best_cert, int* best_src,
                                 int* best_slot, bool* take, int* n_arr, float* credit_out,
                                 bool* active, int W, int C, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = (W + kWarps - 1) / kWarps;
  round_step_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed, r, eps, q_cert_out, best_cert,
      best_src, best_slot, take, n_arr, credit_out, active, W, C);
  return static_cast<int>(cudaGetLastError());
}
