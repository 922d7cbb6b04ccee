// K2: the engine's fused sparse round step (delivery argmin, eps-gated
// accept, arrival clearing, laggard credit).
//
// Replaces the Pallas TPU kernel src/repro/kernels/round_step.py::round_step
// (body _round_step_kernel, pallas_call at line 265), reached through
// ops.round_deliver from TMSNEngine._deliver_sparse when inflight_capacity > 0.
//
// Per destination row of the (W, C) pending queue:
//   arr      = (due == r) & isfinite(cert)
//   best     = min over arr & alive of cert; ties to the lowest src, then slot
//   take     = isfinite(best) & (best < certs0 - eps)
//   n_arr    = count of arr;  cert' = arr ? +inf : cert
//   credit2  = credit + speed;  active = alive & (credit2 >= 1 - 1e-6)
//   credit'  = active ? credit2 - 1 : credit2
// best is -0.0 when the minimum is zero and any of the tied zeros is -0.0,
// as the reference's min gives it.
//
// What bounds it on an H100: at the main path's W = 10 (a 10 KB queue),
// latency: the launch, one trip to memory and the reduction's dependent
// steps. From W = 4096 on, bytes: 16 B read and 4 B written per queue entry
// (5.39 MB at W = 4096, C = 64). Against the latency, every load is started
// at entry and one reduction chain follows it; against the bytes, each entry
// is read once, in 16-byte loads, by blocks spread over every SM.
//
// Design:
//   * one pass: each lane starts its queue loads (16-byte float4/int4 loads
//     where C % 4 == 0 and the leaves are 16-byte aligned, else one entry a
//     load) and the row scalars (alive, certs0, credit, speed) at entry, and
//     writes cert' from its registers; no entry is read twice;
//   * one lexicographic minimum: each live arriving entry becomes one 96-bit
//     key (order-preserving cert bits with -0.0 folded onto +0.0, src and
//     slot with the sign bit flipped), every other entry the all-ones key,
//     which no finite cert reaches; keys are compared by the borrow of one
//     96-bit subtract and reduced with xor shuffles inside the row's lanes;
//     arrivals are counted with ballots, and best's sign bit comes from a
//     ballot over the live arriving -0.0 entries;
//   * rows per warp from C (ops.round_step_plan): a row gets the fewest lanes,
//     a power of two, whose loads cover it in one pass (16 at C = 64, so two
//     rows share a warp and reduce in four steps); a longer row loops over
//     its loads in chunks of 32; blocks of up to 8 warps spread W over the SMs.
// min of a total order is exact and independent of order, so the kernel is
// bit-identical to kernels/ref.py::round_step_ref. eps arrives as a float
// and certs0 - eps is formed in float32, and the credit threshold is the
// float32 constant 0.999999f, the float32 rounding of 1.0 - 1e-6 that the
// reference compares against.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kInf = 0x7f800000u;
constexpr unsigned kNegZero = 0x80000000u;
constexpr unsigned kAll = 0xffffffffu;

struct Key {
  unsigned c, s, l;  // cert, src, slot words, most significant first
};

__device__ __forceinline__ unsigned cert_key(unsigned u) {
  if (u == kNegZero) u = 0u;  // -0.0 ranks as +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// a = min(a, b) as 96-bit unsigned numbers: the borrow out of b - a says b < a
__device__ __forceinline__ void keep_min(Key& a, const Key& b) {
  unsigned borrow;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, %1, %4;\n\t"
      "subc.cc.u32 t, %2, %5;\n\t"
      "subc.cc.u32 t, %3, %6;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(borrow)
      : "r"(b.l), "r"(b.s), "r"(b.c), "r"(a.l), "r"(a.s), "r"(a.c));
  if (borrow) a = b;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  __device__ __forceinline__ static void load(const float* __restrict__ p, size_t i, unsigned* u) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    u[0] = __float_as_uint(v.x), u[1] = __float_as_uint(v.y);
    u[2] = __float_as_uint(v.z), u[3] = __float_as_uint(v.w);
  }
  __device__ __forceinline__ static void load(const int* __restrict__ p, size_t i, int* x) {
    const int4 v = reinterpret_cast<const int4*>(p)[i];
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* __restrict__ p, size_t i, const unsigned* u) {
    reinterpret_cast<float4*>(p)[i] = make_float4(__uint_as_float(u[0]), __uint_as_float(u[1]),
                                                  __uint_as_float(u[2]), __uint_as_float(u[3]));
  }
};
template <>
struct Vec<1> {
  __device__ __forceinline__ static void load(const float* __restrict__ p, size_t i, unsigned* u) {
    u[0] = __float_as_uint(p[i]);
  }
  __device__ __forceinline__ static void load(const int* __restrict__ p, size_t i, int* x) { x[0] = p[i]; }
  __device__ __forceinline__ static void store(float* __restrict__ p, size_t i, const unsigned* u) {
    p[i] = __uint_as_float(u[0]);
  }
};

// A row is 2^lanes_log2 consecutive lanes of a warp; lane lr of the row takes
// the loads lr, lr + L, lr + 2L, ... of VEC entries each.
template <int VEC>
__global__ void round_step_kernel(const float* __restrict__ q_cert, const int* __restrict__ q_due,
                                  const int* __restrict__ q_src, const int* __restrict__ q_slot,
                                  const float* __restrict__ certs0, const bool* __restrict__ alive,
                                  const float* __restrict__ credit, const float* __restrict__ speed,
                                  int r, float eps, float* __restrict__ q_cert_out,
                                  float* __restrict__ best_cert, int* __restrict__ best_src,
                                  int* __restrict__ best_slot, bool* __restrict__ take,
                                  int* __restrict__ n_arr, float* __restrict__ credit_out,
                                  bool* __restrict__ active, int W, int C, int lanes_log2) {
  const int L = 1 << lanes_log2;
  const int lane = threadIdx.x & 31;
  const int sub = lane >> lanes_log2;
  const int lr = lane & (L - 1);
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int row = (warp << (5 - lanes_log2)) + sub;
  if ((warp << (5 - lanes_log2)) >= W) return;  // whole warps exit together
  const bool in = row < W;
  const unsigned rowmask = (unsigned)(((1ull << L) - 1ull) << (sub * L));

  // the row scalars, loaded alongside the queue loads below
  const bool live = in && alive[row];
  float c0 = 0.0f, cr = 0.0f, sp = 0.0f;
  if (in && lr == 0) c0 = certs0[row], cr = credit[row], sp = speed[row];

  const int nvec = C / VEC;
  const size_t vbase = (size_t)row * nvec;
  Key best = {kAll, kAll, kAll};
  int count = 0;
  bool negz = false;
  for (int v0 = 0; v0 < nvec; v0 += L) {  // the same trip count in every lane
    const int v = v0 + lr;
    const bool ok = in && v < nvec;
    unsigned u[VEC];
    int due[VEC], src[VEC], slot[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) u[k] = kInf, due[k] = 0, src[k] = 0, slot[k] = 0;
    if (ok) {
      Vec<VEC>::load(q_cert, vbase + v, u);
      Vec<VEC>::load(q_due, vbase + v, due);
      Vec<VEC>::load(q_src, vbase + v, src);
      Vec<VEC>::load(q_slot, vbase + v, slot);
    }
    unsigned out[VEC];
    Key key[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const bool arr = ok && due[k] == r && (u[k] & kInf) != kInf;
      out[k] = arr ? kInf : u[k];
      count += __popc(__ballot_sync(kAll, arr) & rowmask);
      const bool cand = arr && live;
      negz |= cand && u[k] == kNegZero;
      key[k] = cand ? Key{cert_key(u[k]), (unsigned)src[k] ^ 0x80000000u, (unsigned)slot[k] ^ 0x80000000u}
                    : Key{kAll, kAll, kAll};
    }
    if (ok) Vec<VEC>::store(q_cert_out, vbase + v, out);
#pragma unroll
    for (int h = VEC / 2; h > 0; h >>= 1)  // the lane's entries as a tree
#pragma unroll
      for (int k = 0; k < h; ++k) keep_min(key[k], key[k + h]);
    keep_min(best, key[0]);
  }
  for (int o = L >> 1; o > 0; o >>= 1) {
    const Key other = {__shfl_xor_sync(kAll, best.c, o), __shfl_xor_sync(kAll, best.s, o),
                       __shfl_xor_sync(kAll, best.l, o)};
    keep_min(best, other);
  }
  const bool neg = (__ballot_sync(kAll, negz) & rowmask) != 0u;

  if (in && lr == 0) {
    const bool finite = best.c != kAll;
    unsigned cu = (best.c & 0x80000000u) ? (best.c & 0x7fffffffu) : ~best.c;
    if (cu == 0u && neg) cu = kNegZero;
    const float bc = finite ? __uint_as_float(cu) : __uint_as_float(kInf);
    best_cert[row] = bc;
    best_src[row] = finite ? (int)(best.s ^ 0x80000000u) : 0;
    best_slot[row] = finite ? (int)(best.l ^ 0x80000000u) : 0;
    take[row] = finite && (bc < c0 - eps);
    n_arr[row] = count;
    const float credit2 = cr + sp;
    const bool act = live && (credit2 >= 0.999999f);
    credit_out[row] = act ? credit2 - 1.0f : credit2;
    active[row] = act;
  }
}

}  // namespace

// (W, C) queue leaves and (W,) vectors in; outputs allocated by the caller.
// vec is 4 (C % 4 == 0, every (W, C) leaf 16-byte aligned: the caller checks)
// or 1; row_lanes a power of two up to 32; warps_per_block up to 32.
extern "C" int round_step_launch(const float* q_cert, const int* q_due, const int* q_src,
                                 const int* q_slot, const float* certs0, const bool* alive,
                                 const float* credit, const float* speed, int r, float eps,
                                 float* q_cert_out, float* best_cert, int* best_src,
                                 int* best_slot, bool* take, int* n_arr, float* credit_out,
                                 bool* active, int W, int C, int vec, int row_lanes,
                                 int warps_per_block, void* stream_ptr) {
  if (row_lanes < 1 || row_lanes > 32 || (row_lanes & (row_lanes - 1)) != 0 ||
      warps_per_block < 1 || warps_per_block > 32 || !(vec == 1 || (vec == 4 && C % 4 == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int lanes_log2 = __builtin_ctz(static_cast<unsigned>(row_lanes));
  const int rows_per_warp = 32 / row_lanes;
  const long long warps = (W + rows_per_warp - 1) / rows_per_warp;
  const int blocks = static_cast<int>((warps + warps_per_block - 1) / warps_per_block);
  const int threads = warps_per_block * 32;
  if (vec == 4)
    round_step_kernel<4><<<blocks, threads, 0, stream>>>(
        q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed, r, eps, q_cert_out, best_cert,
        best_src, best_slot, take, n_arr, credit_out, active, W, C, lanes_log2);
  else
    round_step_kernel<1><<<blocks, threads, 0, stream>>>(
        q_cert, q_due, q_src, q_slot, certs0, alive, credit, speed, r, eps, q_cert_out, best_cert,
        best_src, best_slot, take, n_arr, credit_out, active, W, C, lanes_log2);
  return static_cast<int>(cudaGetLastError());
}
