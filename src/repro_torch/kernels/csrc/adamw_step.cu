// K5: one AdamW step over every leaf of a model, in one launch.
//
// Replaces no TPU kernel: the JAX package's update (src/repro/optim/adamw.py)
// is plain jnp, which XLA fuses into one pass. The port's plain version,
// optim/adamw.py::_update, is about fifteen eager PyTorch ops a leaf, each a
// pass over the whole leaf through device memory; this kernel is that
// update as one pass, bit for bit:
//
//   mu'  = b1 * mu + (1 - b1) * g
//   nu'  = b2 * nu + ((1 - b2) * g) * g
//   p'   = p - lr * ((mu' / b1c) / (sqrt(nu' / b2c) + eps) + wd * p)
//
// every operation rounded once, in _update's order, as the eager op rounds
// it: __fmul_rn/__fadd_rn/__fsub_rn keep -O3 from contracting a product and
// a sum into an FMA, and the divisions and the root are the correctly
// rounded ones that PyTorch's own kernels use. The scalars are the float32
// values torch passes (b1, 1 - b1 computed in double, eps, wd, lr); b1c,
// b2c (and lr when it is a tensor) are read from device memory. A bfloat16
// leaf is widened exactly and rounded to nearest even only where it is
// written, as .to() rounds it; the bias-corrected moments come from the
// unrounded float32 ones.
//
// What bounds it on an H100: bytes. Each element reads p, g, mu, nu and
// writes p, mu, nu once (28 B in float32) against ~20 floating-point
// operations, far below the card's operations per byte. Design:
//   * one launch takes up to kMaxLeaves leaves: their pointers and sizes
//     travel by value as the kernel's parameters (__grid_constant__, read
//     through the constant bank), so nothing is copied to the card first
//     and nothing waits for it;
//   * each leaf is cut into tiles of kTile elements, one block a tile,
//     the tiles of all leaves numbered in order; a block finds its leaf by
//     a block-uniform walk of the table. One block a tile ran 5 % faster
//     than a persistent grid striding over the tiles (6.64 against 6.96 ms
//     a step at Yi-9B's one-layer leaves on an H100);
//   * in a whole tile of a leaf whose seven pointers are 16-byte aligned,
//     each thread moves 16 bytes per load and store and issues all of its
//     loads for the tile (256 B in float32) before the first result is
//     needed. Plain loads and stores: the streaming hints (__ldcs/__stcs)
//     were 2 % slower there (6.64 against 6.50 ms);
//   * the last, partial tile of a leaf and every tile of a misaligned leaf
//     take a scalar path, one element per thread per pass, still coalesced;
//   * no temporary leaves registers, nothing is allocated, no atomics: two
//     launches on the same inputs give the same bits, and an element is
//     read before it is written by the same thread, so the update may be in
//     place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 48;
constexpr int kThreads = 256;
constexpr int kTile = kThreads * 16;  // elements: 16 a thread

struct Leaf {
  const void* p;
  const void* g;
  const void* mu;
  const void* nu;
  void* p_out;
  void* mu_out;
  void* nu_out;
  long long n;         // elements
  long long tile_end;  // tiles of this leaf and every leaf before it
  int vec;             // all seven pointers 16-byte aligned
};

struct Args {
  Leaf leaf[kMaxLeaves];
  int n_leaves;
  const float* b1c;
  const float* b2c;
  const float* lr_ptr;  // null: lr below
  float lr, b1, c1, b2, c2, eps, wd;
};
static_assert(sizeof(Args) <= 4096, "the leaf table must fit the 4 KB of kernel parameters");

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16(x));  // round to nearest even, as torch's .to()
}

template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kPer = 4;  // elements in 16 bytes
  __device__ static void load16(const void* base, long long e, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(static_cast<const float*>(base) + e);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ static void store16(void* base, long long e, const float* in) {
    *reinterpret_cast<float4*>(static_cast<float*>(base) + e) = make_float4(in[0], in[1], in[2], in[3]);
  }
  __device__ static float load1(const void* base, long long e) { return static_cast<const float*>(base)[e]; }
  __device__ static void store1(void* base, long long e, float x) { static_cast<float*>(base)[e] = x; }
};

template <>
struct Io<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void load16(const void* base, long long e, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(static_cast<const unsigned short*>(base) + e);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // little-endian: element 2k in the low half
      out[2 * k] = __uint_as_float(w[k] << 16);
      out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store16(void* base, long long e, const float* in) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w[k] = (unsigned)bf16_bits(in[2 * k]) | ((unsigned)bf16_bits(in[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(static_cast<unsigned short*>(base) + e) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load1(const void* base, long long e) {
    return __uint_as_float((unsigned)static_cast<const unsigned short*>(base)[e] << 16);
  }
  __device__ static void store1(void* base, long long e, float x) {
    static_cast<unsigned short*>(base)[e] = bf16_bits(x);
  }
};

struct Scalars {
  float b1c, b2c, lr, b1, c1, b2, c2, eps, wd;
};

// _update's ops in its order, each rounded once
__device__ __forceinline__ void adamw(const Scalars& s, float& p, float g, float& m, float& v) {
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.c1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.c2, g), g));
  const float mhat = __fdiv_rn(m, s.b1c);
  const float nhat = __fdiv_rn(v, s.b2c);
  const float delta = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(nhat), s.eps)), __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
}

// P: params, grads and p_out; S: mu, nu and their outputs
template <typename P, typename S>
__global__ void __launch_bounds__(kThreads) adamw_step_kernel(const __grid_constant__ Args a) {
  constexpr int V = Io<P>::kPer > Io<S>::kPer ? Io<P>::kPer : Io<S>::kPer;  // a unit: 16 B of the narrower
  constexpr int U = 16 / V;                                                // units a thread per tile
  static_assert(kThreads * U * V == kTile, "a tile is 16 elements a thread");
  const Scalars s{*a.b1c, *a.b2c, a.lr_ptr ? *a.lr_ptr : a.lr, a.b1, a.c1, a.b2, a.c2, a.eps, a.wd};
  const long long t = blockIdx.x;
  int L = 0;
  while (t >= a.leaf[L].tile_end) ++L;
  const Leaf& f = a.leaf[L];
  const long long base = (t - (L ? a.leaf[L - 1].tile_end : 0)) * kTile;
  if (f.vec && base + kTile <= f.n) {
    float p[U][V], g[U][V], m[U][V], v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (long long)(u * kThreads + threadIdx.x) * V;
#pragma unroll
      for (int c = 0; c < V; c += Io<P>::kPer) {
        Io<P>::load16(f.p, e + c, p[u] + c);
        Io<P>::load16(f.g, e + c, g[u] + c);
      }
#pragma unroll
      for (int c = 0; c < V; c += Io<S>::kPer) {
        Io<S>::load16(f.mu, e + c, m[u] + c);
        Io<S>::load16(f.nu, e + c, v[u] + c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) adamw(s, p[u][k], g[u][k], m[u][k], v[u][k]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = base + (long long)(u * kThreads + threadIdx.x) * V;
#pragma unroll
      for (int c = 0; c < V; c += Io<P>::kPer) Io<P>::store16(f.p_out, e + c, p[u] + c);
#pragma unroll
      for (int c = 0; c < V; c += Io<S>::kPer) {
        Io<S>::store16(f.mu_out, e + c, m[u] + c);
        Io<S>::store16(f.nu_out, e + c, v[u] + c);
      }
    }
  } else {
    const long long end = base + kTile < f.n ? base + kTile : f.n;
    for (long long e = base + threadIdx.x; e < end; e += kThreads) {
      float p = Io<P>::load1(f.p, e), m = Io<S>::load1(f.mu, e), v = Io<S>::load1(f.nu, e);
      adamw(s, p, Io<P>::load1(f.g, e), m, v);
      Io<P>::store1(f.p_out, e, p);
      Io<S>::store1(f.mu_out, e, m);
      Io<S>::store1(f.nu_out, e, v);
    }
  }
}

template <typename P, typename S>
int launch(const Args& a, long long tiles, cudaStream_t stream) {
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  adamw_step_kernel<P, S><<<(unsigned)tiles, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: n_leaves rows of 8 int64 (p, g, mu, nu, p_out, mu_out, nu_out as
// addresses, then the element count), in host memory; 1 <= n_leaves <=
// kMaxLeaves, every count >= 1. p_bf16/s_bf16 pick bfloat16 over float32 for
// the params and grads / the moments. b1c, b2c: one float32 on the card each;
// lr_ptr: one float32 on the card, or null for lr. One block of kThreads
// threads a tile of kTile elements.
extern "C" int adamw_step_launch(const long long* table, int n_leaves, int p_bf16, int s_bf16, const float* b1c,
                                 const float* b2c, const float* lr_ptr, float lr, float b1, float c1, float b2,
                                 float c2, float eps, float wd, void* stream_ptr) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  long long tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* row = table + 8 * i;
    Leaf& f = a.leaf[i];
    f.p = reinterpret_cast<const void*>(row[0]);
    f.g = reinterpret_cast<const void*>(row[1]);
    f.mu = reinterpret_cast<const void*>(row[2]);
    f.nu = reinterpret_cast<const void*>(row[3]);
    f.p_out = reinterpret_cast<void*>(row[4]);
    f.mu_out = reinterpret_cast<void*>(row[5]);
    f.nu_out = reinterpret_cast<void*>(row[6]);
    f.n = row[7];
    if (f.n < 1) return static_cast<int>(cudaErrorInvalidValue);
    tiles += (f.n + kTile - 1) / kTile;
    f.tile_end = tiles;
    long long any = 0;
    for (int k = 0; k < 7; ++k) any |= row[k];
    f.vec = (any & 15) == 0;
  }
  a.n_leaves = n_leaves;
  a.b1c = b1c;
  a.b2c = b2c;
  a.lr_ptr = lr_ptr;
  a.lr = lr;
  a.b1 = b1;
  a.c1 = c1;
  a.b2 = b2;
  a.c2 = c2;
  a.eps = eps;
  a.wd = wd;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (p_bf16) {
    return s_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, tiles, stream)
                  : launch<__nv_bfloat16, float>(a, tiles, stream);
  }
  return s_bf16 ? launch<float, __nv_bfloat16>(a, tiles, stream) : launch<float, float>(a, tiles, stream);
}
