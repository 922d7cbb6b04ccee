// K6: causal grouped-query attention over a full sequence, forward and
// backward, with the scores and probabilities kept on the SM.
//
// Replaces no TPU kernel: the reference's attention (src/repro/models/
// attention.py, _sdpa) is plain jnp, which XLA fuses. The port's plain
// version, models/attention.py::_sdpa, materialises (b, K, G, s, s) scores
// and runs about six elementwise passes over them (the scale, a cast, the
// mask, the softmax, a cast back, and their backward), each through device
// memory. This kernel computes the same function without writing them:
//
//   O[q] = sum_k softmax_k(scale * (Q[q] . K[k]) masked) V[k]
//
// with query head h = kvh * G + g reading KV head kvh, a key visible to a
// query iff kpos <= qpos (and kpos > qpos - window where window > 0), the
// products in float32, the scale applied to them in float32 (times log2 e,
// so that the exponentials are exp2), the softmax online in float32, and P
// rounded to bf16 for the P.V product as _sdpa rounds its probabilities.
// The forward also writes the log-sum-exp (float32, natural log), which
// the backward reads to recompute P. A query that sees no key
// at all gets O = 0 and a log-sum-exp of +inf, so that P reads 0 there
// (_sdpa would average every value; no caller of the port can make such a
// query: the diagonal is always visible).
//
// What bounds it on an H100: tensor-core operations. At Yi-9B's shape
// (b 2, H 32, K 4, s 4096, head 128) the causal forward is 275 GFLOP
// against 0.13 GB of inputs and outputs, far above the card's ~295
// operations a byte. Design (FlashAttention-2's shape):
//   * mma.sync m16n8k16 bf16 -> f32; each warp owns 32 rows (the forward:
//     4 warps a block of 128 query rows, so that each B fragment read from
//     shared memory feeds two products) or 16 (dQ, and dK/dV, whose dK and
//     dV accumulators take 128 registers a thread at 128/128); two blocks
//     an SM, so that one block's softmax overlaps the other's products; the
//     tile shapes are a trait of the head widths (Tiles below);
//     operands come from shared memory by ldmatrix, and the probabilities go
//     from the S accumulator into the next product's A operand in registers
//     (the accumulator's layout is the A layout);
//   * tiles are rows of the head width in shared memory, 16-byte chunks
//     XOR-swizzled by (row & 7) so that ldmatrix's eight rows fall in eight
//     different banks; the next key (or query) tile is loaded by cp.async
//     into a second buffer while the current one is used;
//   * a tile is skipped only where the positions it has read show every
//     pair masked: a first small kernel writes each 32-row tile's smallest
//     and largest position, and a tile whose keys all lie above the query
//     tile's largest position (or all at or below its smallest less the
//     window) is never loaded. A tile whose pairs are all visible skips the
//     elementwise mask. Positions need not be the index;
//   * the query tiles are ordered longest first (the last tile of a causal
//     sequence sees the most keys), the key tiles of the backward likewise;
//   * the backward is deterministic, with no atomics: one kernel per
//     (batch, head, query tile) computes D = rowsum(dO * O) for its rows and
//     dQ, and one per (batch, KV head, key tile) loops in a fixed order over
//     the G heads of its group and the visible query tiles and accumulates
//     dK and dV in registers. S and dP are computed in both (7 products
//     against the 5 the backward needs), the price of having no atomics.
//
// The head widths (qk, v) are template parameters; the library holds the
// 128/128 instance (grouped-query attention at head 128) and the 192/128
// one (DeepSeek-V3's MLA expanded: a 128-wide key without position and a
// 64-wide rotary one, values of 128). Each entry point launches on the
// given stream, syncs nothing, allocates nothing and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

// A block of WARPS warps, each owning MT m16 tiles of rows (16 MT rows).
template <int WARPS, int MT>
struct Shape {
  static constexpr int kMt = MT, kThreads = 32 * WARPS, kRows = 16 * MT * WARPS;
};
constexpr int kQuantum = 32;  // rows of a tile-bounds entry; every tile is a multiple
constexpr int kThreads = 128;  // every kernel's block (4 warps), two blocks an SM: the launch bounds

// The tile shapes, a trait of the head widths: Fwd, Dq and Dkv the blocks
// of the three kernels, then the forward's keys a step, dQ's keys a step and
// dK/dV's query rows a step. Two blocks an SM each. These are the largest
// steps at which ptxas spills nothing. The forward: 128 query rows on 4
// warps of 32 rows (each B fragment read from shared memory feeds two
// m-tiles); dQ: 64 query rows on 4 warps of 16; dK/dV: 64 keys on 4 warps
// of 16 (its dK and dV accumulators take 128 registers a thread at
// 128 / 128, 160 at 192 / 128).
//
// At 128 / 128, larger steps ran faster on an H100 at Yi-9B's shape but
// spilled: the forward with 64-key steps took 1.19 ms (72 bytes spilled)
// against 1.39, dQ on 32-row warps with 32-key steps 1.74 ms (32 bytes)
// against 1.97, dK/dV with 64-query steps 2.19 ms (12 bytes) against 2.50.
//
// Above 128, dQ takes 32 keys a step, so that its wider tiles leave room in
// shared memory for two blocks an SM. Measured on an H100 at 192 / 128,
// Moonlight's MLA (b 4, s 4096, 16 heads), each other step slower: dQ with
// 64-key steps 3.41 ms (one block an SM) against 2.69; the forward with
// 64-key steps 2.15 ms (28 bytes spilled), on 16-row warps 1.74 (64 keys)
// or 1.78 (32), against 1.63; dK/dV with 64-query steps 4.51 ms (20 bytes
// spilled) against 3.07.
template <int DQK, int DV>
struct Tiles {
  using FwdShape = Shape<4, 2>;
  using DqShape = Shape<4, 1>;
  using DkvShape = Shape<4, 1>;
  static constexpr int kFwdKeys = 32;
  static constexpr int kDqKeys = DQK > 128 ? 32 : 64;
  static constexpr int kDkvRows = 32;
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kInf = __builtin_huge_valf();

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t a, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

__device__ __forceinline__ void ldsm4t(uint32_t a, uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the thread's index and lane, read anew at each use: the compiler cannot
// hoist offsets derived from them out of the tile loop, where they would
// hold registers for the whole loop (and spill)
__device__ __forceinline__ int thread_x() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;\n" : "=r"(l));
  return l;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, round to nearest even; lo in the low half (the
// smaller column of a fragment)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- tiles

// byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of D
// bf16 values: the chunk index XOR (row & 7), so that ldmatrix's eight rows
// at one logical chunk hit eight different 16-byte bank groups
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  static_assert(D % 64 == 0, "a row must hold a multiple of 8 chunks for the swizzle");
  return row * (D * 2) + ((chunk ^ (row & 7)) << 4);
}

// R rows x D columns from g (row stride ss elements) into a swizzled tile,
// by a block of NTH threads; rows at or past `rows` are zero-filled (and g
// is not read there)
template <int R, int D, int NTH>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g, long long ss, int rows) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % NTH == 0, "whole passes of the block");
  const int tid = thread_x();
#pragma unroll
  for (int j = 0; j < R * kChunks / NTH; ++j) {
    const int i = tid + j * NTH;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < rows;
    cp_async16(dst + swz<D>(r, c), ok ? g + r * ss + c * 8 : g, ok);
  }
}

// R values from g (4-byte elements) into shared memory, one a thread; past
// `rows` the value `fill` is stored instead
template <int R, typename T>
__device__ __forceinline__ void load_row(T* dst, const T* g, int rows, T fill) {
  const int i = threadIdx.x;
  if (i < R) {
    if (i < rows) {
      cp_async4(smem_addr(dst + i), g + i);
    } else {
      dst[i] = fill;
    }
  }
}

// a swizzled tile of R rows x D columns out to g (row stride ss) by a
// block of NTH threads, rows below `rows` only
template <int R, int D, int NTH>
__device__ __forceinline__ void store_tile(__nv_bfloat16* g, long long ss, const unsigned char* src, int rows) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int j = 0; j < R * kChunks / NTH; ++j) {
    const int i = threadIdx.x + j * NTH;
    const int r = i / kChunks, c = i % kChunks;
    if (r < rows) *reinterpret_cast<uint4*>(g + r * ss + c * 8) = *reinterpret_cast<const uint4*>(src + swz<D>(r, c));
  }
}

// A warp's accumulator of MT m-tiles: float acc[MT][N][4], m-tile mt holding
// rows row0 + 16 mt + (lane >> 2) and 8 below it, n-tile n columns 8 n +
// 2 (lane & 3) and the one after it (mma.sync's C layout).

// the accumulator times (s[mt][0], s[mt][1]) by row, rounded to bf16, into
// rows row0.. of a swizzled tile of D columns (one chunk an n8 tile)
template <int D, int MT, int NT>
__device__ __forceinline__ void stage_acc(unsigned char* dst, const float (&acc)[MT][NT][4], int row0,
                                          const float (&s)[MT][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = row0 + mt * 16 + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dst + swz<D>(r, n) + t * 4) =
          pack(acc[mt][n][0] * s[mt][0], acc[mt][n][1] * s[mt][0]);
      *reinterpret_cast<uint32_t*>(dst + swz<D>(r + 8, n) + t * 4) =
          pack(acc[mt][n][2] * s[mt][1], acc[mt][n][3] * s[mt][1]);
    }
  }
}

// The ldmatrix addresses below are swz(row, 2 c + c0) for a lane's row and
// its chunk bit c0: each of its rows has row & 7 == lane & 7, so the offset
// is the row's start plus ((c0 ^ (lane & 7)) << 4) ^ (c << 5), one XOR a
// step c.

// acc (16 MT x 8 NT) += A (16 MT rows from row0 of a swizzled tile of DA
// columns) times B^T, B being 8 NT rows of a swizzled tile of DA columns:
// the product of two row-major tiles over their shared width. Each B
// fragment read from shared memory feeds MT products. row0 is a multiple
// of 16.
template <int DA, int MT, int NT>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[MT][NT][4], uint32_t a_tile, int row0, uint32_t b_tile) {
  constexpr int kRowBytes = DA * 2;
  const int lane = lane_id();
  // A: rows row0 + 16 mt + (lane & 15), chunks 2 kc + (lane >> 4)
  const uint32_t a_row = a_tile + (row0 + (lane & 15)) * kRowBytes, a_x = ((lane >> 4) ^ (lane & 7)) << 4;
  // B: rows 16 np + (lane & 7) + 8 (lane >> 4), chunks 2 kc + ((lane >> 3) & 1)
  const uint32_t b_row = b_tile + ((lane & 7) + ((lane >> 4) << 3)) * kRowBytes,
                 b_x = (((lane >> 3) & 1) ^ (lane & 7)) << 4;
#pragma unroll
  for (int kc = 0; kc < DA / 16; ++kc) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm4(a_row + mt * 16 * kRowBytes + (a_x ^ (kc << 5)), a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b0, b1, b2, b3;
      ldsm4(b_row + np * 16 * kRowBytes + (b_x ^ (kc << 5)), b0, b1, b2, b3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * np], a[mt], b0, b1);
        mma(acc[mt][2 * np + 1], a[mt], b2, b3);
      }
    }
  }
}

// acc (16 MT x DB) += P (16 MT x 8 NP, in registers as an accumulator)
// times B, B being 8 NP rows of a swizzled tile of DB columns
template <int DB, int MT, int NP>
__device__ __forceinline__ void mma_regs_rows(float (&acc)[MT][DB / 8][4], const float (&p)[MT][NP][4],
                                              uint32_t b_tile) {
  constexpr int kRowBytes = DB * 2;
  const int lane = lane_id();
  // B (transposed): rows 16 kk + (lane & 7) + 8 ((lane >> 3) & 1), chunks 2 dp + (lane >> 4)
  const uint32_t b_row = b_tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRowBytes,
                 b_x = ((lane >> 4) ^ (lane & 7)) << 4;
#pragma unroll
  for (int kk = 0; kk < NP / 2; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack(p[mt][2 * kk][0], p[mt][2 * kk][1]);
      a[mt][1] = pack(p[mt][2 * kk][2], p[mt][2 * kk][3]);
      a[mt][2] = pack(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
      a[mt][3] = pack(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DB / 16; ++dp) {
      uint32_t b0, b1, b2, b3;
      ldsm4t(b_row + kk * 16 * kRowBytes + (b_x ^ (dp << 5)), b0, b1, b2, b3);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma(acc[mt][2 * dp], a[mt], b0, b1);
        mma(acc[mt][2 * dp + 1], a[mt], b2, b3);
      }
    }
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
}

// ---------------------------------------------------------------- masks

struct Span {
  int lo, hi;  // smallest and largest position of a tile's rows
};

// the span of rows [t0 * kQuantum, (t0 + n) * kQuantum) from the bounds
// kernel's entries of one batch row (entries past n_bnd do not exist)
__device__ __forceinline__ Span span_of(const int* bnd, int t0, int n, int n_bnd) {
  Span sp{INT_MAX, INT_MIN};
  for (int i = t0; i < t0 + n && i < n_bnd; ++i) {
    sp.lo = min(sp.lo, __ldg(bnd + 2 * i));
    sp.hi = max(sp.hi, __ldg(bnd + 2 * i + 1));
  }
  return sp;
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || static_cast<long long>(kp) > static_cast<long long>(qp) - window);
}

// 0: every (query, key) pair of the two tiles is masked; 2: every pair is
// visible and the key tile lies wholly inside the sequence; 1: otherwise
__device__ __forceinline__ int tile_class(Span q, Span k, int window, bool k_whole) {
  if (k.lo > q.hi) return 0;
  if (window > 0 && static_cast<long long>(k.hi) <= static_cast<long long>(q.lo) - window) return 0;
  if (k_whole && k.hi <= q.lo && (window <= 0 || static_cast<long long>(k.lo) > static_cast<long long>(q.hi) - window))
    return 2;
  return 1;
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const int* pos;
  const int* bounds;  // (b, n_bnd, 2): each 32-row tile's smallest and largest position
  __nv_bfloat16 *out, *dq, *dk, *dv;
  float *lse, *dsum;  // (b, H, s)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh, pos_sb;
  int s, H, K, window, n_bnd;
  float scale;
};

// ---------------------------------------------------------------- bounds

// one warp a (tile, batch row): the tile's smallest and largest position
__global__ void __launch_bounds__(kQuantum) attention_bounds_kernel(const Args a) {
  static_assert(kQuantum == 32, "one warp a tile");
  const int t = blockIdx.x, bi = blockIdx.y, i = t * kQuantum + threadIdx.x;
  int lo = INT_MAX, hi = INT_MIN;
  if (i < a.s) lo = hi = a.pos[bi * a.pos_sb + i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (threadIdx.x == 0) {
    int* out = const_cast<int*>(a.bounds) + 2 * (static_cast<long long>(bi) * a.n_bnd + t);
    out[0] = lo;
    out[1] = hi;
  }
}

// ---------------------------------------------------------------- forward

template <int DQK, int DV>
struct FwdSmem {
  using T = Tiles<DQK, DV>;
  static constexpr int kQ = 0;  // the query tile, then O's staging
  static constexpr int kK = kQ + T::FwdShape::kRows * (DQK > DV ? DQK : DV) * 2;
  static constexpr int kV = kK + 2 * T::kFwdKeys * DQK * 2;
  static constexpr int kPos = kV + 2 * T::kFwdKeys * DV * 2;  // the key tiles' positions
  static constexpr int kQpos = kPos + 2 * T::kFwdKeys * 4;     // the query tile's positions
  static constexpr int kBytes = kQpos + T::FwdShape::kRows * 4;
};

// the next key tile after kt that some pair of the query tile can see
template <int BC>
__device__ __forceinline__ int next_key_tile(int kt, int nk, const int* bnd, int n_bnd, Span qs, int window) {
  for (++kt; kt < nk; ++kt)
    if (tile_class(qs, span_of(bnd, kt * (BC / kQuantum), BC / kQuantum, n_bnd), window, true) != 0) break;
  return kt;
}

// grid (b * H, query tiles): blockIdx.y = 0 is the last query tile
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2) attention_fwd_kernel(const Args a) {
  using L = FwdSmem<DQK, DV>;
  using S = typename Tiles<DQK, DV>::FwdShape;
  constexpr int BR = S::kRows, BC = Tiles<DQK, DV>::kFwdKeys, MT = S::kMt, NTH = S::kThreads;
  static_assert(NTH == kThreads, "the launch bounds' block");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kPos);
  int* qpos_s = reinterpret_cast<int*>(smem + L::kQpos);

  const int bi = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / (a.H / a.K);
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 * MT;
  const int nk = (a.s + BC - 1) / BC;
  const float scale2 = a.scale * kLog2e;  // scores in units of log2, for ex2
  const int* bnd = a.bounds + 2LL * bi * a.n_bnd;
  const Span qs = span_of(bnd, q0 / kQuantum, BR / kQuantum, a.n_bnd);

  const __nv_bfloat16* kg = a.k + bi * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + bi * a.v_sb + kvh * a.v_sh;
  const int* pg = a.pos + bi * a.pos_sb;

  // per-row values wait in shared memory, not in registers across the loop
  for (int i = threadIdx.x; i < BR; i += NTH) qpos_s[i] = q0 + i < a.s ? pg[q0 + i] : INT_MIN;
  load_tile<BR, DQK, NTH>(sbase + L::kQ, a.q + bi * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss, a.s - q0);
  cp_async_commit();
  auto issue = [&](int kt, int st) {
    const int k0 = kt * BC;
    load_tile<BC, DQK, NTH>(sbase + L::kK + st * BC * DQK * 2, kg + k0 * a.k_ss, a.k_ss, a.s - k0);
    load_tile<BC, DV, NTH>(sbase + L::kV + st * BC * DV * 2, vg + k0 * a.v_ss, a.v_ss, a.s - k0);
    load_row<BC>(kpos_s + st * BC, pg + k0, a.s - k0, INT_MAX);
  };
  int kt = next_key_tile<BC>(-1, nk, bnd, a.n_bnd, qs, a.window);
  if (kt < nk) issue(kt, 0);
  cp_async_commit();

  float o[MT][DV / 8][4];
  zero(o);
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = -kInf, l[mt][0] = l[mt][1] = 0.f;
  int st = 0;
  while (kt < nk) {
    const int kn = next_key_tile<BC>(kt, nk, bnd, a.n_bnd, qs, a.window);
    if (kn < nk) issue(kn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float sc[MT][BC / 8][4];
    zero(sc);
    mma_rows_rows<DQK, MT, BC / 8>(sc, sbase + L::kQ, row0, sbase + L::kK + st * BC * DQK * 2);
    const bool whole = (kt + 1) * BC <= a.s;
    const bool full =
        tile_class(qs, span_of(bnd, kt * (BC / kQuantum), BC / kQuantum, a.n_bnd), a.window, whole) == 2;
    const int* kp = kpos_s + st * BC;
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mx[mt][0] = mx[mt][1] = -kInf;
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[mt][n][e] * scale2;
          if (!full && !visible(kp[n * 8 + 2 * t4 + (e & 1)], qpos_s[row0 + mt * 16 + (e >> 1) * 8 + g], a.window))
            x = -kInf;
          sc[mt][n][e] = x;
          mx[mt][e >> 1] = fmaxf(mx[mt][e >> 1], x);
        }
    }
    float mu[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mn = fmaxf(m[mt][hf], quad_max(mx[mt][hf]));
        mu[mt][hf] = mn == -kInf ? 0.f : mn;
        const float al = ex2(m[mt][hf] - mu[mt][hf]);
        m[mt][hf] = mn;
        l[mt][hf] *= al;
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          o[mt][n][2 * hf] *= al;
          o[mt][n][2 * hf + 1] *= al;
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(sc[mt][n][e] - mu[mt][e >> 1]);
          sc[mt][n][e] = p;
          l[mt][e >> 1] += p;
        }
    mma_regs_rows<DV, MT, BC / 8>(o, sc, sbase + L::kV + st * BC * DV * 2);
    __syncthreads();
    st ^= 1;
    kt = kn;
  }

  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[mt][hf] = quad_sum(l[mt][hf]);
      inv[mt][hf] = l[mt][hf] > 0.f ? 1.f / l[mt][hf] : 0.f;
    }
  cp_async_wait<0>();
  __syncthreads();
  stage_acc<DV>(smem + L::kQ, o, row0, inv);
  if (t4 == 0) {
    float* lse = a.lse + (static_cast<long long>(bi) * a.H + h) * a.s;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = q0 + row0 + mt * 16 + hf * 8 + g;
        if (r < a.s) lse[r] = l[mt][hf] > 0.f ? (m[mt][hf] + log2f(l[mt][hf])) * kLn2 : kInf;
      }
  }
  __syncthreads();
  // O is (b, s, H, DV), contiguous
  store_tile<BR, DV, NTH>(a.out + ((static_cast<long long>(bi) * a.s + q0) * a.H + h) * DV,
                          static_cast<long long>(a.H) * DV, smem + L::kQ, a.s - q0);
}

// ---------------------------------------------------------------- dQ

template <int DQK, int DV>
struct DqSmem {
  using T = Tiles<DQK, DV>;
  static constexpr int kQ = 0;  // the query tile, then dQ's staging
  static constexpr int kDo = kQ + T::DqShape::kRows * DQK * 2;
  static constexpr int kK = kDo + T::DqShape::kRows * DV * 2;
  static constexpr int kV = kK + 2 * T::kDqKeys * DQK * 2;
  static constexpr int kPos = kV + 2 * T::kDqKeys * DV * 2;  // the key tiles' positions
  static constexpr int kRow = kPos + 2 * T::kDqKeys * 4;     // the query rows' positions, lse (log2), D
  static constexpr int kBytes = kRow + T::DqShape::kRows * 12;
};

// grid (b * H, query tiles), the last query tile first. Writes D =
// rowsum(dO * O) of its rows, which the dK/dV kernel reads after it.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2) attention_dq_kernel(const Args a) {
  using L = DqSmem<DQK, DV>;
  using S = typename Tiles<DQK, DV>::DqShape;
  constexpr int BR = S::kRows, BC = Tiles<DQK, DV>::kDqKeys, MT = S::kMt, NTH = S::kThreads;
  static_assert(NTH == kThreads, "the launch bounds' block");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kPos);

  const int bi = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / (a.H / a.K);
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * BR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int row0 = warp * 16 * MT;
  const int nk = (a.s + BC - 1) / BC;
  const float scale2 = a.scale * kLog2e;  // scores in units of log2, for ex2
  const int* bnd = a.bounds + 2LL * bi * a.n_bnd;
  const Span qs = span_of(bnd, q0 / kQuantum, BR / kQuantum, a.n_bnd);

  const __nv_bfloat16* kg = a.k + bi * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = a.v + bi * a.v_sb + kvh * a.v_sh;
  const int* pg = a.pos + bi * a.pos_sb;

  load_tile<BR, DQK, NTH>(sbase + L::kQ, a.q + bi * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss, a.s - q0);
  load_tile<BR, DV, NTH>(sbase + L::kDo, a.dout + bi * a.d_sb + h * a.d_sh + q0 * a.d_ss, a.d_ss, a.s - q0);
  cp_async_commit();
  auto issue = [&](int kt, int st) {
    const int k0 = kt * BC;
    load_tile<BC, DQK, NTH>(sbase + L::kK + st * BC * DQK * 2, kg + k0 * a.k_ss, a.k_ss, a.s - k0);
    load_tile<BC, DV, NTH>(sbase + L::kV + st * BC * DV * 2, vg + k0 * a.v_ss, a.v_ss, a.s - k0);
    load_row<BC>(kpos_s + st * BC, pg + k0, a.s - k0, INT_MAX);
  };
  int kt = next_key_tile<BC>(-1, nk, bnd, a.n_bnd, qs, a.window);
  if (kt < nk) issue(kt, 0);
  cp_async_commit();

  // per-row values wait in shared memory, not in registers across the loop
  int* qpos_s = reinterpret_cast<int*>(smem + L::kRow);
  float* lse_s = reinterpret_cast<float*>(smem + L::kRow + BR * 4);
  float* d_s = reinterpret_cast<float*>(smem + L::kRow + BR * 8);
  const long long row_base = (static_cast<long long>(bi) * a.H + h) * a.s;
  for (int i = threadIdx.x; i < BR; i += NTH) {
    const bool in = q0 + i < a.s;
    qpos_s[i] = in ? pg[q0 + i] : INT_MIN;
    lse_s[i] = in ? a.lse[row_base + q0 + i] * kLog2e : kInf;
  }

  cp_async_wait<1>();
  __syncthreads();
  // D for the warp's rows: each lane sums bf16 pairs at columns 2 lane +
  // 64 j in order, then the warp's butterfly
  for (int r = 0; r < 16 * MT; ++r) {
    const int row = q0 + row0 + r;
    float acc = 0.f;
    if (row < a.s) {
      const __nv_bfloat16* og = a.o + (static_cast<long long>(bi) * a.s + row) * a.H * DV + h * DV;
#pragma unroll
      for (int c = 2 * lane; c < DV; c += 64) {
        const __nv_bfloat162 ov = *reinterpret_cast<const __nv_bfloat162*>(og + c);
        const __nv_bfloat162 dv = *reinterpret_cast<const __nv_bfloat162*>(
            smem + L::kDo + swz<DV>(row0 + r, c / 8) + (c % 8) * 2);
        acc = fmaf(__low2float(dv), __low2float(ov), acc);
        acc = fmaf(__high2float(dv), __high2float(ov), acc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      d_s[row0 + r] = acc;
      if (row < a.s) a.dsum[row_base + row] = acc;
    }
  }
  __syncwarp();

  float dq[MT][DQK / 8][4];
  zero(dq);
  int st = 0;
  while (kt < nk) {
    const int kn = next_key_tile<BC>(kt, nk, bnd, a.n_bnd, qs, a.window);
    if (kn < nk) issue(kn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t ks = sbase + L::kK + st * BC * DQK * 2;
    float sc[MT][BC / 8][4], dp[MT][BC / 8][4];
    zero(sc);
    zero(dp);
    mma_rows_rows<DQK, MT, BC / 8>(sc, sbase + L::kQ, row0, ks);
    mma_rows_rows<DV, MT, BC / 8>(dp, sbase + L::kDo, row0, sbase + L::kV + st * BC * DV * 2);
    const bool whole = (kt + 1) * BC <= a.s;
    const bool full =
        tile_class(qs, span_of(bnd, kt * (BC / kQuantum), BC / kQuantum, a.n_bnd), a.window, whole) == 2;
    const int* kp = kpos_s + st * BC;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < BC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + mt * 16 + (e >> 1) * 8 + g;
          float p = ex2(fmaf(sc[mt][n][e], scale2, -lse_s[r]));
          if (!full && !visible(kp[n * 8 + 2 * t4 + (e & 1)], qpos_s[r], a.window)) p = 0.f;
          sc[mt][n][e] = p * (dp[mt][n][e] - d_s[r]);  // dS
        }
    mma_regs_rows<DQK, MT, BC / 8>(dq, sc, ks);
    __syncthreads();
    st ^= 1;
    kt = kn;
  }

  float sv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) sv[mt][0] = sv[mt][1] = a.scale;
  cp_async_wait<0>();
  __syncthreads();
  stage_acc<DQK>(smem + L::kQ, dq, row0, sv);
  __syncthreads();
  // dQ is (b, s, H, DQK), contiguous
  store_tile<BR, DQK, NTH>(a.dq + ((static_cast<long long>(bi) * a.s + q0) * a.H + h) * DQK,
                           static_cast<long long>(a.H) * DQK, smem + L::kQ, a.s - q0);
}

// ---------------------------------------------------------------- dK, dV

template <int DQK, int DV>
struct DkvSmem {
  using T = Tiles<DQK, DV>;
  static constexpr int kK = 0;                                    // the key tile, then dK's staging
  static constexpr int kV = kK + T::DkvShape::kRows * DQK * 2;    // the value tile, then dV's staging
  static constexpr int kQ = kV + T::DkvShape::kRows * DV * 2;
  static constexpr int kDo = kQ + 2 * T::kDkvRows * DQK * 2;
  static constexpr int kLse = kDo + 2 * T::kDkvRows * DV * 2;
  static constexpr int kD = kLse + 2 * T::kDkvRows * 4;
  static constexpr int kPos = kD + 2 * T::kDkvRows * 4;
  static constexpr int kKpos = kPos + 2 * T::kDkvRows * 4;  // the key tile's positions
  static constexpr int kBytes = kKpos + T::DkvShape::kRows * 4;
};

// grid (b * K, key tiles): blockIdx.y = 0 is the first key tile, which a
// causal sequence's most queries see. Reads D from the dQ kernel.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 2) attention_dkv_kernel(const Args a) {
  using L = DkvSmem<DQK, DV>;
  using S = typename Tiles<DQK, DV>::DkvShape;
  constexpr int BC = S::kRows, BR = Tiles<DQK, DV>::kDkvRows, NTH = S::kThreads;
  static_assert(NTH == kThreads, "the launch bounds' block");
  static_assert(S::kMt == 1, "a warp owns one m-tile of keys");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* d_s = reinterpret_cast<float*>(smem + L::kD);
  int* qpos_s = reinterpret_cast<int*>(smem + L::kPos);

  const int G = a.H / a.K;
  const int bi = blockIdx.x / a.K, kvh = blockIdx.x % a.K;
  const int k0 = blockIdx.y * BC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int nq = (a.s + BR - 1) / BR;
  const float scale2 = a.scale * kLog2e;  // scores in units of log2, for ex2
  const int* bnd = a.bounds + 2LL * bi * a.n_bnd;
  const Span ks = span_of(bnd, k0 / kQuantum, BC / kQuantum, a.n_bnd);
  const bool whole = k0 + BC <= a.s;
  const int* pg = a.pos + bi * a.pos_sb;

  load_tile<BC, DQK, NTH>(sbase + L::kK, a.k + bi * a.k_sb + kvh * a.k_sh + k0 * a.k_ss, a.k_ss, a.s - k0);
  load_tile<BC, DV, NTH>(sbase + L::kV, a.v + bi * a.v_sb + kvh * a.v_sh + k0 * a.v_ss, a.v_ss, a.s - k0);
  cp_async_commit();
  // steps run over it = g * nq + query tile, in that order
  auto next = [&](int it) {
    for (++it; it < G * nq; ++it) {
      const int qt = it % nq;
      if (tile_class(span_of(bnd, qt * (BR / kQuantum), BR / kQuantum, a.n_bnd), ks, a.window, true) != 0) break;
    }
    return it;
  };
  auto issue = [&](int it, int st) {
    const int h = kvh * G + it / nq, q0 = (it % nq) * BR;
    const long long rb = (static_cast<long long>(bi) * a.H + h) * a.s + q0;
    load_tile<BR, DQK, NTH>(sbase + L::kQ + st * BR * DQK * 2, a.q + bi * a.q_sb + h * a.q_sh + q0 * a.q_ss, a.q_ss,
                            a.s - q0);
    load_tile<BR, DV, NTH>(sbase + L::kDo + st * BR * DV * 2, a.dout + bi * a.d_sb + h * a.d_sh + q0 * a.d_ss,
                           a.d_ss, a.s - q0);
    load_row<BR>(lse_s + st * BR, a.lse + rb, a.s - q0, kInf);
    load_row<BR>(d_s + st * BR, a.dsum + rb, a.s - q0, 0.f);
    load_row<BR>(qpos_s + st * BR, pg + q0, a.s - q0, INT_MIN);
  };
  int it = next(-1);
  if (it < G * nq) issue(it, 0);
  cp_async_commit();

  // the key positions wait in shared memory, not in registers across the loop
  int* kpos_s = reinterpret_cast<int*>(smem + L::kKpos);
  for (int i = threadIdx.x; i < BC; i += NTH) kpos_s[i] = k0 + i < a.s ? pg[k0 + i] : INT_MAX;

  float dk[1][DQK / 8][4], dv[1][DV / 8][4];
  zero(dk);
  zero(dv);
  int st = 0;
  while (it < G * nq) {
    const int in = next(it);
    if (in < G * nq) issue(in, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t qs_t = sbase + L::kQ + st * BR * DQK * 2, dos_t = sbase + L::kDo + st * BR * DV * 2;
    const int qt = it % nq;
    const bool full =
        tile_class(span_of(bnd, qt * (BR / kQuantum), BR / kQuantum, a.n_bnd), ks, a.window, whole) == 2;
    const float* ls = lse_s + st * BR;
    const float* ds = d_s + st * BR;
    const int* qp = qpos_s + st * BR;
    // S^T (keys x queries) and dP^T = V dO^T
    float sc[1][BR / 8][4], dp[1][BR / 8][4];
    zero(sc);
    zero(dp);
    mma_rows_rows<DQK, 1, BR / 8>(sc, sbase + L::kK, warp * 16, qs_t);
    mma_rows_rows<DV, 1, BR / 8>(dp, sbase + L::kV, warp * 16, dos_t);
#pragma unroll
    for (int n = 0; n < BR / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t4 + (e & 1);
        float p = ex2(fmaf(sc[0][n][e], scale2, -ls[c] * kLog2e));
        if (!full && !visible(kpos_s[warp * 16 + (e >> 1) * 8 + g], qp[c], a.window)) p = 0.f;
        sc[0][n][e] = p;                           // P^T
        dp[0][n][e] = p * (dp[0][n][e] - ds[c]);  // dS^T
      }
    }
    mma_regs_rows<DV, 1, BR / 8>(dv, sc, dos_t);
    mma_regs_rows<DQK, 1, BR / 8>(dk, dp, qs_t);
    __syncthreads();
    st ^= 1;
    it = in;
  }

  const float sk[1][2] = {{a.scale, a.scale}}, sv[1][2] = {{1.f, 1.f}};
  cp_async_wait<0>();
  __syncthreads();
  stage_acc<DQK>(smem + L::kK, dk, warp * 16, sk);
  stage_acc<DV>(smem + L::kV, dv, warp * 16, sv);
  __syncthreads();
  // dK, dV are (b, s, K, D), contiguous
  store_tile<BC, DQK, NTH>(a.dk + ((static_cast<long long>(bi) * a.s + k0) * a.K + kvh) * DQK,
                           static_cast<long long>(a.K) * DQK, smem + L::kK, a.s - k0);
  store_tile<BC, DV, NTH>(a.dv + ((static_cast<long long>(bi) * a.s + k0) * a.K + kvh) * DV,
                          static_cast<long long>(a.K) * DV, smem + L::kV, a.s - k0);
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Args make_args(void* const* ptr, const long long* strides, int b, int s, int H, int K, int window, float scale) {
  (void)b;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(ptr[0]);
  a.k = static_cast<const __nv_bfloat16*>(ptr[1]);
  a.v = static_cast<const __nv_bfloat16*>(ptr[2]);
  a.pos = static_cast<const int*>(ptr[3]);
  a.bounds = static_cast<const int*>(ptr[4]);
  a.out = static_cast<__nv_bfloat16*>(ptr[5]);
  a.lse = static_cast<float*>(ptr[6]);
  a.o = static_cast<const __nv_bfloat16*>(ptr[5]);
  a.dout = static_cast<const __nv_bfloat16*>(ptr[7]);
  a.dq = static_cast<__nv_bfloat16*>(ptr[8]);
  a.dk = static_cast<__nv_bfloat16*>(ptr[9]);
  a.dv = static_cast<__nv_bfloat16*>(ptr[10]);
  a.dsum = static_cast<float*>(ptr[11]);
  a.q_sb = strides[0], a.q_ss = strides[1], a.q_sh = strides[2];
  a.k_sb = strides[3], a.k_ss = strides[4], a.k_sh = strides[5];
  a.v_sb = strides[6], a.v_ss = strides[7], a.v_sh = strides[8];
  a.d_sb = strides[9], a.d_ss = strides[10], a.d_sh = strides[11];
  a.pos_sb = strides[12];
  a.s = s, a.H = H, a.K = K, a.window = window;
  a.n_bnd = (s + kQuantum - 1) / kQuantum;
  a.scale = scale;
  return a;
}

// the bounds kernel, then the forward (writes bounds, O and lse)
template <int DQK, int DV>
cudaError_t fwd_instance(const Args& a, int b, cudaStream_t st) {
  using S = typename Tiles<DQK, DV>::FwdShape;
  constexpr int bytes = FwdSmem<DQK, DV>::kBytes;
  cudaError_t err = opt_in(attention_fwd_kernel<DQK, DV>, bytes);
  if (err != cudaSuccess) return err;
  attention_bounds_kernel<<<dim3(a.n_bnd, b), kQuantum, 0, st>>>(a);
  attention_fwd_kernel<DQK, DV><<<dim3(b * a.H, (a.s + S::kRows - 1) / S::kRows), S::kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// dQ (and D), then dK and dV
template <int DQK, int DV>
cudaError_t bwd_instance(const Args& a, int b, cudaStream_t st) {
  using Q = typename Tiles<DQK, DV>::DqShape;
  using KV = typename Tiles<DQK, DV>::DkvShape;
  constexpr int dq_bytes = DqSmem<DQK, DV>::kBytes, dkv_bytes = DkvSmem<DQK, DV>::kBytes;
  cudaError_t err = opt_in(attention_dq_kernel<DQK, DV>, dq_bytes);
  if (err == cudaSuccess) err = opt_in(attention_dkv_kernel<DQK, DV>, dkv_bytes);
  if (err != cudaSuccess) return err;
  attention_dq_kernel<DQK, DV><<<dim3(b * a.H, (a.s + Q::kRows - 1) / Q::kRows), Q::kThreads, dq_bytes, st>>>(a);
  attention_dkv_kernel<DQK, DV>
      <<<dim3(b * a.K, (a.s + KV::kRows - 1) / KV::kRows), KV::kThreads, dkv_bytes, st>>>(a);
  return cudaGetLastError();
}

template <int DQK, int DV>
struct Widths {
  static constexpr int kQk = DQK, kV = DV;
};

// f(Widths<qk, v>()) for the instance the library holds at head widths
// (d_qk, d_v), cudaErrorInvalidValue at any other: the one table of the
// instances (ops.ATTENTION_HEAD_DIMS)
template <typename F>
cudaError_t with_instance(int d_qk, int d_v, F f) {
  if (d_qk == 128 && d_v == 128) return f(Widths<128, 128>());
  if (d_qk == 192 && d_v == 128) return f(Widths<192, 128>());
  return cudaErrorInvalidValue;
}

}  // namespace

// Pointers (12, as a host array): q, k, v, positions, bounds, out (O), lse,
// dO, dQ, dK, dV, D; unused ones may be null. Strides (13, elements, host
// array): q, k, v and dO each (batch, sequence, head), then the positions'
// batch stride. The bf16 tensors' last dimension is contiguous.
//
// forward: the bounds kernel, then the forward (writes bounds, O and lse)
extern "C" int attention_fwd_launch(void* const* ptr, const long long* strides, int b, int s, int H, int K,
                                    int window, int d_qk, int d_v, float scale, void* stream) {
  if (b <= 0 || s <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(ptr, strides, b, s, H, K, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_instance(d_qk, d_v, [&](auto w) {
    return fwd_instance<decltype(w)::kQk, decltype(w)::kV>(a, b, st);
  }));
}

// backward: dQ (and D), then dK and dV; reads the forward's bounds and lse
extern "C" int attention_bwd_launch(void* const* ptr, const long long* strides, int b, int s, int H, int K,
                                    int window, int d_qk, int d_v, float scale, void* stream) {
  if (b <= 0 || s <= 0 || H % K != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(ptr, strides, b, s, H, K, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_instance(d_qk, d_v, [&](auto w) {
    return bwd_instance<decltype(w)::kQk, decltype(w)::kV>(a, b, st);
  }));
}
