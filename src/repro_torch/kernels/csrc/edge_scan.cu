// K1: batched (feature, bin) histogram of w*y plus the stopping-rule scalars.
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_scan.py::edge_scan
// (body _edge_scan_kernel), which the JAX scanner launches once per worker
// under vmap. Here the worker axis is a grid axis: one launch scans the
// current chunk of all W workers.
//
//   hist[w, j, b] = sum_i wy[w, i] * [xb[w, i, j] == b]
//   scal[0, w] = sum_i |w[w, i]|,  scal[1, w] = sum_i w^2,  scal[2, w] = sum_i wy
//
// What bounds it on an H100: bytes. Each xb element (4 B) feeds B predicated
// adds, so at B = 8 the kernel does 2 operations per byte read, far below the
// card's ~20 fp32 operations per byte of HBM bandwidth. The work is reading
// xb once, coalesced, with enough bytes in flight to cover HBM latency.
//
// Design:
//   * one launch; the work unit is (row tile, worker). The wrapper
//     (kernels/ops.py::edge_scan_plan) sizes the tiles from n and the SM
//     count so that a lone worker fills the card too, and never from W: a
//     worker's sums are the same bits in any batch of workers (a rank of
//     the sharded engine scans W_local of them, one device W). W sets only
//     how many tiles a block takes: one (grid (tiles, W)) while the blocks
//     are few, a whole group of tiles folded in tile order (grid (groups,
//     W), no first-level ticket) once W x groups blocks fill the SMs;
//   * a block of 256 threads is laid out (row lanes x feature groups). With
//     VEC = 4 each thread loads an int4, four neighbouring features of one
//     row; 16 threads cover a row of d = 64, so a warp reads two whole rows
//     per load. Rows go in batches, all of a batch loaded before any is
//     added: eight rows on short tiles, and where a row lane has more than
//     two batches, four rows with the next batch loading while this one is
//     added (measured faster there, slower on short tiles). VEC = 1 (one int
//     per load) takes the ragged cases: d not a multiple of 4, an xb pointer
//     not 16-byte aligned, and B > 8;
//   * each thread adds into its own B-bin histograms in shared memory, laid
//     out so that a warp's 32 lanes hit 32 banks: a load, an add and a store
//     per element, where a one-hot over B bins in registers costs about 3B
//     instructions (measured slower on the card at B = 8);
//   * bins outside [0, B) add nothing (a predicated add);
//   * W, V and T come out of the same pass: the first feature group of each
//     row lane also loads w for its rows;
//   * no float atomics: a block sums its row lanes in a fixed order through
//     shared memory (threads over feature groups, so that the reads do not
//     pile onto one bank) and its scalars by a fixed-shape shuffle tree. With one
//     tile per worker it writes the result; a block that folds a group adds
//     each tile's sums to the group's in tile order; else it writes its tile's
//     partial to scratch, and a ticket (an integer atomicAdd after
//     __threadfence) finds the last block of its group of tiles, which sums
//     the group's partials in tile order, 32 loads in flight per thread. Many
//     tiles take a second level the same way: the last group sums the groups
//     in order. The last block resets its counter, so the zeroed counters are
//     reused by the next launch. The result is bitwise the same on every
//     launch with the same inputs, which the engine's "sparse == dense"
//     bit-exactness check on the card relies on. (Thread-block
//     clusters summing through distributed shared memory measured slower
//     here: their barriers cost more than the ticket.)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumBatch = 16;
// rows per batch of the plain loop (all loaded, then all added) and of the
// pipelined one (the next batch loads while this one is added)
constexpr int kRowsPlain = 8;
constexpr int kRowsPiped = 4;

// Sum `count` rows of `cells` floats (row r at src + r * cells) in row order,
// two cells per thread and kSumBatch rows at a time in flight. Cells below
// `hc` go to out_h[c], the three scalars to out_s[(c - hc) * s_stride]. The
// rows were written by other blocks of this launch: read them past L1.
__device__ void sum_partials(const float* src, int count, int cells, int hc, float* out_h,
                             float* out_s, int s_stride) {
  for (int c0 = threadIdx.x; c0 < cells; c0 += 2 * kThreads) {
    const int c1 = c0 + kThreads;
    const bool two = c1 < cells;
    float s0 = 0.f, s1 = 0.f;
    for (int r0 = 0; r0 < count; r0 += kSumBatch) {
      float a[kSumBatch], b[kSumBatch];
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        const size_t off = (size_t)(r0 + u) * cells;
        a[u] = r0 + u < count ? __ldcg(src + off + c0) : 0.f;
        b[u] = two && r0 + u < count ? __ldcg(src + off + c1) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSumBatch; ++u) {
        if (r0 + u < count) {
          s0 += a[u];
          s1 += b[u];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c = k ? c1 : c0;
      const float s = k ? s1 : s0;
      if (c >= cells) break;
      if (c < hc) {
        out_h[c] = s;
      } else {
        out_s[(size_t)(c - hc) * s_stride] = s;
      }
    }
  }
}

// Every writer fences, then thread 0 takes a ticket; true in every thread of
// the block that arrived last among `members`. That block resets the counter.
__device__ bool last_to_arrive(int* counter, int members, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(counter, 1);
    const bool last = prev == members - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

template <int VEC>
struct Bins;
template <>
struct Bins<4> {
  int v[4];
  __device__ __forceinline__ void load(const int* p) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
};
template <>
struct Bins<1> {
  int v[1];
  __device__ __forceinline__ void load(const int* p) { v[0] = __ldg(p); }
};

// One batch: rows i, i + R, ... (ROWS of them) of one feature group, with
// their wy and, for the scalars, their w; rows at or past row1 get bin -1
// and weight 0, so they are neither loaded nor added.
template <int VEC, int ROWS>
struct Batch {
  Bins<VEC> x[ROWS];
  float wy[ROWS];
  float w[ROWS];

  __device__ __forceinline__ void load(const int* col, const float* wyw, const float* ww, int i,
                                       int R, int row1, int d, bool scalars) {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = i + u * R;
      if (r < row1) {
        x[u].load(col + (size_t)r * d);
        wy[u] = __ldg(wyw + r);
        w[u] = scalars ? __ldg(ww + r) : 0.f;
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) x[u].v[v] = -1;
        wy[u] = 0.f;
        w[u] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void add(float* mine, int B, float (&sc)[3]) const {
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int b = x[u].v[v];
        if ((unsigned)b < (unsigned)B) mine[(v * B + b) * kThreads] += wy[u];
      }
      sc[0] += fabsf(w[u]);
      sc[1] += __fmul_rn(w[u], w[u]);
      sc[2] += wy[u];
    }
  }
};

// One row tile [row0, row1) of one worker: its histogram and scalars,
// folded into out_h / out_s (scalar k at out_s[k * s_stride]). The first
// tile a block scans starts its sums from 0, as sum_partials does, so a
// block that folds a group of tiles in tile order gets the bits that
// per-tile blocks and the ticket get.
template <int VEC, bool PIPED>
__device__ __forceinline__ void scan_tile(const int* xbw, const float* wyw, const float* ww,
                                          int row0, int row1, int d, int B, bool first,
                                          float* hs, float (*warp_sums)[kWarps], float* out_h,
                                          float* out_s, int s_stride) {
  const int tid = threadIdx.x;
  const int Q = (d + VEC - 1) / VEC;  // feature groups per row
  const int FQ = min(Q, kThreads);    // groups per pass over the tile
  const int R = kThreads / FQ;        // row lanes
  const int fq_t = tid % FQ;
  const int rl = tid / FQ;
  const int slots = VEC * B;
  float sc[3] = {0.f, 0.f, 0.f};  // |w|, w^2, wy of this thread's rows (first group only)

  for (int q0 = 0; q0 < Q; q0 += FQ) {
    const int fq = q0 + fq_t;
    float* mine = hs + tid;
    for (int k = 0; k < slots; ++k) mine[k * kThreads] = 0.f;
    if (rl < R && fq < Q) {
      const int* col = xbw + fq * VEC;
      const bool scalars = fq == 0;
      float lane_sc[3] = {0.f, 0.f, 0.f};
      if (PIPED) {
        Batch<VEC, kRowsPiped> cur, next;
        int i = row0 + rl;
        cur.load(col, wyw, ww, i, R, row1, d, scalars);
        for (; i < row1; i += kRowsPiped * R) {
          next.load(col, wyw, ww, i + kRowsPiped * R, R, row1, d, scalars);
          cur.add(mine, B, lane_sc);
          cur = next;
        }
      } else {
        for (int i = row0 + rl; i < row1; i += kRowsPlain * R) {
          Batch<VEC, kRowsPlain> batch;
          batch.load(col, wyw, ww, i, R, row1, d, scalars);
          batch.add(mine, B, lane_sc);
        }
      }
      if (scalars) {
#pragma unroll
        for (int k = 0; k < 3; ++k) sc[k] = lane_sc[k];
      }
    }
    __syncthreads();
    // row lanes are summed in lane order. Neighbouring threads take
    // neighbouring feature groups of one (slot, bin), so a warp's reads
    // spread over the banks (with (feature, bin) neighbours they all hit one).
    // A cell is always folded by the same thread, which reads back its own
    // store of the tile before
    const int pass_cells = FQ * slots;
    for (int c = tid; c < pass_cells; c += kThreads) {
      const int fql = c % FQ;
      const int vb = c / FQ;  // v * B + b
      const int j = (q0 + fql) * VEC + vb / B;
      if (j < d) {
        const float* r = hs + vb * kThreads + fql;
        float s = 0.f;
        for (int k = 0; k < R; ++k) s += r[k * FQ];
        float* o = out_h + j * B + vb % B;
        *o = (first ? 0.f : *o) + s;
      }
    }
    __syncthreads();
  }

  // the tile's scalars: a fixed-shape shuffle tree per warp, then warps in order
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sc[k] += __shfl_xor_sync(0xffffffffu, sc[k], off);
    if (tid % 32 == 0) warp_sums[k][tid / 32] = sc[k];
  }
  __syncthreads();
  if (tid < 3) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += warp_sums[tid][k];
    float* o = out_s + (size_t)tid * s_stride;
    *o = (first ? 0.f : *o) + s;
  }
}

// Grid (ceil(tiles / fold), W): a block scans tiles [x * fold, x * fold + fold)
// of worker y. fold is 1 (one tile a block, summed across blocks by the
// ticket) or group (a block folds a whole group of tiles in tile order, with
// no first-level ticket); both give the same bits.
template <int VEC, bool PIPED>
__global__ void __launch_bounds__(kThreads)
    edge_scan_kernel(const int* __restrict__ xb, const float* __restrict__ wy,
                     const float* __restrict__ w, int W, int n, int d, int B, int tile_rows,
                     int tiles, int group, int fold, float* __restrict__ part1,
                     float* __restrict__ part2, int* __restrict__ counters,
                     float* __restrict__ hist, float* __restrict__ scal) {
  // VEC * B * kThreads floats: thread t's sum of feature slot v, bin b at
  // hs[(v * B + b) * kThreads + t], so the 32 lanes of a warp always hit 32
  // different banks
  extern __shared__ float hs[];
  __shared__ float warp_sums[3][kWarps];
  __shared__ int flag;
  const int tile0 = blockIdx.x * fold;
  const int wk = blockIdx.y;
  const int hc = d * B;
  const int cells = hc + 3;
  const int groups = (tiles + group - 1) / group;
  const int g = tile0 / group;

  // where this block's sums go: the result (one tile, or the fold of a
  // worker's only group), its tile's partial, or its group's sum
  float* out_h = hist + (size_t)wk * hc;
  float* out_s = scal + wk;
  int s_stride = W;
  if (tiles > 1 && (fold == 1 || groups > 1)) {
    out_h = fold == 1 ? part1 + ((size_t)wk * tiles + tile0) * cells
                      : part2 + ((size_t)wk * groups + g) * cells;
    out_s = out_h + hc;
    s_stride = 1;
  }
  const int tile1 = min(tile0 + fold, tiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    scan_tile<VEC, PIPED>(xb + (size_t)wk * n * d, wy + (size_t)wk * n, w + (size_t)wk * n,
                          tile * tile_rows, min((tile + 1) * tile_rows, n), d, B, tile == tile0,
                          hs, warp_sums, out_h, out_s, s_stride);
  }
  if (tiles == 1) return;

  // cross-tile sums, in tile order, by the last block to arrive
  int* cnt = counters + (size_t)wk * (groups + 1);
  if (fold == 1) {
    const int members = min(group, tiles - g * group);
    if (!last_to_arrive(cnt + g, members, &flag)) return;
    const float* src1 = part1 + ((size_t)wk * tiles + (size_t)g * group) * cells;
    if (groups == 1) {
      sum_partials(src1, members, cells, hc, hist + (size_t)wk * hc, scal + wk, W);
      return;
    }
    float* mid = part2 + ((size_t)wk * groups + g) * cells;
    sum_partials(src1, members, cells, hc, mid, mid + hc, 1);
  } else if (groups == 1) {
    return;  // the block folded all of the worker's tiles into the result
  }
  if (!last_to_arrive(cnt + groups, groups, &flag)) return;
  sum_partials(part2 + (size_t)wk * groups * cells, groups, cells, hc, hist + (size_t)wk * hc,
               scal + wk, W);
}

}  // namespace

// xb (W, n, d) int32, wy/w (W, n) f32 -> hist (W, d, B) f32, scal (3, W) f32.
// Plan (kernels/ops.py::edge_scan_plan): tiles = ceil(n / tile_rows) >= 1
// row tiles per worker, in groups of `group` tiles, `fold` (1 or group) tiles
// a block. With tiles > 1 the scratch is part1 (W, tiles, d*B + 3) (fold 1
// only) and part2 (W, ceil(tiles / group), d*B + 3) f32 and counters
// (W, ceil(tiles / group) + 1) int32, zero on entry and zero again on exit.
// Requires 1 <= B <= 32, W >= 1.
extern "C" int edge_scan_launch(const int* xb, const float* wy, const float* w, float* part1,
                                float* part2, int* counters, float* hist, float* scal, int W,
                                int n, int d, int B, int tile_rows, int tiles, int group,
                                int fold, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid((tiles + fold - 1) / fold, W);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0 && B <= 8;
  const int vec = vec4 ? 4 : 1;
  const size_t smem = (size_t)vec * B * kThreads * sizeof(float);
  // pipeline the row loop only when a row lane has more than two of its
  // batches: on short tiles the plain loop's longer batch is faster
  const int groups_per_row = (d + vec - 1) / vec;
  const int lanes = kThreads / (groups_per_row < kThreads ? groups_per_row : kThreads);
  const bool piped = (tile_rows + lanes - 1) / lanes > 2 * kRowsPiped;
#define EDGE_SCAN_LAUNCH(V, P)                                                                   \
  edge_scan_kernel<V, P><<<grid, kThreads, smem, stream>>>(xb, wy, w, W, n, d, B, tile_rows,     \
                                                           tiles, group, fold, part1, part2,     \
                                                           counters, hist, scal)
  if (vec4) {
    if (piped) EDGE_SCAN_LAUNCH(4, true); else EDGE_SCAN_LAUNCH(4, false);
  } else {
    if (piped) EDGE_SCAN_LAUNCH(1, true); else EDGE_SCAN_LAUNCH(1, false);
  }
#undef EDGE_SCAN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
