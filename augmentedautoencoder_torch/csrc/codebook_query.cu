// Codebook cosine top-k for Hopper (sm_90a): the serving query kernels.
//
// Replaces three Pallas TPU kernels of augmentedautoencoder_tpu:
//   * ops/multi_codebook.py  grouped_codebook_top1 (_mc_top1_kernel)
//   * ops/multi_codebook.py  grouped_codebook_topk (_mc_topk_kernel)
//   * ops/nn_query.py        cosine_top1_pallas    (_top1_kernel)
// All three score B l2-normalized queries against the rows of one (N, D)
// codebook plane (for the slab, plane `obj` of an (O, N_pad, D) array),
// mask rows >= n_valid (and, with stride > 1, rows whose index is not a
// multiple of stride) to -2, and return the k best (value, index) pairs
// per query, best first, ties to the lowest index -- lax.top_k's contract.
// Top-1 is k = 1. Every comparison is ordered by (value desc, index asc).
//
// What bounds it on an H100: the read of one codebook plane. At B = 8 a
// 92,232 x 128 plane is 47 MB in f32 (24 MB in bf16) against 2*B*D*N =
// 0.19 GFLOP, i.e. ~2-4 FLOP per byte, far below the card's FMA rate per
// byte of HBM bandwidth (14 / 7 us of HBM against 2.8 us of f32 FMAs). At
// B = 64 the f32 FMAs (22 us) pass the bytes. Two designs:
//
// aae_codebook_topk (grouped_codebook_top1, cosine_top1_cuda), the first
// port: pass 1 gives each block a contiguous row range in 256-row tiles
// and a chunk of 8 queries (blockIdx.y; a plane is read once per chunk),
// stages each tile through shared memory in 16-column slices with scalar
// loads and two barriers per slice, and scores one row per thread with f32
// FMAs; each warp keeps one query's running top-k in registers (lane j
// holds entry j; only candidates beating the k-th entry are inserted, by
// ballot + shuffle). Pass 2 (topk_merge_kernel) merges the blocks' lists.
//
// aae_codebook_topk_stream (grouped_codebook_topk), the redesign for what
// held the first one back -- scalar 2-byte loads, no copy in flight while
// the FMAs run, a few KB in flight per SM, the plane re-read per 8 queries:
// a persistent grid (2 blocks per SM) walks the plane in tiles of whole
// rows; 16-byte cp.async copies keep up to 3 tiles (~50 KB) per block in
// flight in a shared-memory ring, and rows the mask discards are not read.
// Each tile is scored once for all of the block's up to 64 queries: a bf16
// slab on the tensor cores (mma.sync m16n8k16, f32 accumulation; bf16
// products are exact in f32), an f32 slab on the CUDA cores (f32 FMAs,
// never TF32). The scores go through shared memory and each warp offers
// them to its queries' top-k lists, inserting one at a time when few
// candidates beat the k-th entry and by a bitonic sort and merge when many
// do. topk_merge_wide_kernel merges the blocks' lists, a block of 8 warps
// per query. Measured on the card, the per-tile scoring on the CUDA cores
// and the one-at-a-time inserts, not the bytes, were what bounded the first
// version of this design; see PERF.md.
// Blocks run in no order, so nothing is carried between them: the second
// pass replaces the TPU grid's sequential carry of the running top-k.
// Plane offsets are computed in 64-bit (a 30-object f32 slab is 1.45 GB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;            // rows per tile: one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kQB = kWarps;              // queries per block: one warp each
constexpr int kDC = 16;                  // codebook columns staged per pass
constexpr int kMaxD = 256;
constexpr int kMaxK = 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// The order of lax.top_k: larger value first, equal values by lower index.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A warp's running top-k, sorted best first: lane j holds entry j for
// j < k; empty entries are (-inf, INT_MAX), which every candidate beats.
struct WarpTopK {
  float v;
  int i;

  __device__ void init() {
    v = -INFINITY;
    i = INT_MAX;
  }

  __device__ void insert(float cv, int ci, int k, int lane) {
    // entries that beat the candidate form a prefix of the sorted list
    const unsigned ahead = __ballot_sync(kFull, lane < k && better(v, i, cv, ci));
    const int pos = __popc(ahead);
    const float up_v = __shfl_up_sync(kFull, v, 1);
    const int up_i = __shfl_up_sync(kFull, i, 1);
    if (pos < k) {
      if (lane == pos) {
        v = cv;
        i = ci;
      } else if (lane > pos) {
        v = up_v;
        i = up_i;
      }
    }
  }

  // One candidate per lane; inserts, in lane order, those that beat the
  // k-th entry (insert re-checks against the list as it changes).
  __device__ void offer(float cv, int ci, bool ok, int k, int lane) {
    const float kv = __shfl_sync(kFull, v, k - 1);
    const int ki = __shfl_sync(kFull, i, k - 1);
    unsigned todo = __ballot_sync(kFull, ok && better(cv, ci, kv, ki));
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      insert(__shfl_sync(kFull, cv, src), __shfl_sync(kFull, ci, src), k, lane);
    }
  }

  // Compare-exchange with lane ^ stride: keep the better of the two
  // entries, or the worse.
  __device__ static void exchange(float& v, int& i, int stride, bool keep_better) {
    const float ov = __shfl_xor_sync(kFull, v, stride);
    const int oi = __shfl_xor_sync(kFull, i, stride);
    if (keep_better ? better(ov, oi, v, i) : better(v, i, ov, oi)) {
      v = ov;
      i = oi;
    }
  }

  // offer() for the streaming kernels: when more than 3 candidates beat
  // the k-th entry, they are sorted best first by a bitonic network and
  // merged with the list by a bitonic merge (20 exchange steps in all),
  // instead of being inserted one at a time (one dependent chain of
  // shuffles each). The list's lanes >= k are ignored.
  __device__ void offer_many(float cv, int ci, bool ok, int k, int lane) {
    const float kv = __shfl_sync(kFull, v, k - 1);
    const int ki = __shfl_sync(kFull, i, k - 1);
    const bool beats = ok && better(cv, ci, kv, ki);
    unsigned todo = __ballot_sync(kFull, beats);
    if (__popc(todo) <= 3) {
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        insert(__shfl_sync(kFull, cv, src), __shfl_sync(kFull, ci, src), k, lane);
      }
      return;
    }
    float sv = beats ? cv : -INFINITY;
    int si = beats ? ci : INT_MAX;
    for (int size = 2; size <= 32; size <<= 1) {
      for (int stride = size / 2; stride >= 1; stride >>= 1) {
        exchange(sv, si, stride, ((lane & size) == 0) == ((lane & stride) == 0));
      }
    }
    merge_sorted(sv, si, k, lane);
  }

  // Merges 32 candidates sorted best first (one per lane) into the list:
  // the list against the candidates reversed gives, pair by pair, a bitonic
  // sequence that holds the best 32 of both, which a bitonic merge sorts.
  __device__ void merge_sorted(float cv, int ci, int k, int lane) {
    float mv = lane < k ? v : -INFINITY;
    int mi = lane < k ? i : INT_MAX;
    const float rv = __shfl_sync(kFull, cv, 31 - lane);
    const int ri = __shfl_sync(kFull, ci, 31 - lane);
    if (better(rv, ri, mv, mi)) {
      mv = rv;
      mi = ri;
    }
    for (int stride = 16; stride >= 1; stride >>= 1) exchange(mv, mi, stride, (lane & stride) == 0);
    v = mv;
    i = mi;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_partial_kernel(const T* __restrict__ q, const T* __restrict__ cb, int obj,
                    int64_t rows_per_obj, int n_rows, int n_valid, int stride,
                    int B, int D, int k, int rows_per_block,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ float q_s[kQB][kMaxD];
  __shared__ float cb_s[kThreads][kDC + 1];  // +1: conflict-free row reads
  __shared__ float sc_s[kQB][kThreads];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qbase = blockIdx.y * kQB;
  const int nq = min(kQB, B - qbase);
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(row_begin + rows_per_block, n_rows);
  const T* plane = cb + static_cast<int64_t>(obj) * rows_per_obj * D;

  for (int e = tid; e < kQB * kMaxD; e += kThreads) {
    const int qq = e / kMaxD;
    const int d = e % kMaxD;
    q_s[qq][d] = (qq < nq && d < D) ? widen(q[static_cast<int64_t>(qbase + qq) * D + d]) : 0.f;
  }

  WarpTopK top;
  top.init();

  for (int tile = row_begin; tile < row_end; tile += kThreads) {
    float acc[kQB];
#pragma unroll
    for (int qq = 0; qq < kQB; ++qq) acc[qq] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();  // q_s written / previous slice consumed
#pragma unroll
      for (int j = 0; j < kDC; ++j) {
        const int e = tid + j * kThreads;
        const int r = e / kDC;
        const int c = e % kDC;
        const int g = tile + r;
        float val = 0.f;
        if (g < row_end && d0 + c < D) val = widen(plane[static_cast<int64_t>(g) * D + d0 + c]);
        cb_s[r][c] = val;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const float c = cb_s[tid][d];
#pragma unroll
        for (int qq = 0; qq < kQB; ++qq) acc[qq] = fmaf(q_s[qq][d0 + d], c, acc[qq]);
      }
    }

    const int g = tile + tid;
    const bool valid = g < n_valid && (stride <= 1 || g % stride == 0);
#pragma unroll
    for (int qq = 0; qq < kQB; ++qq) sc_s[qq][tid] = valid ? acc[qq] : -2.f;
    __syncthreads();

    if (warp < nq) {
#pragma unroll
      for (int r = 0; r < kThreads / 32; ++r) {
        const int j = r * 32 + lane;
        top.offer(sc_s[warp][j], tile + j, tile + j < row_end, k, lane);
      }
    }
  }

  if (warp < nq && lane < k) {
    const int64_t o = (static_cast<int64_t>(qbase + warp) * gridDim.x + blockIdx.x) * k + lane;
    part_v[o] = top.v;
    part_i[o] = top.i;
  }
}

__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                  int n_parts, int k, int B, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // whole warp leaves together

  const int64_t n = static_cast<int64_t>(n_parts) * k;
  const float* pv = part_v + b * n;
  const int* pi = part_i + b * n;
  WarpTopK top;
  top.init();
  for (int64_t base = 0; base < n; base += 32) {
    const int64_t j = base + lane;
    const bool in = j < n;
    const float v = in ? pv[j] : -INFINITY;
    const int i = in ? pi[j] : INT_MAX;
    top.offer(v, i, in && i != INT_MAX, k, lane);
  }
  if (lane < k) {
    out_v[static_cast<int64_t>(b) * k + lane] = top.v;
    out_i[static_cast<int64_t>(b) * k + lane] = top.i;
  }
}

// ---- the streaming top-k (grouped_codebook_topk)

// The streaming kernel's second pass: one block per query. Each warp
// merges a strided share of the query's n_parts lists into its own top-k,
// then warp 0 merges the 8 warps' sorted lists by bitonic merges (every
// row index is in exactly one
// list, so the order of the offers does not change the result). Eight
// warps in parallel instead of one, and 8 loads in flight per warp: the
// loop is bound by the latency of its loads and inserts, not by bytes.
__global__ void __launch_bounds__(kThreads)
topk_merge_wide_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                       int n_parts, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float list_v[kWarps][kMaxK];
  __shared__ int list_i[kWarps][kMaxK];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t b = blockIdx.x;
  const int64_t n = static_cast<int64_t>(n_parts) * k;
  const float* pv = part_v + b * n;
  const int* pi = part_i + b * n;
  WarpTopK top;
  top.init();
  constexpr int kAhead = 8;  // chunks of 32 loaded before they are offered
  for (int64_t base = warp * 32; base < n; base += kThreads * kAhead) {
    float v[kAhead];
    int ix[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int64_t j = base + u * kThreads + lane;
      v[u] = j < n ? pv[j] : -INFINITY;
      ix[u] = j < n ? pi[j] : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) top.offer_many(v[u], ix[u], ix[u] != INT_MAX, k, lane);
  }
  if (lane < k) {
    list_v[warp][lane] = top.v;
    list_i[warp][lane] = top.i;
  }
  __syncthreads();
  if (warp == 0) {
    WarpTopK fin;
    fin.init();
    for (int w = 0; w < kWarps; ++w) {
      const bool in = lane < k;
      const float v = in ? list_v[w][lane] : -INFINITY;
      const int i = in ? list_i[w][lane] : INT_MAX;
      fin.merge_sorted(v, i, k, lane);  // each warp's list is sorted
    }
    if (lane < k) {
      out_v[b * k + lane] = fin.v;
      out_i[b * k + lane] = fin.i;
    }
  }
}

constexpr int kStreamQ = 64;    // queries per block: every plane tile is read once for these
constexpr int kQPT = 4;         // queries per scoring item (one row x 4 queries per thread)
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float* c, unsigned a0, unsigned a1, unsigned a2,
                                               unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Dynamic shared memory of the streaming kernel: `stages` row tiles of
// rows_per_tile rows padded by 16 bytes (conflict-free row reads), the
// block's queries (f32 slab: widened to f32, rows of D + 4 floats; bf16
// slab: as they are, rows of D + 8 bf16; zero-filled up to 8 queries), the
// tile's scores, and the queries' running top-k lists (value, index).
inline size_t stream_smem_bytes(int stages, int rows_per_tile, int row_bytes, int qb, int D,
                                int k) {
  const int qpad = (qb + 7) / 8 * 8;
  return static_cast<size_t>(stages) * rows_per_tile * (row_bytes + 16) +
         static_cast<size_t>(qpad) * (D + 8) * sizeof(float) +
         static_cast<size_t>(qb) * rows_per_tile * sizeof(float) +
         static_cast<size_t>(qb) * k * (sizeof(float) + sizeof(int));
}

// Scores of tile `t` (R rows) for the block's qb queries into sc[q][r],
// masked rows -2. f32 slab: CUDA-core FMAs (never TF32), one row x kQPT
// queries per thread.
__device__ __forceinline__ void score_tile_f32(const unsigned char* tile, int row_stride,
                                               const float* q_s, int D, int R, int qb, int t,
                                               int n_valid, int stride, float* sc) {
  const int groups = (qb + kQPT - 1) / kQPT;
  for (int item = threadIdx.x; item < R * groups; item += kThreads) {
    const int r = item % R;
    const int grp = item / R;
    const float* row = reinterpret_cast<const float*>(tile + r * row_stride);
    const float* qg = q_s + grp * kQPT * (D + 4);
    float acc[kQPT] = {};
    for (int d0 = 0; d0 < D; d0 += 4) {
      const float4 x = *reinterpret_cast<const float4*>(row + d0);
#pragma unroll
      for (int qq = 0; qq < kQPT; ++qq) {
        const float4 qv = *reinterpret_cast<const float4*>(qg + qq * (D + 4) + d0);
        acc[qq] = fmaf(qv.x, x.x, acc[qq]);
        acc[qq] = fmaf(qv.y, x.y, acc[qq]);
        acc[qq] = fmaf(qv.z, x.z, acc[qq]);
        acc[qq] = fmaf(qv.w, x.w, acc[qq]);
      }
    }
    const int g = t * R + r;
    const bool valid = g < n_valid && (stride <= 1 || g % stride == 0);
#pragma unroll
    for (int qq = 0; qq < kQPT; ++qq) {
      const int qi = grp * kQPT + qq;
      if (qi < qb) sc[qi * R + r] = valid ? acc[qq] : -2.f;
    }
  }
}

// bf16 slab: the tensor cores, mma.sync m16n8k16 with f32 accumulation
// (products of two bf16 values are exact in f32). Warp items are (16-row,
// 8-query) tiles; fragments are read from the padded rows as 32-bit words
// (rows g and g + 8 of the tile, k pairs 2 tig and 2 tig + 8: banks
// 4 g + tig, conflict-free).
__device__ __forceinline__ void score_tile_bf16(const unsigned char* tile, int row_stride,
                                                const unsigned char* q_s, int D, int R, int qb,
                                                int t, int n_valid, int stride, float* sc) {
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int tig = threadIdx.x % 4;
  const int m_tiles = R / 16;
  const int q_stride = (D + 8) * 2;
  for (int item = warp; item < m_tiles * ((qb + 7) / 8); item += kWarps) {
    const int mt = item % m_tiles;
    const int nt = item / m_tiles;
    const unsigned char* a_lo = tile + (mt * 16 + g) * row_stride + tig * 4;
    const unsigned char* a_hi = a_lo + 8 * row_stride;
    const unsigned char* b = q_s + (nt * 8 + g) * q_stride + tig * 4;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < 2 * D; k0 += 32) {
      mma_bf16_16816(c, ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 16),
                     ld32(a_hi + k0 + 16), ld32(b + k0), ld32(b + k0 + 16));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      const int row = t * R + r;
      const bool valid = row < n_valid && (stride <= 1 || row % stride == 0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qi = nt * 8 + 2 * tig + e;
        if (qi < qb) sc[qi * R + r] = valid ? c[2 * h + e] : -2.f;
      }
    }
  }
}

// One persistent block walks plane tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...: 16-byte cp.async copies keep `Stages - 1` tiles in flight
// while the block scores the current one for all of its (up to 64)
// queries with f32 FMAs, then each warp offers the tile's scores to the
// running top-k lists of its queries (warp w owns queries w, w + 8, ...).
// The lists live in shared memory between tiles and in the warp's
// registers while it offers (lane j holds entry j), so one copy of the
// offer code serves every query.
template <typename T, int Stages>
__global__ void __launch_bounds__(kThreads, 2)
topk_stream_kernel(const T* __restrict__ q, const T* __restrict__ cb, int obj,
                   int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B, int D,
                   int k, int rows_per_tile, int n_tiles, float* __restrict__ part_v,
                   int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qbase = blockIdx.y * kStreamQ;
  const int qb = min(kStreamQ, B - qbase);
  const int qpad = (qb + 7) / 8 * 8;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int row_stride = row_bytes + 16;
  const int chunks = row_bytes / 16;
  const int R = rows_per_tile;
  unsigned char* tiles = smem;
  unsigned char* q_s = smem + static_cast<size_t>(Stages) * R * row_stride;
  float* sc = reinterpret_cast<float*>(q_s + static_cast<size_t>(qpad) * (D + 8) * sizeof(float));
  float* list_v = sc + qb * R;
  int* list_i = reinterpret_cast<int*>(list_v + qb * k);
  const unsigned char* plane = reinterpret_cast<const unsigned char*>(cb) +
                               static_cast<int64_t>(obj) * rows_per_obj * row_bytes;

  for (int e = tid; e < qpad * D; e += kThreads) {
    const int qq = e / D;
    const int d = e - qq * D;
    const T v = qq < qb ? q[static_cast<int64_t>(qbase + qq) * D + d] : T(0.f);
    if constexpr (std::is_same<T, float>::value) {
      reinterpret_cast<float*>(q_s)[qq * (D + 4) + d] = v;
    } else {
      reinterpret_cast<T*>(q_s)[qq * (D + 8) + d] = v;
    }
  }

  // rows the scores need: masked rows score -2 whatever they hold, so
  // they are not read
  auto load_tile = [&](int t, int stage) {
    unsigned char* dst = tiles + static_cast<size_t>(stage) * R * row_stride;
    for (int e = tid; e < R * chunks; e += kThreads) {
      const int r = e / chunks;
      const int c = e - r * chunks;
      const int g = t * R + r;
      if (g < n_rows && g < n_valid && (stride <= 1 || g % stride == 0)) {
        cp_async16(dst + r * row_stride + c * 16, plane + static_cast<int64_t>(g) * row_bytes + c * 16);
      }
    }
  };

  for (int e = tid; e < qb * k; e += kThreads) {
    list_v[e] = -INFINITY;
    list_i[e] = INT_MAX;
  }

  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
#pragma unroll
  for (int s = 0; s < Stages - 1; ++s) {
    if (s < my_tiles) load_tile(blockIdx.x + s * gridDim.x, s);
    cp_async_commit();
  }

  for (int it = 0; it < my_tiles; ++it) {
    const int t = blockIdx.x + it * gridDim.x;
    const int ahead = it + Stages - 1;
    if (ahead < my_tiles) load_tile(blockIdx.x + ahead * gridDim.x, ahead % Stages);
    cp_async_commit();
    cp_async_wait<Stages - 1>();
    __syncthreads();  // tile `it` has landed for every thread; sc is free

    const unsigned char* tile = tiles + static_cast<size_t>(it % Stages) * R * row_stride;
    if constexpr (std::is_same<T, float>::value) {
      score_tile_f32(tile, row_stride, reinterpret_cast<const float*>(q_s), D, R, qb, t, n_valid,
                     stride, sc);
    } else {
      score_tile_bf16(tile, row_stride, q_s, D, R, qb, t, n_valid, stride, sc);
    }
    __syncthreads();  // scores complete; the stage may be refilled

#pragma unroll 1
    for (int qi = warp; qi < qb; qi += kWarps) {
      WarpTopK top;
      top.v = lane < k ? list_v[qi * k + lane] : -INFINITY;
      top.i = lane < k ? list_i[qi * k + lane] : INT_MAX;
      for (int r0 = 0; r0 < R; r0 += 32) {
        const int g = t * R + r0 + lane;
        const bool in = g < n_rows;
        top.offer_many(in ? sc[qi * R + r0 + lane] : -INFINITY, g, in, k, lane);
      }
      if (lane < k) {
        list_v[qi * k + lane] = top.v;
        list_i[qi * k + lane] = top.i;
      }
    }
  }
  __syncthreads();  // every list is complete

  for (int e = tid; e < qb * k; e += kThreads) {
    const int qi = e / k;
    const int64_t o = (static_cast<int64_t>(qbase + qi) * gridDim.x + blockIdx.x) * k + (e - qi * k);
    part_v[o] = list_v[e];
    part_i[o] = list_i[e];
  }
}

template <typename T, int Stages>
int launch_stream(const void* q, const void* cb, int obj, int64_t rows_per_obj, int n_rows,
                  int n_valid, int stride, int B, int D, int k, int rows_per_tile, int n_blocks,
                  size_t smem, cudaStream_t s, void* part_v, void* part_i) {
  auto kernel = topk_stream_kernel<T, Stages>;
  // the attribute is set once per device and size (a runtime call per launch
  // costs host time on a launch-bound path)
  static size_t set_for[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || set_for[dev] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) set_for[dev] = smem;
  }
  const int n_tiles = (n_rows + rows_per_tile - 1) / rows_per_tile;
  const dim3 grid(n_blocks, (B + kStreamQ - 1) / kStreamQ);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(cb), obj,
                                      rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                      rows_per_tile, n_tiles, static_cast<float*>(part_v),
                                      static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream_stages(int stages, const void* q, const void* cb, int obj,
                         int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B, int D,
                         int k, int rows_per_tile, int n_blocks, size_t smem, cudaStream_t s,
                         void* part_v, void* part_i) {
  switch (stages) {
    case 2:
      return launch_stream<T, 2>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 rows_per_tile, n_blocks, smem, s, part_v, part_i);
    case 3:
      return launch_stream<T, 3>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 rows_per_tile, n_blocks, smem, s, part_v, part_i);
    case 4:
      return launch_stream<T, 4>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 rows_per_tile, n_blocks, smem, s, part_v, part_i);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Scores q (B, D) against rows [0, n_rows) of plane `obj` of cb, whose
// planes are rows_per_obj rows apart (a 2-D codebook is obj 0). q and cb
// share one element type: f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// part_v/part_i hold B * n_parts * k scratch entries; out_v/out_i (B, k).
// Returns cudaGetLastError() after the launches (0 on success).
int aae_codebook_topk(const void* q, const void* cb, int is_bf16, int obj,
                      int64_t rows_per_obj, int n_rows, int n_valid, int stride,
                      int B, int D, int k, int rows_per_block, int n_parts,
                      void* part_v, void* part_i, void* out_v, void* out_i,
                      void* stream) {
  if (B < 1 || D < 1 || D > kMaxD || k < 1 || k > kMaxK || n_parts < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_parts, (B + kQB - 1) / kQB);
  if (is_bf16) {
    topk_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cb), obj,
        rows_per_obj, n_rows, n_valid, stride, B, D, k, rows_per_block,
        static_cast<float*>(part_v), static_cast<int*>(part_i));
  } else {
    topk_partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(cb), obj, rows_per_obj,
        n_rows, n_valid, stride, B, D, k, rows_per_block, static_cast<float*>(part_v),
        static_cast<int*>(part_i));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_merge_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), n_parts, k, B,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// The streaming top-k of grouped_codebook_topk: the same function as
// aae_codebook_topk, computed by topk_stream_kernel (n_blocks persistent
// blocks, `stages` tiles of rows_per_tile rows, a multiple of 32) and
// merged by topk_merge_wide_kernel. The row width D * sizeof(element) must be
// a multiple of 16 bytes and the slab 16-byte aligned. part_v/part_i hold
// B * n_blocks * k entries; out_v/out_i (B, k). Returns cudaGetLastError()
// after the launches (0 on success).
int aae_codebook_topk_stream(const void* q, const void* cb, int is_bf16, int obj,
                             int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B,
                             int D, int k, int rows_per_tile, int stages, int n_blocks,
                             void* part_v, void* part_i, void* out_v, void* out_i, void* stream) {
  const int row_bytes = D * (is_bf16 ? 2 : 4);
  if (B < 1 || D < 1 || D > kMaxD || row_bytes % 16 || (is_bf16 && D % 16) || k < 1 ||
      k > kMaxK || n_rows < 1 ||
      n_blocks < 1 || rows_per_tile < 32 || rows_per_tile % 32 ||
      reinterpret_cast<uintptr_t>(cb) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = stream_smem_bytes(stages, rows_per_tile, row_bytes, std::min(B, kStreamQ), D, k);
  const int rc = is_bf16
      ? launch_stream_stages<__nv_bfloat16>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid,
                                            stride, B, D, k, rows_per_tile, n_blocks, smem, s,
                                            part_v, part_i)
      : launch_stream_stages<float>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B,
                                    D, k, rows_per_tile, n_blocks, smem, s, part_v, part_i);
  if (rc != 0) return rc;
  topk_merge_wide_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), n_blocks, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// out[0..2]: shared memory per SM, the most one block may opt in to, and
// what the runtime reserves in each block, in bytes, of device `device`.
// The streaming top-k's plan is sized from these. Returns a cudaError_t.
int aae_device_smem(int device, int* out) {
  const cudaDeviceAttr attrs[3] = {cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrReservedSharedMemoryPerBlock};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = cudaDeviceGetAttribute(&out[i], attrs[i], device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* aae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
