// Codebook cosine top-1 and top-k for Hopper (sm_90a): the serving query
// kernels.
//
// Replaces three Pallas TPU kernels of augmentedautoencoder_tpu:
//   * ops/multi_codebook.py  grouped_codebook_top1 (_mc_top1_kernel)  -> top1_stream_kernel
//   * ops/nn_query.py        cosine_top1_pallas    (_top1_kernel)     -> top1_stream_kernel
//   * ops/multi_codebook.py  grouped_codebook_topk (_mc_topk_kernel)  -> topk_stream_kernel
// All three score B l2-normalized queries against the rows of one (N, D)
// codebook plane (for the slab, plane `obj` of an (O, N_pad, D) array),
// mask rows >= n_valid (and, for the top-k with stride > 1, rows whose
// index is not a multiple of stride) to -2, and return the k best
// (value, index) pairs per query, best first, ties to the lowest index --
// lax.top_k's contract; the top-1 is the first maximum, as argmax gives
// it. Every comparison is ordered by (value desc, index asc).
//
// What bounds them on an H100: at B = 8 the read of one codebook plane. A
// 92,232 x 128 plane is 47 MB in f32 (24 MB in bf16) against 2*B*D*N =
// 0.19 GFLOP, ~2-4 FLOP per byte, far below the card's FMA rate per byte
// of HBM bandwidth (14 / 7 us of HBM against 2.8 us of f32 FMAs). At
// B = 64 the f32 operations (22 us at 67 TFLOP/s) pass the bytes. On the
// card, a few us of launch, first-tile latency and cross-block merge sit
// on top of either, and most of a B = 8 call is that (PERF.md).
//
// Both kernels are one design: a persistent grid (2 blocks per SM) walks
// the plane in tiles of whole rows; 16-byte cp.async copies keep up to 3
// tiles per block in flight in a shared-memory ring (reads overlap the
// scoring), rows the mask discards are not read, and each tile is read once
// for all of a block's up to 64 queries. A bf16 slab is scored on the
// tensor cores (mma.sync m16n8k16, f32 accumulation; bf16 products are
// exact in f32), an f32 slab on the CUDA cores (f32 FMAs, never TF32).
//   topk_stream_kernel: the scores go through shared memory and each warp
//     offers them to its queries' top-k lists (one insert at a time when
//     few candidates beat the k-th entry, a bitonic sort and merge when
//     many do); topk_merge_wide_kernel merges the blocks' lists. Two
//     launches.
//   top1_stream_kernel: no list and no per-tile offer -- each thread keeps
//     its queries' best (value, index) in registers across its tiles, the
//     block reduces them once at its end (warp shuffles and a shared
//     atomicMax of order-mapped 64-bit keys) and the blocks meet in a global
//     atomicMax per query; the last block to arrive writes the result and
//     resets the keys. One launch; the order of arrival does not change
//     the result.
// Blocks run in no order, so nothing is carried between them: the merges
// replace the TPU grid's sequential carry of the running result. Plane
// offsets are computed in 64-bit (a 30-object f32 slab is 1.45 GB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kMaxK = 32;

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

  // One candidate per lane; those that beat the k-th entry go into the
  // list: up to 3 are inserted one at a time; when more do, they are sorted best first by a bitonic network and
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

constexpr int kStreamQ = 64;    // queries per block at most: every plane tile is read once for these
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
// gridDim.x, ... for its chunk of q_per_block queries (blockIdx.y; up to
// 64, fewer where a wide latent leaves no room for two ring stages beside
// 64 queries' scores and lists): 16-byte cp.async copies keep `Stages - 1`
// tiles in flight while the block scores the current one for all of its
// queries, then each warp offers the tile's scores to the running top-k
// lists of its queries (warp w owns queries w, w + 8, ...). Tiles are a
// multiple of 16 rows (the bf16 mma's row step); a warp offers 32 rows at
// a time, so a 16-row tile leaves lanes 16-31 idle. The lists live in
// shared memory between tiles and in the warp's registers while it offers
// (lane j holds entry j), so one copy of the offer code serves every query.
template <typename T, int Stages>
__global__ void __launch_bounds__(kThreads, 2)
topk_stream_kernel(const T* __restrict__ q, const T* __restrict__ cb, int obj,
                   int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B, int D,
                   int k, int q_per_block, int rows_per_tile, int n_tiles,
                   float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qbase = blockIdx.y * q_per_block;
  const int qb = min(q_per_block, B - qbase);
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
        const bool in = r0 + lane < R && g < n_rows;
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
                  int n_valid, int stride, int B, int D, int k, int q_per_block,
                  int rows_per_tile, int n_blocks, size_t smem, cudaStream_t s, void* part_v,
                  void* part_i) {
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
  const dim3 grid(n_blocks, (B + q_per_block - 1) / q_per_block);
  kernel<<<grid, kThreads, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(cb), obj,
                                      rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                      q_per_block, rows_per_tile, n_tiles,
                                      static_cast<float*>(part_v),
                                      static_cast<int*>(part_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream_stages(int stages, const void* q, const void* cb, int obj,
                         int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B, int D,
                         int k, int q_per_block, int rows_per_tile, int n_blocks, size_t smem,
                         cudaStream_t s, void* part_v, void* part_i) {
  switch (stages) {
    case 2:
      return launch_stream<T, 2>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 q_per_block, rows_per_tile, n_blocks, smem, s, part_v, part_i);
    case 3:
      return launch_stream<T, 3>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 q_per_block, rows_per_tile, n_blocks, smem, s, part_v, part_i);
    case 4:
      return launch_stream<T, 4>(q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B, D, k,
                                 q_per_block, rows_per_tile, n_blocks, smem, s, part_v, part_i);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the streaming top-1 (grouped_codebook_top1, cosine_top1_cuda)

constexpr int kTop1MaxQ = 64;     // queries per block at most
constexpr int kTop1Pairs = 16;    // running (value, index) pairs a thread keeps

// (value, index) as one 64-bit integer whose unsigned order is the order
// of the top-1: the value's bits mapped so that unsigned order is float
// order (-0.0 keyed as +0.0, which the plain argmax treats as equal), the
// index complemented below them, so the largest key is the largest value
// and, among equal values, the lowest index. 0 is below every key.
__device__ __forceinline__ unsigned long long top1_key(float v, int i) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(k) << 32) | static_cast<unsigned>(~i);
}

__device__ __forceinline__ float top1_key_value(unsigned long long key) {
  const unsigned k = static_cast<unsigned>(key >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ int top1_key_index(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned>(key));
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long x, int from) {
  for (int off = from; off < 32; off <<= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, x, off);
    x = o > x ? o : x;
  }
  return x;
}

// Dynamic shared memory of the top-1 kernel: `stages` row tiles padded by
// 16 bytes, the block's queries (as in the top-k kernel) and one key per
// query.
inline size_t top1_smem_bytes(int stages, int rows_per_tile, int row_bytes, int qpb, int D) {
  const int qpad = (qpb + 7) / 8 * 8;
  return static_cast<size_t>(stages) * rows_per_tile * (row_bytes + 16) +
         static_cast<size_t>(qpad) * (D + 8) * sizeof(float) +
         static_cast<size_t>(qpb) * sizeof(unsigned long long);
}

// One persistent block walks plane tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... of its chunk of q_per_block queries (blockIdx.y). The ring
// is the top-k kernel's (16-byte cp.async of whole rows, masked rows not
// read), with one barrier per tile: the wait at the top of iteration `it`
// leaves Stages - 2 tiles in flight, and the stage refilled right after the
// barrier is the one every thread finished scoring in iteration it - 1.
// Each thread scores fixed items of every tile and keeps, in registers,
// the best (value, index) of each query of its items over all of its
// tiles: no list, no per-tile offer. At its end the block reduces them
// once (warp shuffles of order-mapped keys, then a shared-memory atomicMax
// per query) and meets the other blocks in one global atomicMax per query;
// the last block of the chunk to arrive (an arrival counter) reads the
// keys, writes (value, index) and leaves keys and counter 0 for the next
// launch, so a call is this one launch and nothing else.
//   f32 slab: an item is one row x QPT queries, CUDA-core FMAs over float4
//     (never TF32); the 32 rows of a warp share their queries, so query
//     reads are broadcasts.
//   bf16 slab: an item is a (16-row, 8-query) mma.sync m16n8k16 tile with
//     f32 accumulation, warp w taking items w, w + 8, ...
template <typename T, int Stages, int QPT>
__global__ void __launch_bounds__(kThreads, 2)
top1_stream_kernel(const T* __restrict__ q, const T* __restrict__ cb, int obj,
                   int64_t rows_per_obj, int n_rows, int n_valid, int B, int D, int q_per_block,
                   int rows_per_tile, int n_tiles, unsigned long long* __restrict__ state,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kSlots = kF32 ? kTop1Pairs / QPT : kTop1Pairs / 2;
  constexpr int kPer = kF32 ? QPT : 2;  // queries per slot
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_block;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int qbase = blockIdx.y * q_per_block;
  const int qb = min(q_per_block, B - qbase);
  const int qpad = (qb + 7) / 8 * 8;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int row_stride = row_bytes + 16;
  const int chunks = row_bytes / 16;
  const int R = rows_per_tile;
  unsigned char* tiles = smem;
  unsigned char* q_s = smem + static_cast<size_t>(Stages) * R * row_stride;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      q_s + static_cast<size_t>((q_per_block + 7) / 8 * 8) * (D + 8) * sizeof(float));
  const unsigned char* plane = reinterpret_cast<const unsigned char*>(cb) +
                               static_cast<int64_t>(obj) * rows_per_obj * row_bytes;

  // this thread's 16-byte pieces of a tile: rows r0 + k (rows_step), ...
  // pieces c0 + k (chunk_step) carried past `chunks` (no division per copy)
  const int r0 = tid / chunks;
  const int c0 = tid - r0 * chunks;
  const int rows_step = kThreads / chunks;
  const int chunk_step = kThreads - rows_step * chunks;
  const int g_end = min(n_rows, n_valid);  // rows past it score -2 whatever they hold: not read
  auto load_tile = [&](int t, int stage) {
    unsigned char* dst = tiles + static_cast<size_t>(stage) * R * row_stride;
    const unsigned char* src = plane + static_cast<int64_t>(t) * R * row_bytes;
    const int rows_here = min(R, g_end - t * R);
    int r = r0, c = c0;
    while (r < rows_here) {
      cp_async16(dst + r * row_stride + c * 16, src + static_cast<int64_t>(r) * row_bytes + c * 16);
      r += rows_step;
      c += chunk_step;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  };

  float best_v[kSlots][kPer];
  int best_i[kSlots][kPer];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      best_v[s][e] = -INFINITY;
      best_i[s][e] = INT_MAX;
    }
  }
  auto offer = [&](int s, int e, float v, int g) {
    if (better(v, g, best_v[s][e], best_i[s][e])) {
      best_v[s][e] = v;
      best_i[s][e] = g;
    }
  };

  // f32: item = tid + s * kThreads is row item % R of query group item / R
  // (R is a multiple of 32, so a warp's items share their group).
  // bf16: item = warp + s * kWarps is m-tile item % (R / 16) of n-tile
  // item / (R / 16).
  const int items = kF32 ? R * ((qb + QPT - 1) / QPT) : (R / 16) * (qpad / 8);
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
#pragma unroll
  for (int s = 0; s < Stages - 1; ++s) {
    if (s < my_tiles) load_tile(blockIdx.x + s * gridDim.x, s);
    cp_async_commit();
  }
  // the queries, while the first tiles are in flight
  for (int e = tid; e < qpad * D; e += kThreads) {
    const int qq = e / D;
    const int d = e - qq * D;
    const T v = qq < qb ? q[static_cast<int64_t>(qbase + qq) * D + d] : T(0.f);
    if constexpr (kF32) {
      reinterpret_cast<float*>(q_s)[qq * (D + 4) + d] = v;
    } else {
      reinterpret_cast<T*>(q_s)[qq * (D + 8) + d] = v;
    }
  }
  for (int e = tid; e < qb; e += kThreads) keys[e] = 0ull;
  __syncthreads();  // queries and keys written

  for (int it = 0; it < my_tiles; ++it) {
    const int t = blockIdx.x + it * gridDim.x;
    cp_async_wait<Stages - 2>();
    __syncthreads();  // tile `it` has landed for every thread; stage it - 1 is free
    const int ahead = it + Stages - 1;
    if (ahead < my_tiles) load_tile(blockIdx.x + ahead * gridDim.x, ahead % Stages);
    cp_async_commit();

    const unsigned char* tile = tiles + static_cast<size_t>(it % Stages) * R * row_stride;
    if constexpr (kF32) {
      const float* qf = reinterpret_cast<const float*>(q_s);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int item = tid + s * kThreads;
        if (item < items) {
          const int r = item % R;
          const int grp = item / R;
          const float* row = reinterpret_cast<const float*>(tile + r * row_stride);
          const float* qg = qf + grp * QPT * (D + 4);
          float acc[QPT] = {};
#pragma unroll 2
          for (int d0 = 0; d0 < D; d0 += 4) {
            const float4 x = *reinterpret_cast<const float4*>(row + d0);
#pragma unroll
            for (int qq = 0; qq < QPT; ++qq) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + qq * (D + 4) + d0);
              acc[qq] = fmaf(qv.x, x.x, acc[qq]);
              acc[qq] = fmaf(qv.y, x.y, acc[qq]);
              acc[qq] = fmaf(qv.z, x.z, acc[qq]);
              acc[qq] = fmaf(qv.w, x.w, acc[qq]);
            }
          }
          const int g = t * R + r;
          if (g < n_rows) {
            const bool valid = g < n_valid;
#pragma unroll
            for (int qq = 0; qq < QPT; ++qq) offer(s, qq, valid ? acc[qq] : -2.f, g);
          }
        }
      }
    } else {
      const int gq = lane / 4;
      const int tig = lane % 4;
      const int m_tiles = R / 16;
      const int q_stride = (D + 8) * 2;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int item = warp + s * kWarps;
        if (item < items) {  // whole warps
          const int mt = item % m_tiles;
          const int nt = item / m_tiles;
          const unsigned char* a_lo = tile + (mt * 16 + gq) * row_stride + tig * 4;
          const unsigned char* a_hi = a_lo + 8 * row_stride;
          const unsigned char* b = q_s + (nt * 8 + gq) * q_stride + tig * 4;
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          for (int k0 = 0; k0 < 2 * D; k0 += 32) {
            mma_bf16_16816(c, ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 16),
                           ld32(a_hi + k0 + 16), ld32(b + k0), ld32(b + k0 + 16));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int g = t * R + mt * 16 + gq + 8 * h;
            if (g < n_rows) {
              const bool valid = g < n_valid;
              offer(s, 0, valid ? c[2 * h] : -2.f, g);
              offer(s, 1, valid ? c[2 * h + 1] : -2.f, g);
            }
          }
        }
      }
    }
  }

  // the block's best per query: shuffles among the lanes that share a
  // query, then one shared-memory atomicMax per query and warp
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if constexpr (kF32) {
      const int item = tid + s * kThreads;
      if (item < items) {
        const int grp = item / R;
#pragma unroll
        for (int qq = 0; qq < QPT; ++qq) {
          const int qi = grp * QPT + qq;
          unsigned long long key =
              best_i[s][qq] == INT_MAX ? 0ull : top1_key(best_v[s][qq], best_i[s][qq]);
          key = warp_max_u64(key, 1);
          if (lane == 0 && qi < qb && key) atomicMax(keys + qi, key);
        }
      }
    } else {
      const int item = warp + s * kWarps;
      if (item < items) {
        const int nt = item / (R / 16);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = nt * 8 + 2 * (lane % 4) + e;
          unsigned long long key =
              best_i[s][e] == INT_MAX ? 0ull : top1_key(best_v[s][e], best_i[s][e]);
          key = warp_max_u64(key, 4);  // lanes of one tig hold the same queries
          if (lane < 4 && qi < qb && key) atomicMax(keys + qi, key);
        }
      }
    }
  }
  __syncthreads();

  // the chunk's keys (state[0, B)) meet in global atomicMax; the last
  // block of the chunk to arrive (its counter, state[B + chunk]) reads them,
  // writes (value, index) and leaves keys and counter 0 for the next launch
  unsigned long long* gkeys = state + qbase;
  for (int e = tid; e < qb; e += kThreads) atomicMax(gkeys + e, keys[e]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(state + B + blockIdx.y, 1ull) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int e = tid; e < qb; e += kThreads) {
    const unsigned long long key = atomicExch(gkeys + e, 0ull);
    out_v[qbase + e] = top1_key_value(key);
    out_i[qbase + e] = top1_key_index(key);
  }
  if (tid == 0) state[B + blockIdx.y] = 0ull;
}

template <typename T, int Stages, int QPT>
int launch_top1(const void* q, const void* cb, int obj, int64_t rows_per_obj, int n_rows,
                int n_valid, int B, int D, int q_per_block, int rows_per_tile, int n_blocks,
                size_t smem, cudaStream_t s, void* state, void* out_v, void* out_i) {
  auto kernel = top1_stream_kernel<T, Stages, QPT>;
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
  const dim3 grid(n_blocks, (B + q_per_block - 1) / q_per_block);
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(cb), obj, rows_per_obj, n_rows, n_valid, B,
      D, q_per_block, rows_per_tile, n_tiles, static_cast<unsigned long long*>(state),
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int QPT>
int launch_top1_stages(int stages, const void* q, const void* cb, int obj, int64_t rows_per_obj,
                       int n_rows, int n_valid, int B, int D, int q_per_block, int rows_per_tile,
                       int n_blocks, size_t smem, cudaStream_t s, void* state, void* out_v,
                       void* out_i) {
  switch (stages) {
    case 2:
      return launch_top1<T, 2, QPT>(q, cb, obj, rows_per_obj, n_rows, n_valid, B, D, q_per_block,
                                    rows_per_tile, n_blocks, smem, s, state, out_v, out_i);
    case 3:
      return launch_top1<T, 3, QPT>(q, cb, obj, rows_per_obj, n_rows, n_valid, B, D, q_per_block,
                                    rows_per_tile, n_blocks, smem, s, state, out_v, out_i);
    case 4:
      return launch_top1<T, 4, QPT>(q, cb, obj, rows_per_obj, n_rows, n_valid, B, D, q_per_block,
                                    rows_per_tile, n_blocks, smem, s, state, out_v, out_i);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The streaming top-k of grouped_codebook_topk. Scores q (B, D) against
// rows [0, n_rows) of plane `obj` of cb, whose planes are rows_per_obj rows
// apart (a 2-D codebook is obj 0); q and cb share one element type, f32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); rows >= n_valid, and rows not a
// multiple of `stride`, score -2. Computed by topk_stream_kernel (n_blocks
// persistent blocks for each chunk of q_per_block queries, `stages` tiles
// of rows_per_tile rows, a multiple of 16) and merged by
// topk_merge_wide_kernel. The row width D * sizeof(element) must be
// a multiple of 16 bytes and the slab 16-byte aligned. part_v/part_i hold
// B * n_blocks * k entries; out_v/out_i (B, k). Returns cudaGetLastError()
// after the launches (0 on success).
int aae_codebook_topk_stream(const void* q, const void* cb, int is_bf16, int obj,
                             int64_t rows_per_obj, int n_rows, int n_valid, int stride, int B,
                             int D, int k, int q_per_block, int rows_per_tile, int stages,
                             int n_blocks, void* part_v, void* part_i, void* out_v, void* out_i,
                             void* stream) {
  const int row_bytes = D * (is_bf16 ? 2 : 4);
  if (B < 1 || D < 1 || D > kMaxD || row_bytes % 16 || (is_bf16 && D % 16) || k < 1 ||
      k > kMaxK || n_rows < 1 || q_per_block < 1 || q_per_block > kStreamQ ||
      n_blocks < 1 || rows_per_tile < 16 || rows_per_tile % 16 ||
      reinterpret_cast<uintptr_t>(cb) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem =
      stream_smem_bytes(stages, rows_per_tile, row_bytes, std::min(B, q_per_block), D, k);
  const int rc = is_bf16
      ? launch_stream_stages<__nv_bfloat16>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid,
                                            stride, B, D, k, q_per_block, rows_per_tile,
                                            n_blocks, smem, s, part_v, part_i)
      : launch_stream_stages<float>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid, stride, B,
                                    D, k, q_per_block, rows_per_tile, n_blocks, smem, s, part_v,
                                    part_i);
  if (rc != 0) return rc;
  topk_merge_wide_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), n_blocks, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// The streaming top-1 of grouped_codebook_top1 and cosine_top1_cuda: q (B, D)
// against rows [0, n_rows) of plane `obj` of cb (planes rows_per_obj rows
// apart), rows >= n_valid scoring -2; out_v (B,) f32 and out_i (B,) int32,
// the first maximum. One launch of n_blocks x ceil(B / q_per_block) blocks
// (`stages` tiles of rows_per_tile rows, a multiple of 32; qpt queries per
// f32 item, 2 or 8). The row width D * sizeof(element) must be a multiple
// of 16 bytes (of 32 in bf16) and the slab 16-byte aligned. state holds
// B + ceil(B / q_per_block) 64-bit words (8-byte aligned: the queries' keys
// and the chunks' arrival counters) that are 0 before the launch and 0
// again after it. Returns cudaGetLastError() after the launch (0 on
// success).
int aae_codebook_top1_stream(const void* q, const void* cb, int is_bf16, int obj,
                             int64_t rows_per_obj, int n_rows, int n_valid, int B, int D,
                             int q_per_block, int qpt, int rows_per_tile, int stages,
                             int n_blocks, void* state, void* out_v, void* out_i, void* stream) {
  const int row_bytes = D * (is_bf16 ? 2 : 4);
  const int qpad = (q_per_block + 7) / 8 * 8;
  if (B < 1 || D < 1 || D > kMaxD || row_bytes % 16 || (is_bf16 && D % 16) || n_rows < 1 ||
      n_blocks < 1 || q_per_block < 1 || q_per_block > kTop1MaxQ || rows_per_tile < 32 ||
      rows_per_tile % 32 || (!is_bf16 && qpt != 2 && qpt != 8) ||
      reinterpret_cast<uintptr_t>(cb) % 16 || reinterpret_cast<uintptr_t>(state) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the running pairs a thread keeps (kTop1Pairs)
  const int slots = is_bf16 ? (rows_per_tile / 16 * (qpad / 8) + kWarps - 1) / kWarps
                            : (rows_per_tile * ((q_per_block + qpt - 1) / qpt) + kThreads - 1) / kThreads;
  if (slots * (is_bf16 ? 2 : qpt) > kTop1Pairs) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = top1_smem_bytes(stages, rows_per_tile, row_bytes, q_per_block, D);
  if (is_bf16) {
    return launch_top1_stages<__nv_bfloat16, 2>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid,
                                                B, D, q_per_block, rows_per_tile, n_blocks, smem,
                                                s, state, out_v, out_i);
  }
  return qpt == 2
      ? launch_top1_stages<float, 2>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid, B, D,
                                     q_per_block, rows_per_tile, n_blocks, smem, s, state,
                                     out_v, out_i)
      : launch_top1_stages<float, 8>(stages, q, cb, obj, rows_per_obj, n_rows, n_valid, B, D,
                                     q_per_block, rows_per_tile, n_blocks, smem, s, state,
                                     out_v, out_i);
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
