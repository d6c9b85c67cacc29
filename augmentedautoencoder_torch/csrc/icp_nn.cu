// Batched 3-D nearest neighbour for Hopper (sm_90a): the ICP
// correspondence step.
//
// Replaces the Pallas TPU kernel augmentedautoencoder_tpu/ops/icp_nn.py
// batched_nn_pallas (all three of its variants: _nn_kernel with
// _scores_vpu or _scores_mxu, and _nn_kernel_sweep). For each lane l < n and
// each source point i < N it returns the distance to the nearest of the
// lane's N destination points and the index of the first point that
// reaches it. As in the plain version (ops/icp_nn.py batched_nn_torch), both
// clouds are centred on the lane's destination centroid mu, and the search
// minimises
//
//   score(i, j) = ((s'x_i dx_j + s'y_i dy_j) + s'z_i dz_j) + |d_j|^2,
//
// with s' = -2 (src - mu) and d = dst - mu, the only j-dependent part of
// |s - d|^2; the distance is sqrt(max(|s|^2 + min score, 0)).
//
// Exactness: every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn / __fsub_rn, which nvcc never contracts into an FMA) in the
// plain version's order, mu is the plain version's tree_sum (zero-pad to a
// power of two, then x[i] + x[i + h] for h = W/2, ..., 1) times the same
// f32 reciprocal of N, and every (min, argmin) keeps the first minimum
// with a strict < in ascending j. So the kernel returns the plain
// version's distances and indices bit for bit (ties to the lowest index,
// as torch.min and jnp.argmin).
//
// What bounds it on an H100: operations. At the main path's shape (8 lanes
// of N = 3000, pose/icp.py) the scores are 72 M pairs of 3 multiplies and
// 3 adds, 6.4 us at the 67 TFLOP/s f32 peak, or ~17 us as issued
// instructions (6 f32 operations, a compare and a select per pair, no FMA
// allowed) at 33.8 T f32 instructions/s, against < 1 us to read 0.6 MB
// of inputs. So the design keeps scores out of memory, spends the kernel on
// the CUDA cores, and works to fill the card and to cut the launches
// around the search:
//   nn_prep_kernel, up to 4 blocks per lane: the lane's centroid (the tree's
//     first levels in registers, 3 in shared memory, the last 5 by warp
//     shuffles), the centred destination rows (dx, dy, dz, |d|^2) as
//     float4, and the lane's keys and arrival counters reset.
//   nn_search_kernel, grid (source blocks, destination splits, lanes):
//     each block stages its split of rows in shared memory and scans it
//     with 4 source points per thread, so one shared-memory broadcast feeds
//     4 pairs. Splitting the destinations puts ~4 blocks of 8 warps on
//     every SM even at 8 lanes. Each block merges its split's (min, argmin)
//     per source point by one 64-bit atomicMin of (score order << 32 | j),
//     which keeps the first minimum whatever the order of arrival, and the
//     last block of each source block to arrive (an arrival counter) writes
//     the distances and indices.
// Two launches per call, nothing else: the wrapper only allocates.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kNnThreads = 256;
constexpr int kPts = 4;                            // source points per thread
constexpr int kSrcPerBlock = kNnThreads * kPts;    // 1024
constexpr int kRegLeaves = 16;                     // centroid leaves a thread sums in registers
constexpr int kMaxLevels = 24;                     // stack depth of the wider case: M <= 2^22
constexpr int kMaxN = 1 << 30;
constexpr int kPrepParts = 4;                      // nn_prep_kernel blocks per lane

// The three coordinate sums of a lane's points p (N, 3) in tree_sum's
// order: zero-pad to W = 2^ceil(log2 N) leaves, then x[i] + x[i + h] for
// h = W/2, ..., 1. Thread i < S = min(W, kNnThreads) owns the leaves
// i + m S, m < M = W / S, which the levels h >= S pair within the thread
// (top bit of m first): in registers for M <= 16 (N <= 4096), else by a
// stack over m in bit-reversed order, which makes those levels an adjacent
// pairwise sum. Levels S/2 .. 32 halve the slots in shared memory, the
// last five run in one warp per coordinate by shuffles. buf holds
// 3 * kNnThreads + 3 floats; ends with a barrier.
__device__ float3 lane_tree_sum(const float* __restrict__ p, int N, float* buf) {
  int W = 1;
  while (W < N) W <<= 1;
  const int S = min(W, kNnThreads);
  const int M = W / S;
  const int i = threadIdx.x;
  if (i < S) {
    float acc[3];
    if (M <= kRegLeaves) {
      float v[3][kRegLeaves];
#pragma unroll
      for (int m = 0; m < kRegLeaves; ++m) {
        const int e = i + m * S;
        const bool in = m < M && e < N;
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][m] = in ? p[static_cast<int64_t>(e) * 3 + c] : 0.f;
      }
#pragma unroll
      for (int h = kRegLeaves / 2; h >= 1; h >>= 1) {
        if (h < M) {
#pragma unroll
          for (int m = 0; m < h; ++m) {
#pragma unroll
            for (int c = 0; c < 3; ++c) v[c][m] = __fadd_rn(v[c][m], v[c][m + h]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = v[c][0];
    } else {
      const int logM = __ffs(M) - 1;
      float st[3][kMaxLevels];
      int top = 0;
      for (int t = 0; t < M; ++t) {
        const int e = i + static_cast<int>(__brev(static_cast<unsigned>(t)) >> (32 - logM)) * S;
        float v[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c] = e < N ? p[static_cast<int64_t>(e) * 3 + c] : 0.f;
        for (int u = t; u & 1; u >>= 1) {
          --top;
#pragma unroll
          for (int c = 0; c < 3; ++c) v[c] = __fadd_rn(st[c][top], v[c]);
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) st[c][top] = v[c];
        ++top;
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[c] = st[c][0];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) buf[c * kNnThreads + i] = acc[c];
  }
  __syncthreads();
  for (int h = S / 2; h >= 32; h >>= 1) {
    if (i < h) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        buf[c * kNnThreads + i] = __fadd_rn(buf[c * kNnThreads + i], buf[c * kNnThreads + i + h]);
      }
    }
    __syncthreads();
  }
  const int warp = i / 32;
  const int lane = i % 32;
  const int Sw = min(S, 32);
  if (warp < 3) {
    float x = lane < Sw ? buf[warp * kNnThreads + lane] : 0.f;
    for (int h = Sw / 2; h >= 1; h >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, h));
    if (lane == 0) buf[3 * kNnThreads + warp] = x;
  }
  __syncthreads();
  return make_float3(buf[3 * kNnThreads], buf[3 * kNnThreads + 1], buf[3 * kNnThreads + 2]);
}

// The order of (score, j) as one 64-bit integer: the score's bits mapped
// so that unsigned order is float order (-0.0 keyed as +0.0, which
// torch.min and the strict < treat as equal), the index below them, so
// atomicMin keeps the smallest score and, among equal scores, the lowest j.
__device__ __forceinline__ unsigned long long nn_key(float score, int j) {
  unsigned u = __float_as_uint(score);
  if (u == 0x80000000u) u = 0u;
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(k) << 32) | static_cast<unsigned>(j);
}

__device__ __forceinline__ float nn_key_score(unsigned long long key) {
  const unsigned k = static_cast<unsigned>(key >> 32);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Launch 1, grid (lanes, parts): every block computes its lane's centroid
// mu (tree_sum order, times the f32 reciprocal of N); part p writes every
// gridDim.y-th run of 256 centred destination rows (dx, dy, dz, |d|^2) and
// sets those source points' keys to the largest value; part 0 writes mu
// and zeroes the lane's arrival counters.
__global__ void __launch_bounds__(kNnThreads)
nn_prep_kernel(const float* __restrict__ dst, int N, float inv_n, int src_blocks,
               float* __restrict__ mu, float4* __restrict__ rows,
               unsigned long long* __restrict__ keys, unsigned* __restrict__ arrivals) {
  __shared__ float buf[3 * kNnThreads + 3];
  const int64_t lane = blockIdx.x;
  const float* d_lane = dst + lane * N * 3;
  const float3 sum = lane_tree_sum(d_lane, N, buf);
  const float mx = __fmul_rn(sum.x, inv_n);
  const float my = __fmul_rn(sum.y, inv_n);
  const float mz = __fmul_rn(sum.z, inv_n);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    mu[lane * 3 + 0] = mx;
    mu[lane * 3 + 1] = my;
    mu[lane * 3 + 2] = mz;
  }
  for (int j = blockIdx.y * kNnThreads + threadIdx.x; j < N; j += gridDim.y * kNnThreads) {
    const float* q = d_lane + static_cast<int64_t>(j) * 3;
    const float dx = __fsub_rn(q[0], mx), dy = __fsub_rn(q[1], my), dz = __fsub_rn(q[2], mz);
    const float dsq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    rows[lane * N + j] = make_float4(dx, dy, dz, dsq);
    keys[lane * N + j] = ~0ull;
  }
  if (blockIdx.y == 0) {
    for (int b = threadIdx.x; b < src_blocks; b += kNnThreads) arrivals[lane * src_blocks + b] = 0u;
  }
}

// Launch 2, grid (source blocks, destination splits, lanes): the split's
// rows in a shared-memory tile, 4 source points per thread (s' = -2 (src -
// mu) in registers), the first minimum over the split, then one atomicMin
// of its key per source point. The last block of a (lane, source block) to
// arrive reads the merged keys and writes the distances and indices.
__global__ void __launch_bounds__(kNnThreads)
nn_search_kernel(const float* __restrict__ src, const float4* __restrict__ rows,
                 const float* __restrict__ mu, int N, int split_len,
                 unsigned long long* __restrict__ keys, unsigned* __restrict__ arrivals,
                 float* __restrict__ out_dist, int* __restrict__ out_idx) {
  extern __shared__ float4 tile[];
  __shared__ bool last;
  const int64_t lane = blockIdx.z;
  const int j0 = blockIdx.y * split_len;
  const int count = min(split_len, N - j0);
  const float4* r_lane = rows + lane * N + j0;
  for (int j = threadIdx.x; j < count; j += kNnThreads) tile[j] = r_lane[j];

  const float mx = mu[lane * 3 + 0], my = mu[lane * 3 + 1], mz = mu[lane * 3 + 2];
  const float* s_lane = src + lane * N * 3;
  float sx[kPts], sy[kPts], sz[kPts], ss[kPts], best[kPts];
  int best_j[kPts];
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = min(static_cast<int>(blockIdx.x * kSrcPerBlock + p * kNnThreads + threadIdx.x), N - 1);
    const float* s = s_lane + static_cast<int64_t>(i) * 3;
    const float cx = __fsub_rn(s[0], mx), cy = __fsub_rn(s[1], my), cz = __fsub_rn(s[2], mz);
    ss[p] = __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz));
    sx[p] = __fmul_rn(-2.f, cx);
    sy[p] = __fmul_rn(-2.f, cy);
    sz[p] = __fmul_rn(-2.f, cz);
    best[p] = INFINITY;
    best_j[p] = j0;
  }
  __syncthreads();

#pragma unroll 4
  for (int j = 0; j < count; ++j) {
    const float4 q = tile[j];
#pragma unroll
    for (int p = 0; p < kPts; ++p) {
      const float score = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(sx[p], q.x), __fmul_rn(sy[p], q.y)), __fmul_rn(sz[p], q.z)),
          q.w);
      if (score < best[p]) {
        best[p] = score;
        best_j[p] = j0 + j;
      }
    }
  }

  unsigned long long* k_lane = keys + lane * N;
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = static_cast<int>(blockIdx.x * kSrcPerBlock + p * kNnThreads + threadIdx.x);
    if (i < N) atomicMin(k_lane + i, nn_key(best[p], best_j[p]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(arrivals + lane * gridDim.x + blockIdx.x, 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int p = 0; p < kPts; ++p) {
    const int i = static_cast<int>(blockIdx.x * kSrcPerBlock + p * kNnThreads + threadIdx.x);
    if (i < N) {
      const unsigned long long key = __ldcg(k_lane + i);
      float v = __fadd_rn(ss[p], nn_key_score(key));
      v = v < 0.f ? 0.f : v;  // torch.clamp(min=0): NaN stays NaN
      out_dist[lane * N + i] = __fsqrt_rn(v);
      out_idx[lane * N + i] = static_cast<int>(key & 0xffffffffu);
    }
  }
}

}  // namespace

extern "C" {

// The whole nearest-neighbour function. src, dst: (n, N, 3) f32 clouds as
// the caller holds them; split_len destinations per search block; inv_n
// the f32 reciprocal of N. Scratch: rows (n, N) float4 (16-byte aligned),
// keys (n, N) u64, mu (n, 3) f32, arrivals (n, ceil(N / 1024)) u32.
// Writes out_dist (n, N) f32 and out_idx (n, N) int32 on `stream`.
// Returns cudaGetLastError() after the launches (0 on success).
int aae_batched_nn(const void* src, const void* dst, int n, int N, int split_len, float inv_n,
                   void* rows, void* keys, void* mu, void* arrivals, void* out_dist,
                   void* out_idx, void* stream) {
  if (n < 1 || n > 65535 || N < 1 || N > kMaxN || split_len < 1 || split_len > N ||
      reinterpret_cast<uintptr_t>(rows) % 16 || reinterpret_cast<uintptr_t>(keys) % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_splits = (N + split_len - 1) / split_len;
  const int src_blocks = (N + kSrcPerBlock - 1) / kSrcPerBlock;
  if (n_splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float4) * split_len;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nn_search_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 prep_grid(n, std::min(kPrepParts, (N + kNnThreads - 1) / kNnThreads));
  nn_prep_kernel<<<prep_grid, kNnThreads, 0, s>>>(
      static_cast<const float*>(dst), N, inv_n, src_blocks, static_cast<float*>(mu),
      static_cast<float4*>(rows), static_cast<unsigned long long*>(keys),
      static_cast<unsigned*>(arrivals));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(src_blocks, n_splits, n);
  nn_search_kernel<<<grid, kNnThreads, smem, s>>>(
      static_cast<const float*>(src), static_cast<const float4*>(rows),
      static_cast<const float*>(mu), N, split_len, static_cast<unsigned long long*>(keys),
      static_cast<unsigned*>(arrivals), static_cast<float*>(out_dist), static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
