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
// Top-1 is k = 1.
//
// What bounds it on an H100: the read of one codebook plane. At B = 8 a
// 92,232 x 128 plane is 47 MB in f32 (24 MB in bf16) against 2*B*D*N =
// 0.19 GFLOP, i.e. ~2 FLOP per byte, far below the card's FMA rate per
// byte of HBM bandwidth. So the design streams each row exactly once per
// chunk of 8 queries and keeps every intermediate on chip:
//   pass 1: each block walks a contiguous row range in 256-row tiles. The
//     block's 8 queries sit in shared memory (widened to f32); the tile is
//     staged through shared memory in 16-column slices with coalesced
//     loads, and each thread scores one row with f32 FMAs on the CUDA
//     cores (bf16 operands widened to f32; no tensor cores, no TF32, so an
//     f32 slab ranks in IEEE f32). Each warp then owns one query and keeps
//     a running sorted top-k in registers (lane j holds entry j). Only
//     candidates that beat the current k-th entry are inserted (ballot +
//     one shuffle-shift per insert), so after the first tiles almost every
//     row costs one compare. The block writes its (k,) list per query to
//     scratch the caller allocated.
//   pass 2: one warp per query merges the per-block lists the same way.
// Blocks run in no order, so nothing is carried between them: the second
// pass replaces the TPU grid's sequential carry of the running top-k.
// Plane offsets are computed in 64-bit (a 30-object f32 slab is 1.45 GB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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

const char* aae_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
