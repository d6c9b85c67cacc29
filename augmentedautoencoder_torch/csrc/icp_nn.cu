// Batched 3-D nearest neighbour for Hopper (sm_90a): the ICP
// correspondence step.
//
// Replaces the Pallas TPU kernel augmentedautoencoder_tpu/ops/icp_nn.py
// batched_nn_pallas (all three of its variants: _nn_kernel with
// _scores_vpu or _scores_mxu, and _nn_kernel_sweep). For each lane l < n and
// each source point i < N it returns the smallest score over the lane's N
// destination points and the index of the first point that reaches it:
//
//   score(i, j) = ((sx_i * dx_j + sy_i * dy_j) + sz_i * dz_j) + |d_j|^2
//
// with s' = -2 s already folded into the source coordinates, i.e.
// |d|^2 - 2 s.d, the only j-dependent part of |s - d|^2. The wrapper
// (ops/icp_nn.py batched_nn_cuda) centres both clouds, forms s' and
// (dx, dy, dz, |d|^2), and adds |s|^2 and the square root afterwards, in
// PyTorch, exactly as the plain version batched_nn_torch does; every
// product and sum here is rounded on its own (__fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA), so the kernel returns the plain
// version's minimum bit for bit and, scanning j upward with a strict <, its
// argmin (ties to the lowest index, as torch.argmin and jnp.argmin).
//
// What bounds it on an H100: operations. At the serving shape (n <= 24,
// N = 3000) the lane's destination cloud is 48 KB and the whole input a
// few MB, while the scores are n * N^2 (216 M at n = 24) pairs of 3
// multiplies and 3 adds: ~20 us at the 67 TFLOP/s f32 peak against ~1 us
// to read the inputs. So the design keeps the scores out of memory and
// spends the kernel on the CUDA cores' f32 arithmetic: one source point per
// thread in registers; the destination cloud staged through shared memory
// in tiles of 1024 float4 (16 KB), read by every thread of the block as a
// broadcast; a running (min, argmin) in registers. No padding: the tail
// tile is bounds-checked. Blocks of 128 threads put ceil(N / 128) = 24
// blocks on each lane at N = 3000, so even a frame's few lanes spread over
// the 132 SMs.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;   // source points per block, one per thread
constexpr int kTile = 1024;     // destination points per shared-memory tile

__global__ void __launch_bounds__(kThreads)
nn_min_kernel(const float* __restrict__ src, const float4* __restrict__ dst, int N,
              float* __restrict__ out_min, int* __restrict__ out_idx) {
  __shared__ float4 tile[kTile];

  const int64_t lane = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < N;
  const float* s = src + (lane * N + (active ? i : 0)) * 3;
  const float sx = s[0], sy = s[1], sz = s[2];
  const float4* d = dst + lane * N;

  float best = INFINITY;
  int best_j = 0;
  for (int base = 0; base < N; base += kTile) {
    const int count = min(kTile, N - base);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < count; j += kThreads) tile[j] = d[base + j];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < count; ++j) {
      const float4 q = tile[j];
      const float score = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(sx, q.x), __fmul_rn(sy, q.y)), __fmul_rn(sz, q.z)), q.w);
      if (score < best) {
        best = score;
        best_j = base + j;
      }
    }
  }
  if (active) {
    out_min[lane * N + i] = best;
    out_idx[lane * N + i] = best_j;
  }
}

}  // namespace

extern "C" {

// src: (n, N, 3) f32, the centred source points times -2; dst: (n, N)
// float4 (x, y, z, |d|^2) of the centred destination points, 16-byte
// aligned. Writes out_min (n, N) f32 and out_idx (n, N) int32 on `stream`.
// Returns cudaGetLastError() after the launch (0 on success).
int aae_batched_nn_min(const void* src, const void* dst, int n, int N, void* out_min,
                       void* out_idx, void* stream) {
  if (n < 1 || n > 65535 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kThreads - 1) / kThreads, n);
  nn_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float4*>(dst), N,
      static_cast<float*>(out_min), static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
